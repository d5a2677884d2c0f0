"""Mixture-of-Experts FFN layer (expert-parallel over the "ep" axis).

Counterpart of mxnet_tpu/gluon/nn/moe.py `MoEFFN`: a gate Dense (no
bias) plus expert weights stacked along a leading expert axis
(`expert_w1` (E, C, H), `expert_b1` (E, H), `expert_w2` (E, H, C),
`expert_b2` (E, C); the biases start at zeros), so `ep_rules()` shards
dim 0 over "ep". The math is parallel/moe.py `moe_dispatch_combine`.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from ..parameter import Parameter
from ._common import gluon_mode
from .basic_layers import Dense

__all__ = ["MoEFFN"]

_ACTIVATIONS = ("gelu", "relu", "silu", "gelu_tanh")


class MoEFFN(HybridBlock):
    """(B, T, C) -> (B, T, C) through num_experts expert FFNs with top-k
    routing; forward(x, return_aux=True) returns (y, aux_loss), which
    training code adds into its objective with a weight (the Switch
    recipe)."""

    _forward_kind = "tensor"

    def __init__(self, units, hidden_size, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu", **kwargs):
        super().__init__()
        if top_k > num_experts:
            raise MXNetError(f"top_k {top_k} > num_experts {num_experts}")
        if activation not in _ACTIVATIONS:
            raise MXNetError(f"unsupported MoE activation {activation!r}")
        self._units = units
        self._hidden = hidden_size
        self._E = num_experts
        self._top_k = top_k
        self._cf = capacity_factor
        self._activation = activation
        self.gate = Dense(num_experts, flatten=False, use_bias=False,
                          in_units=units)
        self.expert_w1 = Parameter("expert_w1",
                                   shape=(num_experts, units, hidden_size))
        self.expert_b1 = Parameter("expert_b1",
                                   shape=(num_experts, hidden_size),
                                   init="zeros")
        self.expert_w2 = Parameter("expert_w2",
                                   shape=(num_experts, hidden_size, units))
        self.expert_b2 = Parameter("expert_b2", shape=(num_experts, units),
                                   init="zeros")
        gluon_mode(self)

    def forward(self, x, return_aux=False):
        from ...parallel.moe import moe_dispatch_combine
        b, t, c = x.shape
        logits = self.gate(x)
        w = self._parameters
        y, aux = moe_dispatch_combine(
            x.reshape(b * t, c), logits.reshape(b * t, self._E),
            w["expert_w1"], w["expert_b1"], w["expert_w2"],
            w["expert_b2"], top_k=self._top_k, capacity_factor=self._cf,
            activation=self._activation)
        y = y.reshape(b, t, c)
        return (y, aux) if return_aux else y
