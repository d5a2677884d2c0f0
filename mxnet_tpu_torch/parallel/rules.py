"""Sharding rules: parameter path -> PartitionSpec, and the serving
engine's split kinds.

Counterpart of mxnet_tpu/parallel/rules.py: `ShardingRules` (ordered
regex -> spec, first match wins), `apply_sharding_rules` (sets each
matching parameter's `sharding`), `megatron_dense_rules`, `ep_rules`
and `fsdp_rules`, which a mesh TrainStep reads (parallel/step.py shards
the storage of each parameter whose spec splits a dimension).

The serving engine's tensor-parallel split keeps its own form: a rule
gives a split kind, because the port slices tensors itself
(parallel/tp.py):

  * "col": split on axis 0, the out axis (query/key/value and fc1
    weights and their biases: column-parallel);
  * "row": split on axis 1, the in axis (proj and fc2 weights:
    row-parallel; their biases stay whole and are added once, after the
    reduction);
  * "replicated": every shard holds the whole tensor (embeddings and
    the tied LM head, LayerNorms, row-parallel biases, anything
    unmatched).

First match wins, in the reference's order: embeddings replicated
first, then the column weights, the row weights, the column biases.
"""
from __future__ import annotations

import re

from ..base import MXNetError
from .mesh import PartitionSpec

__all__ = ["COL_WEIGHT_PATTERN", "ROW_WEIGHT_PATTERN", "COL_BIAS_PATTERN",
           "EMBED_PATTERN", "megatron_kind", "serving_tp_rules",
           "split_kind", "ShardingRules", "apply_sharding_rules",
           "megatron_dense_rules", "ep_rules", "fsdp_rules"]

COL_WEIGHT_PATTERN = (r"(query|key|value|qkv|attn_in|ffn?_?1|intermediate"
                      r"|fc1)\.weight$")
ROW_WEIGHT_PATTERN = (r"(proj|attn_out|out_proj|ffn?_?2|output|fc2)"
                      r"\.weight$")
COL_BIAS_PATTERN = (r"(query|key|value|qkv|attn_in|ffn?_?1|intermediate"
                    r"|fc1)\.bias$")
EMBED_PATTERN = r"embed\w*\.weight$"
_COL_WEIGHT_RE = re.compile(COL_WEIGHT_PATTERN)
_ROW_WEIGHT_RE = re.compile(ROW_WEIGHT_PATTERN)


def megatron_kind(name):
    """'col' / 'row' / None for a parameter path under the megatron dense
    split (first match wins, column first, as the rules)."""
    if _COL_WEIGHT_RE.search(name):
        return "col"
    if _ROW_WEIGHT_RE.search(name):
        return "row"
    return None


def serving_tp_rules():
    """The serving split as an ordered [(compiled regex, kind)] list."""
    return [(re.compile(EMBED_PATTERN), "replicated"),
            (_COL_WEIGHT_RE, "col"),
            (_ROW_WEIGHT_RE, "row"),
            (re.compile(COL_BIAS_PATTERN), "col")]


_RULES = serving_tp_rules()


def split_kind(name):
    """The split kind of parameter path `name` under serving_tp_rules:
    'col', 'row' or 'replicated'."""
    for pat, kind in _RULES:
        if pat.search(name):
            return kind
    return "replicated"


class ShardingRules:
    """Ordered (regex, PartitionSpec) list; first match wins."""

    def __init__(self, rules=None, default=None):
        self.rules = [(re.compile(p), spec) for p, spec in (rules or [])]
        self.default = default  # None = replicated

    def add(self, pattern, spec):
        self.rules.append((re.compile(pattern), spec))
        return self

    def spec_for(self, name, shape=None):
        for pat, spec in self.rules:
            if pat.search(name):
                return spec
        return self.default

    def __iter__(self):
        return iter(self.rules)


def apply_sharding_rules(net_or_params, rules):
    """Set `param.sharding` for every matching parameter of a Block or a
    dict of name -> Parameter; a spec longer than the parameter's rank
    raises. Returns the parameter dict."""
    params = net_or_params
    if hasattr(params, "collect_params"):
        params = params.collect_params()
    for name, p in params.items():
        spec = rules.spec_for(name, tuple(p.shape))
        if spec is None:
            continue
        if len(spec) > len(p.shape):
            raise MXNetError(f"sharding spec {spec} longer than rank of "
                             f"{name} {tuple(p.shape)}")
        p.sharding = spec
    return params


def megatron_dense_rules(tp_axis="tp", fsdp_axis=None):
    """Megatron-style specs for Dense-built transformer blocks (weights
    (out, in)): column-parallel QKV / FFN-in (out dim over tp), row-
    parallel proj / FFN-out (in dim over tp), column biases over tp,
    embeddings' vocab dim over tp; `fsdp_axis` shards the other dim."""
    col = PartitionSpec(tp_axis, fsdp_axis)
    row = PartitionSpec(fsdp_axis, tp_axis)
    rules = ShardingRules()
    rules.add(COL_WEIGHT_PATTERN, col)
    rules.add(ROW_WEIGHT_PATTERN, row)
    rules.add(COL_BIAS_PATTERN, PartitionSpec(tp_axis))
    rules.add(EMBED_PATTERN, PartitionSpec(tp_axis, fsdp_axis))
    return rules


def ep_rules(ep_axis="ep"):
    """Expert parallelism: MoEFFN's stacked expert weights (`expert_*`,
    leading dim = expert) shard dim 0 over `ep_axis`."""
    return ShardingRules().add(r"expert_\w+$", PartitionSpec(ep_axis))


class _FsdpRules(ShardingRules):
    def __init__(self, fsdp_axis, min_size):
        super().__init__()
        self._axis = fsdp_axis
        self._min = int(min_size)

    def spec_for(self, name, shape=None):
        spec = super().spec_for(name, shape)
        if spec is not None:
            return spec
        if not shape or any(d == 0 for d in shape):
            return None
        n = 1
        for d in shape:
            n *= d
        if n < self._min:
            return None
        big = max(range(len(shape)), key=lambda i: shape[i])
        parts = [None] * len(shape)
        parts[big] = self._axis
        return PartitionSpec(*parts)


def fsdp_rules(fsdp_axis="fsdp", min_size=1024):
    """ZeRO-3-style: every parameter of at least `min_size` elements
    shards its largest dim over `fsdp_axis` (explicit rules added to the
    result take precedence); smaller ones stay replicated."""
    return _FsdpRules(fsdp_axis, min_size)
