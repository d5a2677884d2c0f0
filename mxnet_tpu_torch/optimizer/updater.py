"""Updater: an optimizer and its per-index state store.

Counterpart of mxnet_tpu/optimizer/updater.py (`Updater`,
`get_updater`): creates a parameter's state on its first update and
(de)serialises the states (`get_states` / `set_states`: a pickle of
numpy arrays, the optimizer with it when asked). Loaded states move to
their weight's device at their first update.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

__all__ = ["Updater", "get_updater"]


def _nd(t):
    from ..ndarray.ndarray import NDArray
    return NDArray(t)


class Updater:
    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = _to_device(self.states[index],
                                            weight._data.device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        def conv(s):
            if hasattr(s, "_data"):
                t = s._data.detach()
                return ("nd", str(t.dtype).replace("torch.", ""),
                        t.float().cpu().numpy() if t.dtype ==
                        torch.bfloat16 else t.cpu().numpy())
            if isinstance(s, (tuple, list)):
                return ("tup", tuple(conv(x) for x in s))
            return ("raw", s)

        payload = {k: conv(v) for k, v in self.states.items()}
        if dump_optimizer:
            opt = self.optimizer
            saved, opt.param_dict = opt.param_dict, {}
            try:
                payload["__optimizer__"] = ("opt", pickle.dumps(opt))
            finally:
                opt.param_dict = saved
        buf = io.BytesIO()
        pickle.dump(payload, buf)
        return buf.getvalue()

    def set_states(self, states):
        from ..ndarray.ndarray import to_torch_dtype
        payload = pickle.loads(states)
        opt = payload.pop("__optimizer__", None)
        if opt is not None:
            self.optimizer = pickle.loads(opt[1])

        def unconv(s):
            if s[0] == "nd":
                return _nd(torch.from_numpy(np.array(s[2])).to(
                    to_torch_dtype(s[1])))
            if s[0] == "tup":
                return tuple(unconv(x) for x in s[1])
            return s[1]

        self.states = {k: unconv(v) for k, v in payload.items()}
        self.states_synced = {k: False for k in self.states}


def _to_device(s, device):
    if hasattr(s, "_data"):
        return _nd(s._data.to(device))
    if isinstance(s, tuple):
        return tuple(_to_device(x, device) for x in s)
    return s


def get_updater(optimizer):
    return Updater(optimizer)
