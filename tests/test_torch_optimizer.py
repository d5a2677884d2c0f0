"""The port's optimizers and learning-rate schedulers against the JAX
package.

* Every registered optimizer name (13), and the centered RMSProp and
  AdamW's correct_bias=False: five eager updates through an Updater from
  the same float32 weights and gradients (rescale_grad and a clip where
  the optimizer takes them, per-parameter lr_mult / wd_mult through a
  param_dict), weights and states within 1e-6 relative to their largest
  magnitude after every update. SGLD is held by its deterministic part:
  the noise the reference drew is handed to the port's update.
* multi_precision=True on bfloat16 weights: the bfloat16 weights within
  one bfloat16 ulp of the reference's after every update (SGLD left out:
  its noise cannot be handed across under the float32 master).
* LAMB's functional `apply_arrays` (parallel.TrainStep's interface)
  equals its eager `update()` within 1e-6.
* Schedulers: the learning rate at t = 0..50 equals the reference's as
  Python floats, warmup included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import lr_scheduler as jsched  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import lr_scheduler as psched  # noqa: E402
from mxnet_tpu_torch import optimizer as popt  # noqa: E402

CPU = mx.cpu()
REL = 1e-6
STEPS = 5
BASE = dict(wd=0.01, rescale_grad=0.5)
CASES = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, clip_gradient=0.8),
    "nag": dict(learning_rate=0.1, momentum=0.9),
    "adam": dict(learning_rate=0.01, clip_gradient=0.8),
    "adamw": dict(learning_rate=0.01),
    "adagrad": dict(learning_rate=0.1),
    "adadelta": dict(rho=0.9),
    "rmsprop": dict(learning_rate=0.01),
    "ftrl": dict(learning_rate=0.1, lamda1=0.01),
    "signum": dict(learning_rate=0.01, momentum=0.9, wd_lh=0.01),
    "lars": dict(learning_rate=0.1, momentum=0.9),
    "lamb": dict(learning_rate=0.01),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9),
    "sgld": dict(learning_rate=0.01),
}
VARIANTS = dict(CASES, **{
    "rmsprop_centered": dict(learning_rate=0.01, centered=True),
    "adamw_no_correct_bias": dict(learning_rate=0.01, correct_bias=False),
    "sgd_plain": dict(learning_rate=0.1),
})
SHAPES = [(4, 5), (6,)]


class _Mult:
    """A param_dict entry: the per-parameter multipliers."""

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


def _data(seed=0):
    r = np.random.default_rng(seed)
    ws = [r.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[r.standard_normal(s).astype(np.float32) * 2 for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _nd(pkg, a, dtype=None):
    if pkg == "port":
        return mx.nd.array(a, ctx=CPU, dtype=dtype or a.dtype)
    return jmx.nd.array(a, dtype=dtype or a.dtype)


def _opt(pkg, name, **extra):
    base = name.split("_")[0]
    kw = dict(BASE, **VARIANTS[name], **extra)
    kw["param_dict"] = {0: _Mult(1.0, 1.0), 1: _Mult(0.5, 2.0)}
    return (popt if pkg == "port" else jopt).create(base, **kw)


def _states(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for e in s for x in _states(e)]
    return [s.asnumpy().astype(np.float32)]


def _close(got, want, label):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= REL * scale, (label, err, scale)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_eager_updates_match_reference(name):
    ws, gs = _data()
    runs = {}
    for pkg in ("port", "jax"):
        opt = _opt(pkg, name)
        upd = (popt if pkg == "port" else jopt).get_updater(opt)
        weights = [_nd(pkg, w) for w in ws]
        runs[pkg] = (opt, upd, weights)
    for t in range(STEPS):
        for i in range(len(ws)):
            jopt_, jupd, jw = runs["jax"]
            before = jw[i].asnumpy()
            jupd(i, _nd("jax", gs[t][i]), jw[i])
            popt_, pupd, pw = runs["port"]
            if name == "sgld":
                # the reference's noise, handed to the port
                lr = jopt_._get_lr(i)
                wd = jopt_._get_wd(i)
                g = np.clip(gs[t][i] * BASE["rescale_grad"], -1e30, 1e30)
                det = (before - np.float32(lr / 2) * (g + np.float32(wd)
                                                      * before))
                noise = jw[i].asnumpy() - det
                popt_._noise = lambda w, lr, _n=noise: torch.from_numpy(_n)
            pupd(i, _nd("port", gs[t][i]), pw[i])
            _close(pw[i].asnumpy(), jw[i].asnumpy(), f"{name} w{i} t{t}")
            for a, b in zip(_states(pupd.states[i]), _states(jupd.states[i])):
                _close(a, b, f"{name} state{i} t{t}")
    assert runs["port"][0].num_update == runs["jax"][0].num_update


def _bf16_ulp(x):
    x = np.abs(x.astype(np.float32))
    e = np.floor(np.log2(np.maximum(x, 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("name", sorted(n for n in CASES if n != "sgld"))
def test_multi_precision_bfloat16_within_one_ulp(name):
    ws, gs = _data(1)
    runs = {}
    for pkg in ("port", "jax"):
        opt = _opt(pkg, name, multi_precision=True)
        upd = (popt if pkg == "port" else jopt).get_updater(opt)
        runs[pkg] = (upd, [_nd(pkg, w, "bfloat16") for w in ws])
    for t in range(STEPS):
        for i in range(len(ws)):
            for pkg in ("port", "jax"):
                upd, w = runs[pkg]
                upd(i, _nd(pkg, gs[t][i], "bfloat16"), w[i])
            got = runs["port"][1][i].asnumpy().astype(np.float32)
            want = np.asarray(runs["jax"][1][i].asnumpy(), np.float32)
            assert runs["port"][1][i].dtype == torch.bfloat16
            assert (np.abs(got - want) <= _bf16_ulp(want)).all(), (name, t)
            master = runs["port"][0].states[i][0]
            assert master.dtype == np.float32


def test_lamb_apply_arrays_equals_update():
    ws, gs = _data(2)
    opt_e = popt.LAMB(learning_rate=0.01, wd=0.01)
    opt_f = popt.LAMB(learning_rate=0.01, wd=0.01)
    upd = popt.get_updater(opt_e)
    w_e = mx.nd.array(ws[0], ctx=CPU)
    w_f = torch.from_numpy(ws[0].copy())
    states = opt_f.init_state_arrays(w_f)
    for t in range(STEPS):
        upd(0, mx.nd.array(gs[t][0], ctx=CPU), w_e)
        opt_f.apply_arrays(w_f, torch.from_numpy(gs[t][0]), states, 0.01,
                           0.01, t + 1)
        _close(w_f.numpy(), w_e.asnumpy(), f"lamb t{t}")
    assert popt.LAMB.fused_supported


def test_registry_and_create():
    names = sorted(popt.optimizer._REG.keys())
    assert names == sorted(CASES) and len(names) == 13
    assert set(names) <= set(jopt.optimizer._REG.keys())
    with pytest.raises(mx.MXNetError):
        popt.create("nosuch")
    sched = psched.PolyScheduler(10, base_lr=1.0)
    opt = popt.create("sgd", learning_rate=0.5, lr_scheduler=sched)
    assert sched.base_lr == 0.5 and opt.learning_rate == sched(0)
    with pytest.raises(mx.MXNetError):
        opt.learning_rate = 0.1


SCHEDULERS = [
    ("FactorScheduler", dict(step=5, factor=0.5, base_lr=1.0,
                             warmup_steps=3, warmup_begin_lr=0.1)),
    ("FactorScheduler", dict(step=3, factor=0.9, stop_factor_lr=0.5)),
    ("MultiFactorScheduler", dict(step=[10, 20, 30], factor=0.3,
                                  warmup_steps=4, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=40, base_lr=2.0, pwr=2, final_lr=0.1,
                           warmup_steps=5)),
    ("PolyScheduler", dict(max_update=30, base_lr=1e-4, pwr=1,
                           warmup_steps=10, warmup_begin_lr=1e-6)),
    ("CosineScheduler", dict(max_update=45, base_lr=1.0, final_lr=0.01,
                             warmup_steps=6)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS)
def test_scheduler_matches_reference(name, kw):
    got = [getattr(psched, name)(**kw)(t) for t in range(51)]
    want = [getattr(jsched, name)(**kw)(t) for t in range(51)]
    assert got == want
    assert [type(x) for x in got] == [type(x) for x in want]
