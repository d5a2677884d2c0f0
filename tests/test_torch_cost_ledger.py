"""The port's device-cost accounting and HBM ledger.

telemetry/cost.py: the GPT-2 dispatch formula equals a hand count (one
request's prefill chunk and decodes on a tiny model, and a mixed grid),
the serving engine's model and wasted FLOPs counters add up to it,
cost_mfu lands in (0, 1], set_enabled(False) makes the dispatch
accounting a no-op, kernel library builds and loads count as compiles
of `kernels/<library>`, one after mark_warm() latches a flight dump,
and the peaks follow the device name (H100 SXM: 989 TFLOP/s bfloat16,
67 TFLOP/s float32, 3.35 TB/s).

telemetry/ledger.py: the engine's /memz rows carry the JAX engine's
component names (plain, int8 pages with the prefix cache and the host
tier, LoRA adapters, w8 weights), their bytes equal the sums of the
port's tensor sizes, and two engines over one model count its weights
once.
"""
import ctypes
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving as jax_serving  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
import mxnet_tpu_torch.serving as port_serving  # noqa: E402
from mxnet_tpu_torch import telemetry  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.ops import _build  # noqa: E402
from mxnet_tpu_torch.telemetry import cost, ledger, memory  # noqa: E402

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, max_length=64, page_size=8)


@pytest.fixture(scope="module")
def nets():
    gc.collect()
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}

    def port_net():
        return load_jax_params(
            GPT2ForCausalLM(GPT2Config(**KW), device="cpu"), arrays)
    keep = []
    yield jnet, port_net, keep
    keep.clear()
    gc.collect()


# ---------------------------------------------------------------------------
# the model formula
# ---------------------------------------------------------------------------

U, L, V, F = 32, 2, 97, 128
# per query row: q, k, v (2·U·3U) + out proj (2·U·U) per layer, MLP
# (2·U·F up + 2·F·U down) per layer, tied LM head 2·U·V
PER_ROW = L * (2 * U * 3 * U + 2 * U * U + 2 * U * F + 2 * F * U) \
    + 2 * U * V
PER_KEY = L * (2 * U + 2 * U)          # q·k and p·v over every head


def test_dispatch_formula_equals_a_hand_count():
    cfg = GPT2Config(**KW)
    assert PER_ROW == 55360 and PER_KEY == 256
    # slot 0: an 8-token chunk at offset 16 (keys 17..24); slot 1: a
    # verify row of 3 at length 5 (keys 6, 7, 8); slot 2 idle
    c = cost.gpt2_dispatch_cost(cfg, [8, 3, 0], [16, 5, 40], width=8,
                                weight_bytes=1000, kv_itemsize=4,
                                logits_itemsize=4)
    keys = sum(range(17, 25)) + 6 + 7 + 8
    assert c["rows"] == 11 and c["grid_rows"] == 24
    assert c["flops"] == 11 * PER_ROW + keys * PER_KEY
    assert c["grid_flops"] == 24 * PER_ROW + keys * PER_KEY
    kv_pos = L * 2 * U * 4               # k and v, every layer, float32
    assert c["bytes"] == 1000 + kv_pos * ((24 + 8) + 11) + 24 * V * 4


def test_engine_counts_model_and_wasted_flops_by_hand(nets):
    _, port_net, _ = nets
    eng = port_serving.ServingEngine(port_net(), device="cpu", num_slots=1,
                                     max_length=64, page_size=8)
    eng.serve([port_serving.Request([5, 6, 7, 8], 3)])
    # a 4-token prefill at length 0 (keys 1..4), decodes at lengths 4
    # and 5; each dispatch runs the whole (1, 8) grid through the dense
    # layers
    rows, keys = 4 + 1 + 1, (1 + 2 + 3 + 4) + 5 + 6
    s = eng.stats
    assert s["decode_dispatches"] == 3
    assert s["model_flops"] == rows * PER_ROW + keys * PER_KEY
    assert s["wasted_flops"] == (3 * 8 - rows) * PER_ROW
    rec = cost.get(eng._cost_program)
    assert rec["dispatches"] == 3 and rec["dtype"] == "float32"
    assert rec["flops"] == 1 * PER_ROW + 6 * PER_KEY     # the last one
    assert 0.0 < rec["mfu"] <= 1.0
    assert telemetry.get("cost_mfu").labels(eng._cost_program).value \
        == pytest.approx(rec["mfu"])


def test_disabled_cost_accounting_is_a_no_op(nets):
    _, port_net, _ = nets
    eng = port_serving.ServingEngine(port_net(), device="cpu", **ENGINE)
    cost.set_enabled(False)
    try:
        eng.generate([[1, 2, 3], [4, 5]], 3)
    finally:
        cost.set_enabled(True)
    assert eng.stats["model_flops"] == 0
    assert cost.get(eng._cost_program)["dispatches"] == 0
    eng.generate([[1, 2, 3]], 2)
    assert cost.get(eng._cost_program)["dispatches"] == 2


def test_kernel_builds_and_loads_count_as_compiles(nets, monkeypatch,
                                                   tmp_path):
    _, port_net, _ = nets
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_all", lambda names=None: {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
    before = (cost.get("kernels/ragged_attention") or {}).get("compiles", 0)
    _build.load("ragged_attention")
    _build.load("ragged_attention")                 # loaded once
    rec = cost.get("kernels/ragged_attention")
    assert rec["compiles"] == before + 1 and rec["steady_compiles"] == 0
    fr = telemetry.flight.install(out_dir=str(tmp_path), stall_timeout=60.0)
    try:
        eng = port_serving.ServingEngine(port_net(), device="cpu", **ENGINE)
        eng.mark_warm()
        assert cost.steady_state()
        _build.load("fused_attention")              # after warmup
        assert len(fr.dumps) == 1
        assert "retrace_storm-kernels-fused_attention" in fr.dumps[0]
        assert cost.get("kernels/fused_attention")["steady_compiles"] == 1
        assert cost.report()["steady_compiles"] >= 1
        probes = len(cost._steady_probes)
        del eng
        gc.collect()
        cost.steady_state()                         # drops dead probes
        assert len(cost._steady_probes) <= probes - 1
    finally:
        telemetry.flight.uninstall()


def test_a_failed_build_is_no_compile(monkeypatch, tmp_path):
    """A compiler that fails raises KernelError and records nothing."""
    import shutil
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    before = (cost.get("kernels/ragged_attention") or {}).get("compiles", 0)
    with pytest.raises(_build.KernelError, match="nvcc failed"):
        _build.build_all(["ragged_attention"])
    after = (cost.get("kernels/ragged_attention") or {}).get("compiles", 0)
    assert after == before


def test_peaks_follow_the_device_name(monkeypatch):
    class FakeCuda:
        @staticmethod
        def get_device_name(i):
            return "NVIDIA H100 80GB HBM3"

    class FakeTorch:
        cuda = FakeCuda

    monkeypatch.setattr(cost, "_device_peaks", None)
    monkeypatch.setattr(memory, "cuda_live", lambda: FakeTorch)
    assert cost.peaks("bfloat16") == (989e12, 3.35e12,
                                      "NVIDIA H100 80GB HBM3")
    assert cost.peaks("float32")[0] == 67e12
    monkeypatch.setenv("MXNET_TPU_PEAK_FLOPS", "5e14")
    assert cost.peaks("float32")[0] == 5e14
    monkeypatch.delenv("MXNET_TPU_PEAK_FLOPS")
    assert cost.report()["unknown_device"] is False
    monkeypatch.setattr(cost, "_device_peaks", None)
    monkeypatch.setattr(memory, "cuda_live", lambda: None)
    assert cost.peaks("float32")[2] == "cpu"
    cost.peaks()                  # republish the nominal gauges


def test_an_unnamed_card_publishes_no_peaks(monkeypatch):
    """A CUDA card the peak table does not name gets no peak, so no MFU,
    bandwidth share or roofline class, never the CPU's nominal ones."""
    class FakeCuda:
        @staticmethod
        def get_device_name(i):
            return "NVIDIA H100 PCIe"

    class FakeTorch:
        cuda = FakeCuda

    monkeypatch.setattr(cost, "_device_peaks", None)
    monkeypatch.setattr(memory, "cuda_live", lambda: FakeTorch)
    try:
        assert cost.peaks("bfloat16") == (None, None, "NVIDIA H100 PCIe")
        cost.register_program("test/unnamed", flops=1e12, bytes_accessed=1e6,
                              dtype="float32")
        rec = cost.note_dispatch("test/unnamed", 0.5)
        assert rec.flops == 1e12
        rep = cost.report()
        snap = rep["programs"]["test/unnamed"]
        assert rep["unknown_device"] is True
        assert (rep["peak_flops"], rep["peak_bandwidth_bytes_per_sec"],
                rep["ridge_intensity"]) == (None, None, None)
        assert snap["arithmetic_intensity"] == 1e6
        assert not {"mfu", "bandwidth_util", "bound"} & set(snap)
        monkeypatch.setenv("MXNET_TPU_PEAK_FLOPS", "5e14")
        monkeypatch.setenv("MXNET_TPU_PEAK_BANDWIDTH", "2e12")
        rep = cost.report()
        assert rep["unknown_device"] is False
        assert rep["programs"]["test/unnamed"]["mfu"] == 1e12 / 0.5 / 5e14
    finally:
        monkeypatch.setattr(cost, "_device_peaks", None)
        monkeypatch.setattr(memory, "cuda_live", lambda: None)
        monkeypatch.delenv("MXNET_TPU_PEAK_FLOPS", raising=False)
        monkeypatch.delenv("MXNET_TPU_PEAK_BANDWIDTH", raising=False)
        cost.peaks()              # republish the nominal gauges


def test_register_program_classifies_the_roofline():
    cost.register_program("test/compute", flops=1e12, bytes_accessed=1e6,
                          dtype="float32")
    cost.register_program("test/memory", flops=1e6, bytes_accessed=1e9,
                          dtype="float32")
    progs = cost.report()["programs"]
    assert progs["test/compute"]["bound"] == "compute"
    assert progs["test/memory"]["bound"] == "memory"
    assert cost.note_dispatch("test/memory", 0.5, flops=2e6).flops == 2e6


# ---------------------------------------------------------------------------
# the HBM ledger
# ---------------------------------------------------------------------------

def _sizes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _configs(mod, cfg):
    out = {"plain": {},
           "int8_prefix_tier": dict(kv_dtype="int8", prefix_cache=True,
                                    host_kv_bytes=1 << 20)}
    if mod is port_serving:
        pool = mod.AdapterPool(cfg, slots=3, max_rank=4, device="cpu")
    else:
        pool = mod.AdapterPool(cfg, slots=3, max_rank=4)
    pool.register("a", mod.random_lora(cfg, rank=2))
    out["adapters"] = dict(adapter_pool=pool)
    out["w8"] = dict(weight_dtype="int8")
    return out


@pytest.mark.parametrize("config", ["plain", "int8_prefix_tier", "adapters",
                                    "w8"])
def test_memz_components_match_jax_and_bytes_equal_tensor_sizes(nets,
                                                                config):
    jnet, port_net, keep = nets
    jcfg = JaxConfig(**KW)
    jkw = _configs(jax_serving, jcfg)[config]
    if config == "w8":
        jnet = JaxGPT2(jcfg)
        mx.rng.seed(3)
        jnet.initialize(mx.init.Normal(0.05))
    gc.collect()
    jeng = jax_serving.ServingEngine(jnet, attn_impl="xla",
                                     **dict(ENGINE, **jkw))
    keep.append(jeng)
    pkw = _configs(port_serving, GPT2Config(**KW))[config]
    eng = port_serving.ServingEngine(port_net(), device="cpu",
                                     **dict(ENGINE, **pkw))
    for e in (jeng, eng):
        e.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9], [3, 4]], 3)
    want = jeng._hbm_ledger()
    got = eng._hbm_ledger()
    assert set(got) == set(want)
    snap = ledger.snapshot()
    rows = snap["components"][f"engine/{eng._eid}"]
    assert set(rows) == set(want)
    weights = list(eng.model.parameters()) + list(eng.model.buffers())
    assert rows["weights"]["bytes"] == _sizes(weights) \
        == sum(eng.weight_bytes.values())
    kv = [eng._kp, eng._vp] + ([eng._ks, eng._vs] if eng._quant else [])
    assert rows["kv_pages"]["bytes"] == _sizes(kv)
    assert rows["slot_state"]["bytes"] == _sizes(
        list(eng._dstate.values()) + [eng._d_lock])
    assert rows["weight_grads"]["bytes"] == 0
    if config == "adapters":
        pool = eng.adapter_pool
        assert rows["adapter_slab"]["bytes"] \
            == _sizes([pool.A, pool.B, pool.scale]) == pool.slab_bytes()
    if config == "int8_prefix_tier":
        assert rows["prefix_cache_pages"]["detail"] is True
        assert rows["host_kv"] == {"bytes": eng.host_pool.bytes_used,
                                   "detail": True}
    if config == "w8":
        assert rows["weights_fp32_shadow"] == {"bytes": 0, "detail": True}
        assert eng.weight_bytes["int8"] > 0
    assert snap["live_array_bytes"] is None       # no CUDA here


def test_ledger_counts_a_shared_model_once(nets):
    _, port_net, _ = nets
    net = port_net()
    a = port_serving.ServingEngine(net, device="cpu", **ENGINE)
    b = port_serving.ServingEngine(net, device="cpu", **ENGINE)
    comps = ledger.snapshot()["components"]
    ra, rb = comps[f"engine/{a._eid}"], comps[f"engine/{b._eid}"]
    # providers are walked in name order: the first engine counts them
    first, second = sorted([(a._eid, ra), (b._eid, rb)],
                           key=lambda x: f"engine/{x[0]}")
    assert first[1]["weights"]["bytes"] == sum(a.weight_bytes.values())
    assert second[1]["weights"]["bytes"] == 0
    assert second[1]["kv_pages"]["bytes"] == first[1]["kv_pages"]["bytes"]
    # a view of a counted slab counts nothing more
    ledger.register("test/view", lambda: {"v": [a._kp[:, :2], a._kp]})
    try:
        rows = ledger.snapshot()["components"]["test/view"]
        assert rows["v"]["bytes"] == 0
    finally:
        ledger.unregister("test/view")
    np.testing.assert_equal(
        ledger.snapshot()["accounted_bytes"] >= first[1]["weights"]["bytes"],
        True)
