"""The port's tensor-parallel serving against its own tp=1 engine and the
JAX package's tp engine.

On the reference's tp net (tests/test_tp_serving.py `_tiny`: 4 heads,
32 units, 2 layers, seeded JAX weights carried across), the port runs
`ServingEngine(..., tp=N, tp_devices=["cpu"] * N)`: N shard modules
over N shard pools on one device, the counterpart of the reference's
forced virtual CPU mesh. Held here:

  * the constructor's checks (tp >= 1, tp divides num_heads, enough
    devices);
  * greedy streams at tp=2 and tp=4 equal tp=1 in every serving mode
    (plain, int8 pages, the prefix cache with its copy-on-write split,
    speculative verify, float and int8 LoRA slabs, w8 weights), with
    clean page audits;
  * tp=2 streams equal the JAX tp=2 engine's (float and int8 pages),
    under the divergence rule (a difference is allowed only where the
    JAX path's top-2 logit gap is below 1e-4);
  * int8 layer-0 codes and scales, concatenated over shards, are the
    same bytes at tp=1 and tp=2 (layer 0 reads the replicated
    embeddings; deeper layers carry the reductions' reassociation noise
    and are held to tolerance), and the codes the JAX tp=2 engine's
    bytes (its scales differ from the port's in the last bits at any
    tp, as the two packages' float32 products do);
  * w8 shard codes and scales are slices of the reference's
    quantize_weight(..., tp=2);
  * the per-chip HBM budget, the /statusz sharding block, per-chip cost
    gauges, handoff payloads in the global head layout, the router's
    tp=2 -> tp=4 migration, the steady-state compile count, the
    lockstep forward's logits and the fleet spec's tp.

JAX engines are built once per module, after gc.collect().
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.models import PagedKVCache as JaxCache  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from mxnet_tpu.serving.weight_quant import \
    quantize_weight as jax_quantize  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    PagedKVCache, load_jax_params)
from mxnet_tpu_torch.models.gpt2 import tp_forward  # noqa: E402
from mxnet_tpu_torch.parallel.mesh import serving_tp_devices  # noqa: E402
from mxnet_tpu_torch.parallel.rules import split_kind  # noqa: E402
from mxnet_tpu_torch.parallel.tp import TPGroup, shard_gpt2  # noqa: E402
from mxnet_tpu_torch.serving import (AdapterPool, ReplicaFaultPlan,  # noqa: E402
                                     Request, ServingEngine, ServingRouter,
                                     random_lora)
from mxnet_tpu_torch.serving.fleet import wire  # noqa: E402
from mxnet_tpu_torch.serving.fleet.worker import build_engine  # noqa: E402
from mxnet_tpu_torch.telemetry import cost as _cost  # noqa: E402

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=4, max_length=64, page_size=8)
INT8 = dict(kv_dtype="int8")


def _cpus(tp):
    return ["cpu"] * tp if tp > 1 else None


@pytest.fixture(scope="module")
def world():
    gc.collect()
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}

    def port_net():
        return load_jax_params(
            GPT2ForCausalLM(GPT2Config(**KW), device="cpu"), arrays)
    net = port_net()
    jax_engines = {}

    def jax_engine(key, **kw):
        # one JAX engine per configuration for the module's life
        if key not in jax_engines:
            gc.collect()
            jax_engines[key] = JaxEngine(jnet, attn_impl="xla",
                                         **dict(ENGINE, **kw))
        return jax_engines[key]
    yield dict(jnet=jnet, net=net, port_net=port_net, jax_engine=jax_engine)
    jax_engines.clear()
    gc.collect()


def _prompts(n=4, seed=7, lo=3, hi=18):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _serve(net, prompts, tp, max_new=8, adapter_ids=None, **kw):
    eng = ServingEngine(net, device="cpu", tp=tp, tp_devices=_cpus(tp),
                        **dict(ENGINE, **kw))
    aid = adapter_ids or [None] * len(prompts)
    reqs = [Request(p, max_new, request_id=i, seed=100 + i,
                    adapter_id=aid[i])
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    assert eng.audit_pages() == []
    return [list(r.output_tokens) for r in reqs], eng


# ---------------------------------------------------------------------------
# the constructor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(tp=-1), "tp must be >= 1"),
    (dict(tp=3, tp_devices=["cpu"] * 3), "divide num_heads"),
    (dict(tp=4, tp_devices=["cpu"] * 2), "needs 4 devices, have 2"),
    (dict(tp=2, tp_devices=None), "needs 2 devices, have"),
])
def test_tp_constructor_validation(world, kw, match):
    if kw.get("tp_devices", 0) is None and torch.cuda.device_count() >= 2:
        pytest.skip("the default device list has two cards here")
    with pytest.raises(MXNetError, match=match):
        ServingEngine(world["net"], device="cpu", **dict(ENGINE, **kw))


def test_tp_device_list_contract():
    assert serving_tp_devices(1, ["cpu"]) is None
    got = serving_tp_devices(2, ["cpu", torch.device("cpu"), "cpu"])
    assert got == [torch.device("cpu")] * 2
    assert split_kind("backbone.word_embed.weight") == "replicated"
    assert split_kind("backbone.layer0.attn.query.weight") == "col"
    assert split_kind("backbone.layer0.attn.query.bias") == "col"
    assert split_kind("backbone.layer0.attn.proj.weight") == "row"
    assert split_kind("backbone.layer0.attn.proj.bias") == "replicated"
    assert split_kind("backbone.layer0.fc2.weight") == "row"
    assert split_kind("backbone.layer0.ln1.gamma") == "replicated"


# ---------------------------------------------------------------------------
# greedy streams equal tp=1 in every serving mode
# ---------------------------------------------------------------------------

def _pool(cfg, dtype):
    # scale 0.3: at the reference's 0.02 the adapter moves no greedy
    # token of this net, and the comparison could not see a wrong delta
    p = AdapterPool(cfg, slots=3, max_rank=2, dtype=dtype, device="cpu")
    p.register("a", random_lora(cfg, rank=2, seed=41, scale=0.3))
    return p


def _run_mode(world, mode, tp):
    net, prompts = world["net"], _prompts()
    if mode == "plain":
        return _serve(net, prompts, tp)
    if mode == "int8":
        return _serve(net, prompts, tp, **INT8)
    if mode == "speculative":
        rep = [p[:4] * 4 for p in prompts]      # something to draft from
        return _serve(net, rep, tp, max_new=12, speculative=True,
                      spec_tokens=4)
    if mode in ("lora_float", "lora_int8"):
        aid = ["a" if i % 2 else None for i in range(len(prompts))]
        pool = _pool(net.config, None if mode == "lora_float" else "int8")
        return _serve(net, prompts, tp, adapter_pool=pool, adapter_ids=aid)
    if mode == "w8":
        # w8 quantizes its model in place: a fresh copy per engine
        return _serve(world["port_net"](), prompts, tp, weight_dtype="int8")
    if mode == "prefix":
        # sequential, so each prompt's pages are in the tree before the
        # next attaches; the last prompt is fully cached (the CoW split)
        shared = np.random.default_rng(11).integers(1, 97, 16).tolist()
        eng = ServingEngine(net, device="cpu", tp=tp, tp_devices=_cpus(tp),
                            prefix_cache=True, **ENGINE)
        out = []
        for i, p in enumerate([shared + [5], shared + [9], shared]):
            r = Request(p, 8, request_id=i, seed=100 + i)
            eng.serve([r])
            out.append(list(r.output_tokens))
        assert eng.audit_pages() == []
        assert eng.stats["prefix_tokens_saved"] > 0
        return out, eng
    raise AssertionError(mode)


_TP1 = {}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["plain", "int8", "prefix", "speculative",
                                  "lora_float", "lora_int8", "w8"])
def test_tp_greedy_streams_equal_tp1(world, mode, tp):
    if mode not in _TP1:
        _TP1[mode] = _run_mode(world, mode, 1)
    want, e1 = _TP1[mode]
    got, eng = _run_mode(world, mode, tp)
    assert got == want, (mode, tp)
    assert eng.stats["tp_shards"] == tp
    assert len(eng._pools) == tp
    assert eng._kp.shape[3] == KW["num_heads"] // tp
    for key in ("prefix_tokens_saved", "spec_accepted_tokens",
                "spec_draft_tokens", "tokens_emitted"):
        assert eng.stats[key] == e1.stats[key], key
    if mode == "speculative":
        assert eng.stats["spec_accepted_tokens"] > 0
    if mode == "w8":
        assert eng.weight_dtype == "int8"
    if mode.startswith("lora"):
        # the adapter rows (odd requests) take other tokens than plain
        if "plain" not in _TP1:
            _TP1["plain"] = _run_mode(world, "plain", 1)
        plain = _TP1["plain"][0]
        assert any(want[i] != plain[i] for i in (1, 3))
        assert all(want[i] == plain[i] for i in (0, 2))


# ---------------------------------------------------------------------------
# against the JAX tp=2 engine
# ---------------------------------------------------------------------------

def _jax_gap(jnet, prompt, emitted, history, kv_dtype):
    """The JAX path's top-2 logit gap after `prompt + emitted`, replaying
    the request's writes alone: the prompt in its chunks, then one row
    per emitted token (unsharded: the gap is what the rule reads)."""
    L, H = KW["num_layers"], KW["num_heads"]
    cache = JaxCache.create(L, 1, H, KW["max_length"], KW["units"] // H,
                            page_size=ENGINE["page_size"],
                            lengths=np.zeros(1), kv_dtype=kv_dtype,
                            attn_impl="xla")
    cuts = np.cumsum([0] + list(history or [len(prompt)]))
    feeds = [prompt[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    feeds += [[t] for t in emitted]
    for toks in feeds:
        logits, cache = jnet(mx.nd.array(np.int32([toks]), dtype="int32"),
                             cache)
    top = np.sort(logits.asnumpy()[0, -1])[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_tp2_streams_equal_jax_tp2(world, kv):
    kw = INT8 if kv == "int8" else {}
    prompts = _prompts()
    jeng = world["jax_engine"](("tp2", kv), tp=2,
                               tp_devices=jax.devices()[:2], **kw)
    jreqs = [JaxRequest(p, 8, request_id=i, seed=100 + i)
             for i, p in enumerate(prompts)]
    jeng.serve(jreqs)
    want = [list(r.output_tokens) for r in jreqs]
    got, eng = _serve(world["net"], prompts, 2, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
        gap = _jax_gap(world["jnet"], prompts[i], b[:j],
                       list(jreqs[i].kv_history), kw.get("kv_dtype"))
        assert gap < 1e-4, (i, j, gap, a, b)
    assert eng.stats["tokens_emitted"] == sum(map(len, want))


def test_tp_int8_layer0_leaves_equal_tp1_and_jax(world):
    prompts = _prompts(n=2)
    _, e1 = _serve(world["net"], prompts, 1, **INT8)
    _, e2 = _serve(world["net"], prompts, 2, **INT8)
    jeng = world["jax_engine"]("tp2_int8_leaves", tp=2,
                               tp_devices=jax.devices()[:2], **INT8)
    jeng.serve([JaxRequest(p, 8, request_id=i, seed=100 + i)
                for i, p in enumerate(prompts)])
    N = e1.page_pool.num_pages
    jleaves = [np.asarray(x) for x in (jeng._kp, jeng._vp, jeng._ks,
                                       jeng._vs)]
    for j, (head_axis, one) in enumerate(zip((3, 3, 2, 2), e1._pools[0])):
        two = torch.cat([p[j] for p in e2._pools], dim=head_axis)
        a, b = one[:, :N].numpy(), two[:, :N].numpy()
        assert a[0].tobytes() == b[0].tobytes()
        if a.dtype == np.int8:
            # codes: the JAX engine's bytes; scales: the two packages'
            # float32 products round apart by ~1e-9 already at tp=1
            assert b[0].tobytes() == jleaves[j][0].tobytes()
        else:
            np.testing.assert_allclose(b[0], jleaves[j][0], rtol=1e-6)
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


def test_tp_w8_shards_are_slices_of_the_reference_layout(world):
    floats = dict(world["net"].named_parameters())
    eng = ServingEngine(world["port_net"](), device="cpu", tp=2,
                        tp_devices=_cpus(2), weight_dtype="int8", **ENGINE)
    plan = {q.name: q for q in eng._w8_plan}
    assert len(plan) == 4 * KW["num_layers"] + 2 * KW["num_layers"]
    for name, q in plan.items():
        w = floats[name].detach().numpy().copy()
        codes, scale, tile, _ = jax_quantize(w, q.kind, tp=2, tp_axis="tp",
                                             max_shards=KW["num_heads"])
        codes, scale = np.asarray(codes), np.asarray(scale)
        assert q.codes.numpy().tobytes() == codes.tobytes(), name
        assert q.scale.numpy().tobytes() == scale.tobytes(), name
        mod = name.rsplit(".", 1)[0].replace("backbone.", "", 1)
        for r, shard in enumerate(eng._shards):
            dense = shard.get_submodule(mod)
            if q.kind == "col":
                o = codes.shape[0] // 2
                want_c = codes[r * o:(r + 1) * o]
                want_s = scale[r * o // tile:(r + 1) * o // tile]
            else:
                i = codes.shape[1] // 2
                want_c, want_s = codes[:, r * i:(r + 1) * i], scale
            assert dense.codes.numpy().tobytes() \
                == np.ascontiguousarray(want_c).tobytes(), (name, r)
            assert dense.scale.numpy().tobytes() == want_s.tobytes()
    # per-chip weight bytes: split tensors count half, the rest whole
    per_chip = eng.stats["weight_bytes_per_chip"]
    assert per_chip < eng.stats["weight_bytes_total"]
    assert eng._statusz()["config"]["weight_bytes_per_chip"] == per_chip


# ---------------------------------------------------------------------------
# per-chip accounting and /statusz
# ---------------------------------------------------------------------------

def test_tp_hbm_budget_is_per_chip(world):
    # 4096 B/page float32 here: 32 KiB affords 8 pages at tp=1 (binding:
    # below the 16-page natural pool) and 16 at tp=2, as in the reference
    budget = 32 * 1024
    kw = dict(num_slots=2, max_length=64, page_size=8,
              hbm_budget_bytes=budget)
    pages = {}
    for tp in (1, 2):
        eng = ServingEngine(world["net"], device="cpu", tp=tp,
                            tp_devices=_cpus(tp), **kw)
        jeng = world["jax_engine"](("budget", tp), tp=tp,
                                   tp_devices=jax.devices()[:max(tp, 1)],
                                   **dict(kw, num_slots=2))
        pages[tp] = eng.page_pool.num_pages
        assert pages[tp] == jeng.page_pool.num_pages
    assert pages == {1: 8, 2: 16}
    blk = eng._statusz()["sharding"]
    assert blk["kv_page_bytes_per_chip"] * 2 == eng.stats["kv_page_bytes"]


def test_tp_statusz_sharding_block_matches_jax(world):
    _, eng = _serve(world["net"], _prompts(n=1), 2)
    jeng = world["jax_engine"](("tp2", "float32"), tp=2,
                               tp_devices=jax.devices()[:2])
    z, jz = eng._statusz(), jeng._statusz()
    assert z["config"]["tp_shards"] == jz["config"]["tp_shards"] == 2
    blk, jblk = z["sharding"], jz["sharding"]
    assert set(blk) == set(jblk)
    for key in ("tp_shards", "heads_per_shard", "kv_page_bytes_per_chip",
                "replicated"):
        assert blk[key] == jblk[key], key
    assert blk["mesh_devices"] == ["cpu", "cpu"]
    _, e1 = _serve(world["net"], _prompts(n=1), 1)
    assert e1._statusz()["sharding"] is None
    assert e1.stats["tp_shards"] == 1


def test_tp_cost_program_and_per_chip_gauges(world):
    _, eng = _serve(world["net"], _prompts(n=2), 2)
    assert eng._cost_program.endswith("/tp2")
    rec = _cost.get(eng._cost_program)
    assert rec["shards"] == 2 and rec["dispatches"] > 0
    # the registered cost is whole-model, the live MFU per chip
    pf = _cost.peaks(rec["dtype"])[0]
    assert rec["mfu"] == pytest.approx(
        rec["flops"] / rec["last_seconds"] / pf / 2)
    rows = eng._hbm_ledger()
    assert len(rows["kv_pages"]) == 2 * 2      # k and v of each shard


# ---------------------------------------------------------------------------
# handoff payloads keep the global head layout
# ---------------------------------------------------------------------------

_HANDOFF_PROMPT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _export(net, tp, rid, **kw):
    eng = ServingEngine(net, device="cpu", tp=tp, tp_devices=_cpus(tp),
                        **dict(ENGINE, **kw))
    r = Request(_HANDOFF_PROMPT, 8, request_id=rid, seed=5)
    eng.submit(r)
    while not r.output_tokens:
        eng.step()
    e = eng.export_handoff(r.id)
    assert e is not None and eng.audit_pages() == []
    return eng, e


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("dst_tp", [1, 4])
def test_tp2_handoff_payload_is_global_and_lands_anywhere(world, kv, dst_tp):
    kw = INT8 if kv == "int8" else {}
    net = world["net"]
    want, _ = _serve(net, [_HANDOFF_PROMPT], 1, **kw)
    _, e1 = _export(net, 1, "h1", **kw)
    e2src, e2 = _export(net, 2, "h2", **kw)
    b1 = wire.encode_request(e1)["kv_payload"]
    b2 = wire.encode_request(e2)["kv_payload"]
    for key in ("length", "cur_tok", "remaining", "counters"):
        assert b1[key] == b2[key], key
    for p1, p2 in zip(e1.kv_payload["pages"], e2.kv_payload["pages"]):
        assert set(p1) == set(p2)
        for name in p1:
            a, b = p1[name], p2[name]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a[0].tobytes() == b[0].tobytes(), name   # layer 0
    # the global layout itself: tp=1's pages scattered into the tp=2
    # pools and gathered back are the same bytes
    fresh = e2src.page_pool.alloc(len(e1.kv_payload["pages"]))
    e2src._tier_scatter(list(zip(fresh, e1.kv_payload["pages"])))
    back = e2src._tier_gather(fresh)
    for p1, pb in zip(e1.kv_payload["pages"], back):
        for name in p1:
            assert p1[name].tobytes() == pb[name].tobytes(), name
    e2src.page_pool.free(e2src.page_pool.decref(fresh))
    # the tp=2 blob lands in a tp=1 (or tp=4) engine and continues
    req = wire.decode_request(wire.loads(wire.dumps(
        wire.encode_request(e2))))
    dst = ServingEngine(net, device="cpu", tp=dst_tp,
                        tp_devices=_cpus(dst_tp), **dict(ENGINE, **kw))
    dst.adopt(req, migrated_from="wire")
    while dst.has_work:
        dst.step()
    assert req.status == "finished"
    assert [list(req.output_tokens)] == want
    assert dst.stats["prefill_tokens"] == 0          # no re-prefill
    assert dst.audit_pages() == []


# ---------------------------------------------------------------------------
# the router, compile discipline, the lockstep forward, the fleet spec
# ---------------------------------------------------------------------------

def test_tp_router_kill_mid_decode_migrates_across_shard_counts(world):
    net = world["net"]

    def engine(tp):
        return ServingEngine(net, device="cpu", num_slots=2, max_length=32,
                             page_size=8, tp=tp, tp_devices=_cpus(tp),
                             chunk_tokens=8, prefill_chunk_budget=64)

    def reqs():
        rng = np.random.default_rng(9)
        return [Request(rng.integers(1, 97, size=int(
                    rng.integers(3, 9))).tolist(), 6, request_id=i,
                    seed=100 + i) for i in range(8)]
    base = engine(1)
    want_reqs = reqs()
    base.serve(want_reqs)
    want = {r.id: list(r.output_tokens) for r in want_reqs}
    engines = [engine(2), engine(4)]
    router = ServingRouter(engines)
    plan = ReplicaFaultPlan(kill={4: 0}).install(router)
    try:
        rs = reqs()
        for r in rs:
            router.submit(r)
        n = 0
        while router.has_work and n < 5000:
            router.step()
            n += 1
    finally:
        plan.uninstall()
    assert n < 5000
    assert plan.counts["kill"] == 1
    assert {r.status for r in rs} == {"finished"}
    assert {r.id: list(r.output_tokens) for r in rs} == want
    assert router.stats["migrated"] >= 1
    assert engines[1].audit_pages() == []


def test_tp_engine_steady_state_compiles_stay_zero(world):
    net = world["net"]
    pool = _pool(net.config, "int8")
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 97, size=16).tolist()
    eng = ServingEngine(net, device="cpu", num_slots=2, max_length=64,
                        page_size=8, kv_dtype="int8", prefix_cache=True,
                        adapter_pool=pool, tp=2, tp_devices=_cpus(2))
    eng.serve([Request(shared + [5], 3, request_id="warm"),
               Request([1, 2, 3], 3, request_id="warm2", adapter_id="a"),
               Request([4, 4], 3, request_id="warm3", do_sample=True,
                       seed=0)])
    eng.mark_warm()
    before = _cost.report()["steady_compiles"]
    for n in (5, 23, 31):
        eng.serve([Request(rng.integers(1, 97, size=n).tolist(), 3)])
    eng.serve([Request(shared + [9], 3)])       # prefix attach
    eng.serve([Request(shared, 2)])             # fully cached prompt
    eng.serve([Request([8, 9, 10], 3, adapter_id="a", do_sample=True,
                       seed=1)])
    assert _cost.report()["steady_compiles"] == before == 0
    assert eng._cost_program.endswith("/tp2")
    assert eng.audit_pages() == []


@pytest.mark.parametrize("slab", [None, "float", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_lockstep_forward_logits_equal_unsharded(world, tp, slab):
    net = world["net"]
    B, W, L, H = 3, 6, KW["num_layers"], KW["num_heads"]
    pool = ad = ads = None
    if slab is not None:
        pool = _pool(net.config, None if slab == "float" else "int8")
        pool.acquire("a")
        slots = torch.tensor([1, 0, 1], dtype=torch.int32)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (B, W)))
    spans = torch.tensor([6, 2, 0], dtype=torch.int32)

    def cache(h):
        c = PagedKVCache.create(L, B, h, 64, KW["units"] // H, page_size=8,
                                lengths=np.zeros(B), device="cpu")
        c.spans = spans
        return c
    full = cache(H)
    group = TPGroup(["cpu"] * tp)
    if pool is not None:
        ad, ads = pool.batch(slots), pool.shard_batches(slots, group)
    with torch.no_grad():
        want, _ = net(ids, full, adapters=ad)
        base, _ = net(ids, cache(H))
    caches = [cache(H // tp) for _ in range(tp)]
    got = tp_forward(shard_gpt2(net, group), group, ids, caches,
                     adapters=ads)
    live = torch.arange(W)[None, :] < spans[:, None]
    err = (got - want)[live].abs().max().item()
    top = want[live].abs().max().item()
    assert err <= 1e-5 * top
    if pool is not None:
        # the adapter moves slot 0's logits far beyond the tolerance
        assert (want - base)[0].abs().max().item() > 100 * 1e-5 * top
    # the shards' pools hold the unsharded pools' heads, in shard order
    # (the same bits in layer 0, unless the LoRA rank reduction summed
    # its partials there)
    k = torch.cat([c.k_pages for c in caches], dim=3)
    if pool is None:
        assert torch.equal(k[0], full.k_pages[0])
    torch.testing.assert_close(k, full.k_pages, rtol=1e-5, atol=1e-6)


def test_fleet_spec_carries_tp(world):
    spec = {"config": {k: v for k, v in KW.items()}, "seed": 3,
            "init_std": 0.05, "engine": dict(ENGINE)}
    _, _, e1 = build_engine(spec, device="cpu")
    spec["engine"].update(tp=2, tp_devices=["cpu", "cpu"])
    _, _, e2 = build_engine(spec, device="cpu")
    assert e2.stats["tp_shards"] == 2
    outs = []
    for eng in (e1, e2):
        reqs = [Request(p, 6, request_id=i) for i, p in
                enumerate(_prompts())]
        eng.serve(reqs)
        outs.append([r.output_tokens for r in reqs])
    assert outs[0] == outs[1]
