"""The port's serving robustness layer against the JAX package.

On weights carried across from a seeded JAX tiny GPT-2 (attn_impl="xla"
on the JAX side) and the same traffic, tick clock and fault seeds, the
port's engine must end every request in the JAX engine's terminal status
with its tokens, and count what it counts: deadlines (queued and
running), SheddingPolicy decisions (shed, downgrade, degrade, recover),
the supervisor's blamed and unblamed requeues, a seeded FaultPlan chaos
soak with poison quarantined (float32 and int8 pages), the finite-logits
guard, tenant quotas and tenant_stats. Greedy traffic is compared with
the JAX engine token for token; sampled traffic (the port's own sampler)
with the port's fault-free run. The port's supervisor re-raises a CUDA
error and a kernel error instead of retrying them.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving as jax_serving  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
import mxnet_tpu_torch.serving as port_serving  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.ops._build import KernelError  # noqa: E402

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, max_length=32, page_size=8, decode_block=2)
COUNTERS = ("dispatch_errors", "dispatch_retries", "requests_failed",
            "requests_finished", "requests_rejected", "shed",
            "tokens_emitted", "prefills", "decode_dispatches")


class Tick:
    """Injectable engine clock: deadline and backoff tests advance time
    explicitly instead of racing wall time."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


@pytest.fixture(scope="module")
def sides():
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)

    def side(mod, make):
        return SimpleNamespace(
            engine=lambda **kw: make(**dict(ENGINE, **kw)),
            Request=mod.Request, FaultPlan=mod.FaultPlan,
            SheddingPolicy=mod.SheddingPolicy, ShedError=mod.ShedError,
            QueueFullError=mod.QueueFullError,
            TenantQuotaError=mod.TenantQuotaError,
            TenantQuota=mod.TenantQuota)
    return {"jax": side(jax_serving, lambda **kw: jax_serving.ServingEngine(
                jnet, attn_impl="xla", **kw)),
            "port": side(port_serving, lambda **kw: port_serving.ServingEngine(
                net, device="cpu", **kw))}


def _both(sides, run):
    """run(side) on the JAX engine and on the port; returns (want, got)."""
    return run(sides["jax"]), run(sides["port"])


def _reqs(R, n=6, max_new=6, prompt_seed=7, seed_base=100, sampled=False):
    rng = np.random.default_rng(prompt_seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, 97, size=int(rng.integers(3, 9)))
        out.append(R(prompt, max_new, request_id=f"r{i}", do_sample=sampled,
                     temperature=0.9, seed=seed_base + i))
    return out


def _results(done):
    return {r.id: (r.status, list(r.output_tokens)) for r in done}


def _counters(eng):
    s = eng.stats
    return {k: s[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def _deadline_queued(side):
    clk = Tick()
    eng = side.engine(num_slots=1, clock=clk)
    R = side.Request
    eng.submit(R([1, 2, 3], 4, request_id="da"))
    eng.submit(R([4, 5, 6], 4, request_id="db", deadline_ms=50.0))
    done = list(eng.step())          # admits da; db queued behind it
    clk.advance(0.2)                 # 200 ms > db's 50 ms budget
    done += eng.step()
    while eng.has_work:
        done += eng.step()
    return _results(done), _counters(eng), eng.audit_pages()


def _deadline_running(side):
    clk = Tick()
    eng = side.engine(num_slots=1, clock=clk)
    R = side.Request
    r = R([1, 2, 3], 16, request_id="dr", deadline_ms=100.0)
    free = R([1, 2, 3], 16, request_id="free")
    eng.submit(r)
    done = list(eng.step())
    done += eng.step()
    clk.advance(1.0)
    done += eng.step()               # cancelled at the dispatch boundary
    eng.serve([free])
    return (_results(done), _counters(eng), eng.audit_pages(),
            list(free.output_tokens))


def test_deadline_sheds_queued_request_like_jax(sides):
    want, got = _both(sides, _deadline_queued)
    assert got == want
    results, _, audit = got
    assert results["db"] == ("shed", [])
    assert results["da"][0] == "finished"
    assert audit == []


def test_deadline_cancels_running_request_like_jax(sides):
    want, got = _both(sides, _deadline_running)
    assert got == want
    results, counters, audit, unbounded = got
    status, partial = results["dr"]
    assert status == "deadline" and 1 <= len(partial) < 16
    assert partial == unbounded[:len(partial)]   # its prefix, kept
    assert counters["shed"] == 1 and audit == []


# ---------------------------------------------------------------------------
# the shedding policy
# ---------------------------------------------------------------------------

def _submit(eng, r, side):
    try:
        eng.submit(r)
        return ("queued", r.priority)
    except side.ShedError as e:
        return ("shed", e.reason, e.queue_depth, e.active_slots,
                e.retry_after_s, r.status)


def _policy(side, name):
    R, pol = side.Request, side.SheddingPolicy
    trace = []
    if name == "overload_floor":
        eng = side.engine(num_slots=1,
                          policy=pol(queue_low=1, queue_high=2))
        for pr in (0, 0, 1, 0, 2):
            trace.append(_submit(eng, R([1, 2, 3], 2, priority=pr), side))
    elif name == "downgrade":
        eng = side.engine(num_slots=1,
                          policy=pol(queue_low=1, queue_high=10))
        for pr in (0, 1, 1, 0, 2):
            trace.append(_submit(eng, R([1, 2, 3], 2, priority=pr), side))
        trace.append(eng.policy.downgrades)
    elif name == "infeasible_deadline":
        clk = Tick(10.0)
        eng = side.engine(num_slots=1, clock=clk,
                          policy=pol(queue_low=1, queue_high=4))
        eng._finish_times.extend([9.0, 10.0])    # 1 finish/s drain rate
        for dl in (None, None, 500.0, 5000.0):
            trace.append(_submit(eng, R([1, 2, 3], 2, priority=0,
                                        deadline_ms=dl), side))
    elif name == "degrade_recover":
        eng = side.engine(num_slots=1, speculative=True,
                          policy=pol(queue_low=1, queue_high=2,
                                     degrade_after=2, recover_after=2))
        reqs = [R([1, 2, 3], 2, priority=0, request_id=f"g{i}")
                for i in range(6)]
        for r in reqs:
            eng.submit(r)
        for _ in range(40):
            eng.step()
            s = eng.stats
            trace.append((eng.policy.level, eng._degraded,
                          s["overload_level"], s["degraded"]))
        trace.append([list(r.output_tokens) for r in reqs])
    elif name == "tenant_share":
        eng = side.engine(num_slots=1,
                          policy=pol(queue_low=2, queue_high=10,
                                     tenant_queue_share=0.5))
        for tenant in ("a", "a", "a", "b", "a", "b"):
            trace.append(_submit(eng, R([1, 2, 3], 2, priority=0,
                                        tenant=tenant), side))
        trace.append(eng.tenant_stats())
    done = eng.serve()
    trace.append(sorted((r.status, len(r.output_tokens)) for r in done))
    trace.append(_counters(eng))
    return trace


@pytest.mark.parametrize("name", ["overload_floor", "downgrade",
                                  "infeasible_deadline", "degrade_recover",
                                  "tenant_share"])
def test_policy_decisions_match_jax(sides, name):
    want, got = _both(sides, lambda side: _policy(side, name))
    assert got == want
    if name == "degrade_recover":
        levels = got[:40]
        assert any(t[1] for t in levels) and not levels[-1][1]
    elif name != "downgrade":
        assert any(isinstance(t, tuple) and t[0] == "shed" for t in got)


# ---------------------------------------------------------------------------
# the supervisor: blamed and unblamed requeues, the finite guard
# ---------------------------------------------------------------------------

def _faulted(side, plan_kw, engine_kw, sampled=False):
    eng = side.engine(**engine_kw)
    plan = side.FaultPlan(**plan_kw)
    plan.install(eng)
    try:
        done = eng.serve(_reqs(side.Request, sampled=sampled))
    finally:
        plan.uninstall()
    return (_results(done), _counters(eng), dict(plan.counts),
            eng.audit_pages())


CASES = {
    "transient": (dict(seed=1, dispatch_exception=0.3, max_faults=6),
                  dict(max_retries=8, retry_backoff_s=0.0)),
    "nan_guard": (dict(seed=2, nan_logits=0.25, max_faults=2),
                  dict(max_retries=8, retry_backoff_s=0.0)),
    "backpressure": (dict(seed=5, pool_exhaustion=0.4, exhaust_steps=2,
                          alloc_failure=0.4, max_faults=5),
                     dict(prefix_cache=True, max_retries=3,
                          retry_backoff_s=0.0)),
    "poison": (dict(poison={"r2": "decode"}),
               dict(max_retries=3, retry_backoff_s=0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervisor_requeues_match_jax(sides, case):
    plan_kw, engine_kw = CASES[case]
    want, got = _both(sides, lambda side: _faulted(side, plan_kw,
                                                   engine_kw))
    assert got == want
    results, counters, counts, audit = got
    port = sides["port"]
    clean = _results(port.engine().serve(_reqs(port.Request)))
    poison = {"r2"} if case == "poison" else set()
    assert {k: v for k, v in results.items() if k not in poison} \
        == {k: v for k, v in clean.items() if k not in poison}
    assert audit == []
    if case == "backpressure":
        assert counts.get("pool_exhaustion", 0) \
            + counts.get("alloc_failure", 0) >= 1
    else:
        assert counters["dispatch_errors"] >= 1
    if case == "poison":
        assert results["r2"][0] == "failed"
        assert counters["requests_failed"] == 1
    else:
        assert counters["requests_failed"] == 0
    if case == "nan_guard":
        assert counts.get("nan_logits", 0) >= 1


def test_sampled_streams_survive_faults_bit_identical(sides):
    """Sampled traffic through transient faults and NaN pages: restarts
    resume each request's sampling counter, so its stream equals the
    fault-free run's."""
    port = sides["port"]
    clean = _results(port.engine().serve(_reqs(port.Request, sampled=True)))
    results, counters, counts, audit = _faulted(
        port, dict(seed=4, dispatch_exception=0.2, nan_logits=0.2,
                   max_faults=8), dict(max_retries=8, retry_backoff_s=0.0),
        sampled=True)
    assert results == clean
    assert counts.get("nan_logits", 0) >= 1
    assert counts.get("dispatch_exception", 0) >= 1
    assert audit == []


def test_nan_page_is_scrubbed_and_stays_in_its_slot(sides):
    """A NaN page in one slot discards that slot's tokens only: the
    co-batched slot's stream is untouched, the bad page is zeroed before
    it is recycled, and the victim re-prefills to its clean stream."""
    port = sides["port"]
    R = port.Request
    clean = _results(port.engine().serve(_reqs(R, n=2, max_new=10)))
    eng = port.engine(max_retries=8, retry_backoff_s=0.0)
    reqs = _reqs(R, n=2, max_new=10)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    victim = eng.scheduler.active_slots[0]
    page = int(eng._table_host[victim][0])
    eng._kp[:, page] = torch.nan
    done = eng.step()
    assert eng.stats["dispatch_errors"] == 1
    assert not bool(torch.isnan(eng._kp[:, page]).any())
    while eng.has_work:
        done += eng.step()
    assert _results(done) == clean
    assert eng.audit_pages() == []


# ---------------------------------------------------------------------------
# the chaos soak
# ---------------------------------------------------------------------------

def _soak(side, kv_dtype, sampled, faults=True):
    N = 24
    poison = {"c5": "both", "c11": "decode", "c17": "prefill"}
    rng = np.random.default_rng(11)
    pending = []
    for i in range(N):
        prompt = rng.integers(1, 97, size=int(rng.integers(2, 10)))
        n_new = int(rng.integers(2, 7))
        if i == 11:
            n_new = 12       # outlasts max_retries one token at a time
        pending.append(side.Request(prompt, n_new, request_id=f"c{i}",
                                    do_sample=sampled, temperature=0.8,
                                    seed=1000 + i))
    eng = side.engine(num_slots=4, kv_dtype=kv_dtype, max_retries=4,
                      retry_backoff_s=0.0)
    plan = None
    if faults:
        plan = side.FaultPlan(seed=3, dispatch_exception=0.05,
                              nan_logits=0.05, pool_exhaustion=0.05,
                              exhaust_steps=2, alloc_failure=0.05,
                              poison=poison, max_faults=40)
        plan.install(eng)
    arrivals = np.random.default_rng(13)
    pending = pending[::-1]
    done, steps = [], 0
    try:
        while (pending or eng.has_work) and steps < 5000:
            for _ in range(int(arrivals.poisson(3.0))):
                if pending:
                    eng.submit(pending.pop())
            done.extend(eng.step())
            steps += 1
    finally:
        if plan is not None:
            plan.uninstall()
    assert steps < 5000, "the soak did not converge"
    return (_results(done), _counters(eng),
            dict(plan.counts) if plan else {}, eng.audit_pages())


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_chaos_soak_matches_jax(sides, kv_dtype):
    """Poisson arrivals, every fault kind, poison in both phases: the
    port ends each request as the JAX engine does, with its tokens, and
    counts the same faults and requeues. Innocents equal the fault-free
    run; poison is quarantined."""
    want, got = _both(sides, lambda side: _soak(side, kv_dtype, False))
    assert got == want
    results, counters, counts, audit = got
    clean = _soak(sides["port"], kv_dtype, False, faults=False)[0]
    for rid in ("c5", "c11", "c17"):
        assert results[rid][0] == "failed"
    assert {k: v for k, v in results.items() if v[0] != "failed"} \
        == {k: v for k, v in clean.items()
            if k not in ("c5", "c11", "c17")}
    assert counters["requests_failed"] == 3 and audit == []
    assert counters["dispatch_errors"] >= sum(
        counts.get(k, 0) for k in ("poison", "dispatch_exception",
                                   "alloc_failure"))


def test_chaos_soak_sampled_innocents_bit_identical(sides):
    port = sides["port"]
    results, counters, _, audit = _soak(port, None, True)
    clean = _soak(port, None, True, faults=False)[0]
    assert {k: v for k, v in results.items() if v[0] != "failed"} \
        == {k: v for k, v in clean.items()
            if k not in ("c5", "c11", "c17")}
    assert counters["requests_failed"] == 3 and audit == []


# ---------------------------------------------------------------------------
# tenant quotas, the dispatch hook, errors the supervisor must not hide
# ---------------------------------------------------------------------------

def _tenants(side):
    TQ = side.TenantQuota
    eng = side.engine(num_slots=2, tenant_quotas={
        "a": TQ(max_active=1, max_queue=1), "b": TQ(max_queue=2)})
    R = side.Request
    trace = []
    for i, tenant in enumerate(["a", "a", "a", "b", "b", "b", None]):
        r = R([1 + i, 2, 3], 3, request_id=f"t{i}", tenant=tenant)
        try:
            eng.submit(r)
            trace.append("queued")
        except side.QueueFullError as e:
            trace.append((type(e).__name__, r.status,
                          getattr(e, "tenant", None)))
    done = eng.serve()
    trace.append(sorted((r.id, r.status, list(r.output_tokens))
                        for r in done))
    trace.append(eng.tenant_stats())
    trace.append(_counters(eng))
    return trace


def test_tenant_quotas_and_tenant_stats_match_jax(sides):
    want, got = _both(sides, _tenants)
    assert got == want
    assert ("TenantQuotaError", "shed", "a") in got
    assert got[-2]["a"]["shed"] == {"tenant_quota": 2}


def test_dispatch_hook_phases_match_jax(sides):
    def run(side):
        eng = side.engine(num_slots=1)
        phases = []

        def hook(engine, phase="step", requests=()):
            phases.append((phase, tuple(r.id for r in requests)))
        eng.dispatch_hook = hook
        eng.serve([side.Request([1, 2, 3], 3, request_id="h")])
        legacy = []
        eng.dispatch_hook = lambda engine: legacy.append(1)
        eng.serve([side.Request([1, 2, 3], 3, request_id="h2")])
        return phases, len(legacy)
    want, got = _both(sides, run)
    assert got == want
    assert ("prefill", ("h",)) in got[0]


@pytest.mark.parametrize("error,phase", [
    ("accelerator", "decode"), ("accelerator", "prefill"),
    ("kernel", "decode"), ("kernel", "prefill")])
def test_supervisor_reraises_card_and_kernel_errors(sides, error, phase):
    """A CUDA error (torch.AcceleratorError) or a kernel that does not
    build or launch, raised inside an admission or a dispatch, leaves
    step() instead of being requeued (retrying would hide the card),
    and the engine is not ready from then on."""
    eng = sides["port"].engine()
    exc = torch.AcceleratorError("CUDA error: an illegal memory access "
                                 "was encountered") \
        if error == "accelerator" else KernelError("nvcc failed for x")

    def hook(engine, phase="step", requests=()):
        if phase == want_phase:
            raise exc
    want_phase = phase
    eng.dispatch_hook = hook
    eng.submit(sides["port"].Request([1, 2, 3], 4))
    with pytest.raises(type(exc)):
        for _ in range(4):
            eng.step()
    assert eng.stats["dispatch_errors"] == 0
    assert eng.stats["dispatch_retries"] == 0
    assert eng._ready_probe()["degraded"] == "fatal"    # never ready again


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_nan_key_page_stays_in_its_slot_like_the_pallas_kernel(n_split):
    """The finite guard rests on the span attention carrying a NaN key to
    the rows that see it, and to no other slot: a NaN page first in slot
    0 (the first page a split reads) and second in slot 2. The port's
    plain version and the plain version of its kernels' split over pages
    give the NaN elements the JAX Pallas kernel gives (interpret mode);
    the rest agree."""
    from mxnet_tpu.ops import pallas_attention as pa
    from mxnet_tpu_torch.ops import ragged_attention as ra
    import jax.numpy as jnp
    rng = np.random.default_rng(21)
    B, Sq, H, D, S, P = 3, 4, 2, 16, 8, 4
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    kp = rng.standard_normal((B * P, S, H, D)).astype(np.float32)
    vp = rng.standard_normal((B * P, S, H, D)).astype(np.float32)
    table = rng.permutation(B * P).reshape(B, P).astype(np.int32)
    kp[table[0, 0]] = np.nan
    kp[table[2, 1]] = np.nan
    lengths = np.int32([12, 5, 6])
    qc = np.int32([4, 1, 4])
    want = np.asarray(pa.ragged_span_attention(
        *map(jnp.asarray, (q, kp, vp, table, lengths)),
        q_counts=jnp.asarray(qc), interpret=True))
    args = tuple(torch.from_numpy(a) for a in (q, kp, vp, table, lengths))
    plain = ra.ragged_span_attention(*args, q_counts=torch.from_numpy(qc))
    split = ra._ragged_span_split_reference(
        *args, torch.from_numpy(qc), 1 / np.sqrt(D), n_split)
    nan = np.isnan(want)
    assert nan[0].all() and not nan[1].any()
    assert nan[2].any() and not nan[2].all()     # rows 0-2 see page 0 only
    for got in (plain, split):
        got = got.numpy()
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_allclose(np.where(nan, 0, got),
                                   np.where(nan, 0, want),
                                   rtol=2e-5, atol=2e-5)
