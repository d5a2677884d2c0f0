"""Where a restarted or faulted request's stream could leave its
uninterrupted one, on one card.

    python3 -m mxnet_tpu_torch.tools.probe_restart

The serving engine's restart path re-prefills a request's prompt plus the
tokens it already emitted, so each of those tokens' logits is computed
again as a row of a prefill chunk where it was first a decode row; the
chaos soak of chip_smoke.py (phase gpt2_robust) also co-batches requests
differently and poisons key pages with NaN. This probe measures each
property apart on the GPT-2 774M model (seeded random weights, float32,
ServingEngine(num_slots=8, max_length=1024, page_size=64,
chunk_tokens=64)):

  * restart: chip_smoke's chaos request c0 (sampled) served alone, and
    again with one injected dispatch fault once it has emitted k tokens
    (k = 1, 5, 9): whether the streams are equal, and the largest
    difference between the logits each token was drawn from;
  * cobatched: the same request served beside seven others;
  * chaos: chip_smoke's chaos traffic fault-free and under three fault
    plans (all kinds as phase gpt2_robust; dispatch exceptions only; NaN
    pages only): the requests whose streams differ from the fault-free
    run, with the token where they part, their requeues and whether the
    finite guard scrubbed them.

Prints one JSON line per part, then the card's name and power limit.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_NEW = 16
PLANS = {
    "all_kinds": dict(seed=3, dispatch_exception=0.05, nan_logits=0.05,
                      pool_exhaustion=0.05, exhaust_steps=2,
                      alloc_failure=0.05,
                      poison={"c5": "both", "c17": "decode"}, max_faults=40),
    "exceptions": dict(seed=3, dispatch_exception=0.1, max_faults=40),
    "nan_pages": dict(seed=3, nan_logits=0.1, max_faults=40),
}


def serve_one(torch, model, prompts, ekw, fail_at=None, others=0):
    """Serve request c0 (with `others` more beside it); with `fail_at`,
    one injected dispatch fault once c0 has emitted that many tokens.
    Returns c0's stream and, by token index, the logits row it was drawn
    from (the final chunk's last live row, or the decode row)."""
    from mxnet_tpu_torch.serving import FaultError, Request, ServingEngine
    eng = ServingEngine(model, device=model.device, retry_backoff_s=0.0,
                        max_retries=8, **ekw)
    reqs = [Request(prompts[i], N_NEW, request_id=f"c{i}", do_sample=True,
                    temperature=0.8, seed=1000 + i)
            for i in range(1 + others)]
    r = reqs[0]
    fired = []

    def hook(engine, phase="step", requests=()):
        if phase == "decode" and fail_at is not None and not fired \
                and len(r.output_tokens) == fail_at:
            fired.append(1)
            raise FaultError("dispatch_exception", "probe fault")
    eng.dispatch_hook = hook
    rows = []

    def grab(module, args, output):
        for s in eng.scheduler.active_slots:
            if eng.scheduler.request_at(s) is r:
                pend = eng._pending[s]
                rows.append((0 if pend is None else int(pend.size),
                             output[0][s].float().cpu()))
    handle = model.register_forward_hook(grab)
    by_token = {}
    try:
        for q in reqs:
            eng.submit(q)
        while eng.has_work:
            rows.clear()
            n0 = len(r.output_tokens)
            eng.step()
            if len(r.output_tokens) > n0 and rows:
                pend, lg = rows[-1]
                by_token[n0] = lg[pend - 1] if pend else lg[0]
    finally:
        handle.remove()
    return r.output_tokens, by_token


def compare(base, other):
    stream, logits = other
    return {"equal": stream == base[0],
            "first_difference": next((i for i, (a, b) in enumerate(
                zip(stream, base[0])) if a != b), None),
            "logits_max_abs_diff": max(
                float((base[1][t] - logits[t]).abs().max())
                for t in base[1] if t in logits)}


def chaos_run(torch, cs, model, prompts, ekw, plan_kw):
    from mxnet_tpu_torch.serving import FaultPlan, Request, ServingEngine
    eng = ServingEngine(model, device=model.device, max_retries=4,
                        retry_backoff_s=0.0, **ekw)
    requeues, scrubbed = {}, []
    requeue, scrub = eng._requeue, eng._scrub_slot_pages

    def logged_requeue(req, now, blamed, error=""):
        requeues.setdefault(req.id, []).append(
            {"tokens": len(req.output_tokens), "blamed": blamed})
        return requeue(req, now, blamed, error)

    def logged_scrub(slot):
        scrubbed.append(eng.scheduler.request_at(slot).id)
        return scrub(slot)
    eng._requeue, eng._scrub_slot_pages = logged_requeue, logged_scrub
    plan = None if plan_kw is None else FaultPlan(**plan_kw)
    got, _, audit = cs.chaos(torch, eng, prompts, N_NEW, Request, plan)
    return got, requeues, scrubbed, dict(plan.counts) if plan else {}, audit


def main():
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    model, cfg = cs.gpt2_774m(torch)
    prompts = cs.robust_traffic(cfg.vocab_size)
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64)
    base = serve_one(torch, model, prompts, ekw)
    out = {f"restart_at_{k}": compare(base, serve_one(
        torch, model, prompts, ekw, fail_at=k)) for k in (1, 5, 9)}
    out["cobatched"] = compare(base, serve_one(torch, model, prompts, ekw,
                                               others=7))
    print(json.dumps({"part": "restart", **out}), flush=True)
    clean = chaos_run(torch, cs, model, prompts, ekw, None)[0]
    for name, plan_kw in PLANS.items():
        got, requeues, scrubbed, counts, audit = chaos_run(
            torch, cs, model, prompts, ekw, plan_kw)
        differ = {}
        for rid, r in got.items():
            want = clean[rid].output_tokens
            if r.status == "finished" and r.output_tokens != want:
                differ[rid] = {
                    "first_difference": next(
                        i for i, (a, b) in enumerate(
                            zip(r.output_tokens, want)) if a != b),
                    "requeues": requeues.get(rid, []),
                    "scrubbed": rid in scrubbed}
        print(json.dumps({"part": "chaos", "plan": name, "faults": counts,
                          "requeued": len(requeues), "scrubbed": scrubbed,
                          "differ": differ, "audit": audit}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
