"""Serving speed of this checkout against another one, on one card.

    python3 -m mxnet_tpu_torch.tools.compare_serving OTHER_ROOT

OTHER_ROOT is the root of another checkout of the port (for example the
parent commit unpacked with `git archive`). Each run is a fresh process
that imports `mxnet_tpu_torch` from one root and serves GPT-2 774M at
full width (seeded random weights) through the kernel path with the
traffic of chip_smoke.py's gpt2 phase: 8 greedy requests, prompts
U[16, 128] from numpy seed 0, 32 new tokens each,
ServingEngine(num_slots=8, max_length=1024, page_size=64). Per dtype
(float32, then the same weights in bfloat16) it serves once to warm up
and then three timed serves, each timed from a device sync to a device
sync and divided by its dispatches. The runs take turns, other, this,
this, other, so that a drift of the shared host shows on both sides.
Prints one JSON line per run, then the median ms per dispatch of each
side and dtype, and the card's name and power limit.
"""
import json
import os
import subprocess
import sys
import time

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMED = 3


def child(root):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, gpt2_774m_config,
                                        init_params)
    from mxnet_tpu_torch.serving import Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_774m_config(dropout=0.0, attention_dropout=0.0)
    model = GPT2ForCausalLM(cfg, device="cuda")
    init_params(model, seed=0, std=0.02)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 129, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in plens]
    out = {"root": root,
           "requires_grad": next(model.parameters()).requires_grad}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        model.to(dtype)
        eng = ServingEngine(model, device="cuda", num_slots=8,
                            max_length=1024, page_size=64)
        ms = []
        for i in range(TIMED + 1):
            reqs = [Request(p, 32, request_id=j)
                    for j, p in enumerate(prompts)]
            eng.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve(reqs)
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3
                          / eng.stats["decode_dispatches"])
        out[name] = {"ms_per_dispatch": ms,
                     "dispatches": eng.stats["decode_dispatches"]}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) == 3 and argv[1] == "--child":
        child(argv[2])
        return 0
    if len(argv) != 2 or not os.path.isdir(
            os.path.join(argv[1], "mxnet_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"other": os.path.abspath(argv[1]), "this": THIS_ROOT}
    samples = {}
    for side in ("other", "this", "this", "other"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", roots[side]],
                           capture_output=True, text=True, check=False)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        run = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, **run}), flush=True)
        for dt in ("float32", "bfloat16"):
            samples.setdefault((side, dt), []).extend(
                run[dt]["ms_per_dispatch"])
    import numpy as np
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "median_ms_per_dispatch": {
        f"{side}_{dt}": float(np.median(v))
        for (side, dt), v in samples.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
