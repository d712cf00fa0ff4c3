"""Acceptance of speculative decoding against the draft's noise.

The chip smoke's spec phase (`chip_smoke.py`, phase 6c) drafts with the
target's own weights plus ``eps`` * N(0, 1) per float leaf, and needs an
``eps`` whose acceptance lies inside `chip_smoke.SPEC_ACCEPT_BAND`. This
sweeps ``eps`` on qwen2.5-3b at full width and depth in f32 (TF32 off,
random weights from ``--seed``) over the first ``--requests`` of the
phase's parity requests, dense store, greedy, k = 4, and prints one JSON
line per ``eps``: acceptance, ticks and seconds, with the card's name and
power limit. On the card only:

    python3 scripts/torch_spec_eps.py [--requests 4] [--eps 1e-5 3e-5 1e-4 3e-4 1e-3 3e-3]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--eps", type=float, nargs="+",
                    default=[1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import runtime
    from repro_torch.models.model_zoo import build
    from repro_torch.serve import KVSpec

    if not torch.cuda.is_available():
        print("torch_spec_eps: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runtime.build_all(["argmax_last", "flash_attention", "paged_attention"])
    cfg = get("qwen2.5-3b")
    model = build(dataclasses.replace(cfg, dtype=torch.float32))
    params = model.init(args.seed)
    p = cs.SPEC_PARITY
    reqs = cs.spec_requests(np, cfg.vocab_size, n_req=p["n_req"], new_tokens=p["new_tokens"],
                            seed=args.seed)[:args.requests]
    for eps in args.eps:
        t0 = time.perf_counter()
        draft = (model, cs.noised_params(torch, params, eps, args.seed + 100))
        run = cs.spec_engine_run(torch, np, model, params, draft, reqs, KVSpec(),
                                 max_batch=p["max_batch"], max_len=p["max_len"])
        print(json.dumps({"eps": eps, "acceptance": run["acceptance"],
                          "accepted": run["engine"].stats["accepted"],
                          "drafted": run["engine"].stats["drafted"],
                          "ticks": run["engine"].tick, "requests": len(reqs),
                          "seconds": time.perf_counter() - t0, "nvidia_smi": smi}), flush=True)
        del draft, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
