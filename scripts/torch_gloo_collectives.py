"""Seconds of the rank world's three gradient collectives at one payload.

Times `Mesh.all_reduce`, `Mesh.reduce_scatter` and `Mesh.all_gather` (the
conventional step's gradient all-reduce, the overlap step's reduce-scatter
and its parameter all-gather, staging through the host included) in one
world of ``--rows`` ranks, at a flat f32 payload of ``--elems`` elements
(by default qwen1.5-0.5b's 463,987,712 parameters, the train phase's).
Prints one JSON line per collective: the local payload's bytes, the bytes
a bandwidth-optimal ring sends per rank, and the slowest rank's seconds of
the first call (pinned buffers allocated) and the fastest later call. On
the card by default; on CPUs with ``--device cpu``:

    python3 scripts/torch_gloo_collectives.py --device cpu --rows 4 --elems 67108864
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

OPS = ("all_reduce", "reduce_scatter", "all_gather")


def rank_times(mesh, elems: int, reps: int) -> dict:
    """This rank's seconds per call of each collective, first call first."""
    import torch

    gen = torch.Generator(device=mesh.device).manual_seed(mesh.row)
    x = torch.randn((elems,), generator=gen, device=mesh.device)
    part = x[:elems // mesh.n_rows].clone()
    calls = {"all_reduce": lambda: mesh.all_reduce(x),
             "reduce_scatter": lambda: mesh.reduce_scatter(x),
             "all_gather": lambda: mesh.all_gather(part)}
    out = {}
    for name in OPS:
        times = []
        for _ in range(reps + 1):
            mesh.barrier()
            mesh.sync()
            t0 = time.perf_counter()
            calls[name]()
            mesh.sync()
            times.append(time.perf_counter() - t0)
        out[name] = times
    return out


def main(argv=None) -> int:
    from repro_torch.launch.mesh import spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--elems", type=int, default=463_987_712)
    ap.add_argument("--reps", type=int, default=3, help="calls timed after the first")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, help="also write the lines to this file")
    args = ap.parse_args(argv)
    elems = -(-args.elems // args.rows) * args.rows  # whole parts, as the ZeRO-1 plan pads
    ranks = spawn(rank_times, args.rows, device=args.device, args=(elems, args.reps),
                  timeout_s=1800)
    n, nbytes = args.rows, elems * 4
    ring = {"all_reduce": 2 * (n - 1) / n * nbytes, "reduce_scatter": (n - 1) / n * nbytes,
            "all_gather": (n - 1) / n * nbytes}
    payload = {"all_reduce": nbytes, "reduce_scatter": nbytes, "all_gather": nbytes // n}
    lines = []
    for name in OPS:
        first = max(r[name][0] for r in ranks)
        later = min(max(r[name][i] for r in ranks) for i in range(1, args.reps + 1))
        lines.append({"collective": name, "rows": n, "device": args.device or "cuda",
                      "payload_bytes": payload[name], "ring_bytes_per_rank": ring[name],
                      "first_s": first, "best_s": later,
                      "ring_gb_per_s": ring[name] / later / 1e9})
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
