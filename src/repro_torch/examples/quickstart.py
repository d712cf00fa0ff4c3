"""Quickstart: the paper's Listing 1 on the port.

An application with two operations: Calculation() on the compute rows
and analyze_workload() on one decoupled analytics row (alpha = 1/8). The
compute rows stream their workload figure; the analytics row folds
min/max/median as the figures arrive (`workload_stats_op`): three
reductions that would otherwise be three global collectives on every
process.

    python -m repro_torch.examples.quickstart [--device cpu] [--seed 0]

It runs an 8-rank world (`launch.mesh.spawn`) on the card unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.dataflow import ServiceGraph
from repro_torch.core.operators import finalize_workload_stats, workload_stats_op

N_ROWS = 8


def workload_inputs(seed: int) -> np.ndarray:
    """(8, 1, 8192) f32 workloads, the reference example's draws."""
    rng = np.random.default_rng(seed)
    rng.integers(1000, 8000)  # the reference draws a size first; keep its stream
    return rng.normal(size=(N_ROWS, 1, 8192)).astype(np.float32)


def workload_stats(mesh, seed: int = 0) -> dict:
    """This rank's part of Listing 1. Returns the row's workload figure and,
    on the analytics row, the folded {min, max, median, count}."""
    graph = ServiceGraph.build(mesh, stages={"analytics": 1 / 8},
                               edges=[("compute", "analytics")])
    channel = graph.channel("compute", "analytics")
    op = workload_stats_op(max_samples=64, device=mesh.device)
    work = torch.from_numpy(workload_inputs(seed)[mesh.row]).to(mesh.device)
    # Calculation(): each compute row does its share of the work
    local = torch.sum(torch.sin(work[0]) ** 2)
    # MPIStream_Isend: one workload sample per element
    elements = torch.zeros((1, 8), dtype=torch.float32, device=mesh.device)
    elements[0, 0] = local
    # MPIStream_Operate: the analytics row folds what arrives
    state = channel.stream_fold(elements, op.apply, op.init())
    stats = None
    if graph.gmesh.is_member("analytics"):
        stats = {k: float(v) for k, v in finalize_workload_stats(state).items()}
    return {"describe": graph.describe(), "local": float(local), "stats": stats}


def main(argv=None) -> int:
    from repro_torch.launch.mesh import spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    ranks = spawn(workload_stats, N_ROWS, device=args.device, args=(args.seed,))
    print(ranks[0]["describe"])
    local = np.array([r["local"] for r in ranks])
    stats = ranks[-1]["stats"]
    print("per-row workloads:", np.round(local, 2))
    print("decoupled analytics (row 7):", stats)
    got = np.sort(local[:-1])
    if abs(stats["min"] - got[0]) > 1e-3 or abs(stats["max"] - got[-1]) > 1e-3 \
            or abs(stats["median"] - float(np.median(got))) > 1e-3:
        raise AssertionError(f"analytics {stats} disagree with the rows' workloads {got}")
    print("OK: min/max/median computed on the analytics group only.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
