"""How far the port's CG modes drift apart in f32, and from the true residual.

Runs `repro_torch.apps.cg.cg_world` (one 8-rank world, every mode, 300
iterations) on a 1,008 x ny x nz grid (the smoke's: ny = nz = 120) and
prints one JSON line per mode: the largest relative
difference of its history r.r from the blocking mode's over the first 20
and over all iterations, the same against a float64 CG of the same global
system on the host (`numpy`, blocking decomposition irrelevant there), and
its reported residual sqrt(r.r) beside the true residual ||b - A u||
recomputed in float64 from the gathered u (`cg.residual_norm`). On the
card by default; on CPUs with ``--device cpu`` (a cut grid there):

    python3 scripts/torch_cg_drift.py --device cpu --ny 24 --nz 24
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROWS = 8  # the smoke's world: x-slabs of 126 over 8 rows, or of 144 over 7

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def cg_f64(b: np.ndarray, n_iters: int) -> np.ndarray:
    """The history r.r of CG from x = 0 on the global system, in float64."""
    from repro_torch.apps.cg import laplacian_f64

    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = float((r * r).sum())
    hist = []
    for _ in range(n_iters):
        ap = -laplacian_f64(p)
        alpha = rs / max(float((p * ap).sum()), 1e-30)
        x += alpha * p
        r -= alpha * ap
        rs_new = float((r * r).sum())
        p = r + rs_new / max(rs, 1e-30) * p
        rs = rs_new
        hist.append(rs)
    return np.array(hist)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ny", type=int, default=120)
    ap.add_argument("--nz", type=int, default=120)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from repro_torch.apps.cg import CGCfg, cg_rhs, cg_world, residual_norm

    cfg = CGCfg(nx_local=126, ny=args.ny, nz=args.nz, n_iters=300)
    out = cg_world(cfg, n_rows=ROWS, device=args.device)
    work = {"blocking": ROWS, "nonblocking": ROWS, "decoupled": ROWS - 1}
    b = cg_rhs(cfg, ROWS, ROWS).reshape(-1, cfg.ny, cfg.nz).astype(np.float64)
    exact = cg_f64(b, cfg.n_iters)
    base = out["blocking"][2]
    for mode, (u, res, hist) in out.items():
        u_global = u[:work[mode]].reshape(-1, cfg.ny, cfg.nz)
        rel = np.abs(hist - base) / base
        rel64 = np.abs(hist - exact) / exact
        true = residual_norm(u_global, b)
        print(json.dumps({"mode": mode, "grid": [cfg.nx_local * ROWS, cfg.ny, cfg.nz],
                          "iters": cfg.n_iters,
                          "vs_blocking_first20": float(rel[:20].max()),
                          "vs_blocking_all": float(rel.max()),
                          "vs_f64_first20": float(rel64[:20].max()),
                          "vs_f64_all": float(rel64.max()),
                          "hist_first_last": [float(hist[0]), float(hist[-1])],
                          "reported_residual": res, "true_residual": true,
                          "true_vs_reported_rel": abs(true - res) / res,
                          "true_vs_rhs_norm": abs(true - res) / float(np.linalg.norm(b))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
