"""The paper's headline case study (Sec. IV-B) on the port: the word
histogram MapReduce, reference against decoupled and pipelined, with the
Eq.-4 model choosing alpha at the paper's scales.

    python -m repro_torch.examples.decoupled_mapreduce [--device cpu]

It runs an 8-rank world (`apps.mapreduce.wordcount_world`) on the card
unless ``--device`` names another device; every histogram is checked
against a count on the host.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.apps.mapreduce import MODES, CorpusCfg, make_corpus, wordcount_world
from repro_torch.core.perfmodel import StreamCosts, WorkloadProfile, optimal_alpha

N_ROWS = 8
SCALES = (32, 2048, 8192)


def model_alphas(scales=SCALES) -> dict[int, tuple[float, float]]:
    """{P: (alpha, modelled time)} from Eq. 4 with the example's profile:
    the paper's 2.9 TB corpus over 8,192 processes, 64 KB elements, and a
    decoupled reduce whose unaggregated master stage congests as the
    group grows (the paper's own observation at 4,096 and 8,192)."""

    def t_w1_prime(total, p, p1):
        return 0.05 * np.log2(max(p1, 2)) + 6e-3 * p1

    profile = WorkloadProfile(t_w0=1.0, t_w1=0.4, d_bytes=2.9e12 / 8192, sigma=0.08,
                              t_w1_prime=t_w1_prime)
    costs = StreamCosts(o_seconds=2e-6)
    return {p: optimal_alpha(profile, p, s_bytes=64e3, costs=costs) for p in scales}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = CorpusCfg(n_docs_per_row=8, words_per_doc=1024, vocab=2048, skew=0.8)
    hists = wordcount_world(cfg, MODES, n_rows=N_ROWS, device=args.device)
    tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    want = np.bincount(tokens[mask > 0], minlength=cfg.vocab).astype(np.float32)
    for mode, h in hists.items():
        if not np.array_equal(h, want):
            raise AssertionError(f"{mode}: the histogram differs from the host count")
    top = np.argsort(-want, kind="stable")[:5]
    print("top-5 words:", {int(w): int(want[w]) for w in top})
    print("decoupled == pipelined == reference histogram == host count: OK")
    for p, (a, _) in model_alphas().items():
        print(f"P={p:5d}: model-optimal alpha = 1/{round(1 / a)} "
              f"(paper found 1/16 best at scale)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
