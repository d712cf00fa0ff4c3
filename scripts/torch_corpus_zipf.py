"""Find why the MapReduce corpus of one seed differs between numpy versions.

`make_corpus` draws its word ids with `numpy.random.Generator.zipf(1.4)`,
then the document lengths from the same generator. This script holds the
installed numpy's `zipf` draws against two rejection samplers emulated on
the same generator's doubles (each attempt takes two, U then V):

- "plain": U = 1 - u, as numpy's `random_zipf` long had it;
- "bounded": U = u * Umin + (1 - u) with Umin = RAND_INT_MAX ** -(a - 1),
  so U never maps to an id past the largest int64, which the plain
  sampler rejects (and then draws two more doubles).

Per sampler it prints how many draws differ from numpy's, in all and by
more than one place of `pow`'s last bit can explain (an id near 2^53 and
above moves by one or more there), the first that does, and how many
attempts it rejected for an id past the largest int64.
A sampler whose stream has parted from numpy's differs almost everywhere
after that point. With ``--corpus`` it also prints the smoke's
corpus (`chip_smoke.MR_CFG`, 151,936 words): valid words and the hottest
bin. Runs on the CPU, imports nothing of JAX:

    python3 scripts/torch_corpus_zipf.py [--draws N] [--seed S] [--corpus]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

A = 1.4
RAND_INT_MAX = float(np.iinfo(np.int64).max)
CHUNK = 1 << 22


def sampler(seed: int, bounded: bool, rejected: list):
    """Chunks of the ids one sampler draws from ``default_rng(seed)``'s
    doubles; ``rejected[0]`` counts the attempts whose id passed the
    largest int64."""
    rng = np.random.default_rng(seed)
    am1 = A - 1.0
    b = 2.0 ** am1
    umin = RAND_INT_MAX ** -am1
    while True:
        d = rng.random(2 * CHUNK)
        u, v = d[0::2], d[1::2]
        big_u = u * umin + (1.0 - u) if bounded else 1.0 - u
        x = np.floor(big_u ** (-1.0 / am1))
        inside = (x <= RAND_INT_MAX) & (x >= 1.0)
        rejected[0] += int((x > RAND_INT_MAX).sum())
        xs = np.where(inside, x, 1.0)
        t = (1.0 + 1.0 / xs) ** am1
        ok = inside & (v * xs * (t - 1.0) / (b - 1.0) <= t / b)
        yield xs[ok].astype(np.int64)


def compare(seed: int, draws: int, bounded: bool) -> dict:
    """The sampler against numpy's own draws: how many differ, the first
    that does, and how many differ by more than 2^-50 of the id (or 1),
    which a last-place difference between numpy's and this `pow` cannot
    explain."""
    lib = np.random.default_rng(seed)
    rejected = [0]
    got = np.empty(0, np.int64)
    first, done, n_diff, n_far = None, 0, 0, 0
    for chunk in sampler(seed, bounded, rejected):
        got = np.concatenate([got, chunk])
        take = min(len(got), draws - done)
        want = lib.zipf(A, size=take)
        bad = np.flatnonzero(want != got[:take])
        if bad.size and first is None:
            i = int(bad[0])
            first = {"index": done + i, "numpy": int(want[i]), "sampler": int(got[i])}
        n_diff += int(bad.size)
        gap = np.abs(want[bad] - got[bad]).astype(np.float64)
        n_far += int((gap > np.maximum(1.0, want[bad] * 2.0 ** -50)).sum())
        got = got[take:]
        done += take
        if done >= draws:
            break
    return {"differ": n_diff, "differ_past_rounding": n_far, "first_difference": first,
            "rejected_past_int64": rejected[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=1 << 26)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", action="store_true")
    args = ap.parse_args(argv)
    out = {"numpy": np.__version__, "a": A, "seed": args.seed, "draws": args.draws}
    for name, bounded in (("plain", False), ("bounded", True)):
        out[name] = compare(args.seed, args.draws, bounded)
    if args.corpus:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path[:0] = [os.path.join(here, "src"), here]
        from chip_smoke import MR_CFG, MR_ROWS, MR_VOCABS
        from repro_torch.apps.mapreduce import CorpusCfg, make_corpus

        cfg = CorpusCfg(**MR_CFG, vocab=MR_VOCABS[0], seed=args.seed)
        tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * MR_ROWS)
        hist = np.bincount(tokens[mask > 0], minlength=cfg.vocab)
        out["corpus"] = {"vocab": cfg.vocab, "valid_words": int((mask > 0).sum()),
                         "hottest_bin": int(hist.max())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
