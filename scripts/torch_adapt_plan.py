"""The adaptive planner's verdicts on the chip smoke's balanced loads.

`core.adapt.ReplanController` decides from counters and a wall alone, so
its verdict for a given load can be replayed on the host without a world.
This feeds it, for each starting partition and wall, two supersteps of
the load the smoke's adaptive runs give it and prints the plan: the word
count over a balanced corpus (skew 0: every document full; the layout of
`apps.mapreduce.row_docs` over the compute rows, the reduce stage's words
= all words) under `run_wordcount_adaptive`'s default policy, and the
decoupled trainer of the train phase (its pipeline's tokens per compute
row at the steps the planner samples; stage items default to the total)
under the smoke's train policy. Walls and counters enter the plan
against Eq. 4''s fixed wire and message terms. Host logic only (CPU):

    python3 scripts/torch_adapt_plan.py [--walls 0.001 0.07 1 6] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def wordcount_work(docs_per_row: int, words: int, rows: int, reduce_rows: int):
    """Per-compute-row words of a balanced corpus under `row_docs`'s layout."""
    import numpy as np

    total = docs_per_row * rows
    compute = rows - reduce_rows
    per = -(-total // compute)
    return np.array([min(per, max(0, total - r * per)) for r in range(compute)], float) * words


def verdict(ctl, wall: float, work, items) -> dict:
    for _ in range(ctl.policy.window):
        d = ctl.step(wall, work, items)
    return {"rows": d.rows, "regroup": d.regroup, "predicted_speedup": d.predicted_speedup,
            "reason": d.reason}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walls", type=float, nargs="+", default=[1e-3, 0.07, 1.0, 6.0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from chip_smoke import (
        ADAPT_POLICY,
        DECOUPLED_BATCH,
        MR_ADAPT_CFG,
        MR_CFG,
        MR_ROWS,
        TRAIN_ROWS,
        TRAIN_SEQ,
    )
    from repro_torch.apps.mapreduce import wordcount_traits
    from repro_torch.core.adapt import AdaptPolicy, ReplanController
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.train.train_step import TrainStepConfig, train_stage_traits

    sizes = {"mapreduce static runs' size (2^26 words)": MR_CFG,
             "mapreduce adaptive run (2^25 words)": MR_ADAPT_CFG,
             "fig12 quick (16 documents of 256)": dict(n_docs_per_row=2, words_per_doc=256)}
    for name, cfg in sizes.items():
        for reduce_rows in (1, 2, 3, 4):
            work = wordcount_work(cfg["n_docs_per_row"], cfg["words_per_doc"], MR_ROWS,
                                  reduce_rows)
            for wall in args.walls:
                ctl = ReplanController(MR_ROWS, {"reduce": reduce_rows}, wordcount_traits(),
                                       AdaptPolicy(window=2, cooldown=1, speedup_threshold=1.25))
                print(json.dumps({"load": "wordcount", "size": name, "reduce_rows": reduce_rows,
                                  "wall_s": wall, "work_cv": float(work.std() / work.mean()),
                                  **verdict(ctl, wall, work, {"reduce": float(work.sum())})}))
    # the train phase's adaptive run: the tokens each compute row holds at
    # steps 2 and 3 (the samples the planner sees; step 1's is skipped),
    # from the phase's pipeline (seed --seed + 8, as chip_smoke.main passes)
    pipe = Pipeline(DataConfig(vocab_size=151_936, seq_len=TRAIN_SEQ,
                               global_batch=DECOUPLED_BATCH, seed=args.seed + 8, kind="zipf",
                               skew=0.4))
    for reduce_rows in (1, 2):
        compute = TRAIN_ROWS - reduce_rows
        works = [pipe.padded_for_groups(step, compute, TRAIN_ROWS)["mask"]
                 .reshape(TRAIN_ROWS, -1).sum(1)[:compute].tolist() for step in (1, 2)]
        for wall in args.walls:
            ctl = ReplanController(TRAIN_ROWS, {"reduce": reduce_rows},
                                   train_stage_traits(TrainStepConfig(mode="decoupled")),
                                   AdaptPolicy(**ADAPT_POLICY))
            for work in works:
                d = ctl.step(wall, work)
            print(json.dumps({"load": "train", "rows": TRAIN_ROWS, "reduce_rows": reduce_rows,
                              "work": works, "wall_s": wall, "rows_planned": d.rows,
                              "regroup": d.regroup, "predicted_speedup": d.predicted_speedup,
                              "reason": d.reason}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
