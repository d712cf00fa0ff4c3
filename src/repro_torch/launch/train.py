"""Training launcher (a port of the reference's `launch/train.py`).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --data 4 --mode decoupled
    python -m repro_torch.launch.train --smoke --device cpu --data 4 --steps 4 --ckpt-dir DIR

Spawns a world of ``--data`` rows (`launch.mesh.spawn`: one process per
row, every row on the one device ``--device`` names, the card by
default), and each row runs a `Trainer` in the chosen step mode over the
reference's data (Zipf tokens, skewed document lengths) with its
optimizer settings. ``--smoke`` picks the architecture's reduced config
and leaves the device as it is. The trainer saves a checkpoint halfway and
at the end into ``--ckpt-dir``, and resumes from the newest one there.
``--model`` must be 1: model-parallel training is not ported (ROADMAP A8).
"""
from __future__ import annotations

import argparse

from repro_torch.launch.mesh import make_host_mesh, spawn

# seconds the world may take, and any one collective in it
WORLD_TIMEOUT_S = 3600.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", help="the architecture's reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--decouple", default="reduce", choices=["none", "reduce"])
    ap.add_argument("--mode", default=None,
                    choices=[None, "conventional", "decoupled", "overlap"])
    ap.add_argument("--alpha", type=float, default=1 / 16)
    ap.add_argument("--compress", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_launch_train")
    ap.add_argument("--data", type=int, default=4, help="rows of the world")
    ap.add_argument("--model", type=int, default=1, help="must be 1 (ROADMAP A8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train_rank(mesh, args: argparse.Namespace) -> dict:
    """One row of the launcher's world: the step reached and the row's
    metrics log."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.model_zoo import build
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    model = build(cfg, device=mesh.device)
    mode = args.mode or ("decoupled" if args.decouple == "reduce" else "conventional")
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, kind="zipf", skew=0.4))
    trainer = Trainer(model, mesh, pipe,
                      OptConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps),
                      TrainStepConfig(mode=mode, reduce_alpha=args.alpha,
                                      compress=args.compress),
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=max(args.steps // 2, 1),
                                    ckpt_dir=args.ckpt_dir, log_every=10))
    try:
        state = trainer.run()
    finally:
        trainer.close()
    return {"step": state["step"], "log": trainer.metrics_log}


def main(argv=None) -> list[dict]:
    """Run the launcher's world; returns row 0's metrics log."""
    args = parse_args(argv)
    make_host_mesh(args.data, args.model, device="cpu")  # refuses a model axis
    ranks = spawn(train_rank, args.data, device=args.device, args=(args,),
                  timeout_s=WORLD_TIMEOUT_S)
    print(f"done at step {ranks[0]['step']}", flush=True)
    return ranks[0]["log"]


if __name__ == "__main__":
    main()
