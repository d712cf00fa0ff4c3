"""End-to-end training example on the port: a decoder LM trained with the
decoupled gradient reduction (the paper's technique as a training
feature), fault-tolerant checkpoints included; the counterpart of the
reference's `examples/train_lm.py`.

    python -m repro_torch.examples.train_lm [--device cpu] [--mode conventional]

Defaults are small (a ~10M-parameter llama-style model, 120 steps) in a
world of 4 rows on the card unless ``--device`` names another device.
The reference's ~100M run:

    python -m repro_torch.examples.train_lm --d-model 512 --layers 12 \\
        --seq 1024 --steps 300 --vocab 32000
"""
from __future__ import annotations

import argparse
import shutil

from repro_torch.launch.mesh import spawn
from repro_torch.launch.train import WORLD_TIMEOUT_S

N_ROWS = 4


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=192)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--mode", default="decoupled",
                    choices=["conventional", "decoupled", "overlap"])
    ap.add_argument("--compress", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_lm")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def arch(args: argparse.Namespace):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="examples-lm", family="dense", n_layers=args.layers,
                      d_model=args.d_model, n_heads=args.heads, n_kv_heads=args.kv_heads,
                      d_ff=args.d_model * 3, vocab_size=args.vocab)


def train_rank(mesh, args: argparse.Namespace) -> list[dict]:
    """One row: the trainer's metrics log."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.model_zoo import build
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = build(arch(args), device=mesh.device)
    pipe = Pipeline(DataConfig(vocab_size=args.vocab, seq_len=args.seq,
                               global_batch=args.batch, kind="zipf",
                               skew=0.4))  # imbalanced documents: what decoupling absorbs
    trainer = Trainer(model, mesh, pipe,
                      OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
                      TrainStepConfig(mode=args.mode, reduce_alpha=0.25,
                                      compress=args.compress),
                      TrainerConfig(total_steps=args.steps, ckpt_every=50,
                                    ckpt_dir=args.ckpt_dir, log_every=20))
    try:
        trainer.run()
    finally:
        trainer.close()
    return trainer.metrics_log


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    print(f"model: {arch(args).param_count() / 1e6:.1f}M params, mode={args.mode}")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    log = spawn(train_rank, N_ROWS, device=args.device, args=(args,),
                timeout_s=WORLD_TIMEOUT_S)[0]
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {log[-1]['step']} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return log


if __name__ == "__main__":
    main()
