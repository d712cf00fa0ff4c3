"""Training launcher (a port of the reference's `launch/train.py`).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --data 4 --mode decoupled
    python -m repro_torch.launch.train --smoke --device cpu --data 4 --steps 4 --ckpt-dir DIR

Spawns a (``--data``, ``--model``) world (`launch.mesh.spawn`: one process
per rank, every rank on the one device ``--device`` names, the card by
default), and each rank runs a `Trainer` in the chosen step mode over the
reference's data (Zipf tokens, skewed document lengths; the frontend
embeddings of an audio or vision architecture) with its optimizer
settings. ``--arch`` takes every architecture of the registry: dense,
MoE, SSM, hybrid, VLM and encoder-decoder. ``--smoke`` picks the
architecture's reduced config and leaves the device as it is. The
trainer saves a checkpoint halfway and at the end into ``--ckpt-dir``,
and resumes from the newest one there. The step config is the
reference's default apart from the mode, the alpha and the codec, so
FSDP is ``"auto"``: on where the f32 parameters over ``--model`` pass
6e9 bytes (``--arch qwen2.5-3b --data 2 --model 1`` and ``--data 2
--model 2`` train so), as in the reference, which has no flag for it
either.

``--model`` defaults to 2, as the reference's does: tensor parallelism
over a model axis of that many columns, for every family: dense
(tinyllama-1.1b, qwen1.5-0.5b, qwen2.5-3b, starcoder2-15b), MoE
(mixtral-8x7b, llama4-scout-17b-a16e: expert parallelism where the
experts divide the axis, else each expert's ff split), SSM (mamba2-130m)
and hybrid (hymba-1.5b: a Mamba block's projections split,
`models.ssm.mamba_block`), VLM (pixtral-12b) and encoder-decoder
(whisper-small: its three attentions split, `models.encdec`). The
reference's ``REPRO_REPLICATE_SSM=1`` is ``build(cfg, tp=mesh,
replicate_ssm=True)`` here, with no flag, as the reference has none. One
80 GB card holds, at 16 bytes a parameter for f32 weights and AdamW
moments (less under FSDP): mamba2-130m, whisper-small, tinyllama-1.1b
and qwen1.5-0.5b on (4, 2); hymba-1.5b on (2, 2); qwen2.5-3b on (2, 2)
under FSDP; mixtral-8x7b at cut depth (one layer, 1.71e9 parameters, on
(2, 2) under FSDP); llama4-scout-17b-a16e at no depth (one layer at full
width is ~4.3e9 parameters, 68.3 GB with its moments); pixtral-12b (~198
GB of state) and starcoder2-15b (242 GB) at cut depth only.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.mesh import spawn

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
    ap.add_argument("--data", type=int, default=4, help="data rows of the world")
    ap.add_argument("--model", type=int, default=2,
                    help="model-axis columns of the world (tensor parallelism, every family)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config(args: argparse.Namespace):
    from repro_torch.configs import get, get_smoke

    return get_smoke(args.arch) if args.smoke else get(args.arch)


def train_rank(mesh, args: argparse.Namespace) -> dict:
    """One rank of the launcher's world: the step reached and the rank's
    metrics log."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.model_zoo import build
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = config(args)
    model = build(cfg, device=mesh.device, tp=mesh)
    mode = args.mode or ("decoupled" if args.decouple == "reduce" else "conventional")
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, kind="zipf", skew=0.4,
                               frontend=cfg.frontend,
                               n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model))
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
    """Run the launcher's world; returns rank 0's metrics log."""
    args = parse_args(argv)
    ranks = spawn(train_rank, args.data, model=args.model, device=args.device, args=(args,),
                  timeout_s=WORLD_TIMEOUT_S)
    print(f"done at step {ranks[0]['step']}", flush=True)
    return ranks[0]["log"]


if __name__ == "__main__":
    main()
