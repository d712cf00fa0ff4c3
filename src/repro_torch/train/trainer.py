"""The training loop (a port of the loop of the reference's
`train/trainer.py`).

Each rank of the world runs a `Trainer` over the same model, pipeline and
configs; in decoupled mode the global batch is laid out over the compute
rows (`Pipeline.padded_for_groups`) and each rank takes its own row's
shard. The data is a pure function of (seed, step), so the loop keeps no
pipeline state.

Not ported yet, and refused rather than skipped: checkpointing and
resume (`ckpt_every`, `ckpt_dir`, ``run(resume=True)``) and the
crash-injection hook that tests them (`fail_at_step`) come with
io/checkpoint (ROADMAP A7); adaptive service sizing (`adapt`) comes with
core/adapt (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from repro_torch.data.pipeline import Pipeline, row_shard
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import TrainStepConfig, make_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int | None = None  # ROADMAP A7
    ckpt_dir: str | None = None  # ROADMAP A7
    fail_at_step: int | None = None  # ROADMAP A7 (crash-and-resume test hook)
    adapt: object | None = None  # ROADMAP A9


class Trainer:
    def __init__(self, model, mesh, pipeline: Pipeline, opt_cfg: OptConfig,
                 ts_cfg: TrainStepConfig, tr_cfg: TrainerConfig):
        if tr_cfg.ckpt_every is not None or tr_cfg.ckpt_dir is not None:
            raise NotImplementedError("checkpointing is not ported yet: ROADMAP A7 "
                                      "(io/checkpoint)")
        if tr_cfg.fail_at_step is not None:
            raise NotImplementedError("fail_at_step tests checkpoint restart, which is not "
                                      "ported yet: ROADMAP A7")
        if tr_cfg.adapt is not None:
            raise NotImplementedError("adaptive service sizing is not ported yet: "
                                      "ROADMAP A9 (core/adapt)")
        self.model = model
        self.mesh = mesh
        self.pipeline = pipeline
        self.opt_cfg = opt_cfg
        self.ts_cfg = ts_cfg
        self.cfg = tr_cfg
        self.metrics_log: list[dict] = []
        self.step_fn = None

    def init_state(self, seed: int = 0) -> dict:
        """f32 parameters (the reference's master copies) and zero moments."""
        params = self.model.init(seed, param_dtype=torch.float32)
        return {"params": params, "opt": init_opt_state(self.opt_cfg, params), "step": 0}

    def _service_rows(self) -> int:
        rows = self.mesh.shape["data"]
        service = max(1, int(round(self.ts_cfg.reduce_alpha * rows)))
        if self.ts_cfg.analytics_alpha > 0:
            service += max(1, int(round(self.ts_cfg.analytics_alpha * rows)))
        return service

    def _batch_for(self, step: int) -> dict:
        """The global batch of ``step``, as the step's rows take it."""
        if self.ts_cfg.mode == "decoupled":
            rows = self.mesh.shape["data"]
            return self.pipeline.padded_for_groups(step, rows - self._service_rows(), rows)
        return self.pipeline.global_batch(step)

    def run(self, state: dict | None = None, resume: bool = False) -> dict:
        """Steps from ``state["step"]`` to ``total_steps``; updates the
        state in place and returns it. Logs loss and wall time every
        ``log_every`` steps and at the last (row 0 prints them)."""
        if resume:
            raise NotImplementedError("resume needs checkpoints: ROADMAP A7")
        state = self.init_state() if state is None else state
        self.step_fn = make_step(self.model, self.mesh, self.opt_cfg, self.ts_cfg,
                                 inplace=True)
        params, opt, step = state["params"], state["opt"], state["step"]
        t0 = time.time()
        while step < self.cfg.total_steps:
            batch = row_shard(self._batch_for(step), self.mesh.row, self.mesh.n_rows,
                              self.model.device)
            params, opt, metrics = self.step_fn(params, opt, batch)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                row = {"step": step, "loss": float(metrics["loss"]),
                       "wall_s": time.time() - t0}
                self.metrics_log.append(row)
                if self.mesh.row == 0:
                    print(f"[trainer] {json.dumps(row)}", flush=True)
        state.update(params=params, opt=opt, step=step)
        return state


__all__ = ["Trainer", "TrainerConfig"]
