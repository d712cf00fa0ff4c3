"""The fault-tolerant training loop (a port of the reference's
`train/trainer.py`).

Each rank of the world runs a `Trainer` over the same model, pipeline and
configs. In decoupled mode the global batch is laid out over the compute
rows (`Pipeline.padded_for_groups`); in conventional and overlap modes it
divides evenly over every row. Each rank takes its own row's shard. The
data is a pure function of (seed, step), so the loop keeps no pipeline
state and a resumed run sees the batches it would have seen.

Checkpoints (`io.checkpoint`): every ``ckpt_every`` steps and at the last
step, row 0 writes ``{"params", "opt", "step"}`` asynchronously; the
files hold whole moment trees whatever the mode (overlap mode gathers its
parts first), so any mode on any row count resumes from them
(`launch.elastic`). ``run(resume=True)`` restores the newest committed
step, which row 0 reads and every row takes from it. ``fail_at_step``
raises `SimulatedFailure` on every row at that step, after the last
write has committed.

Not ported yet: adaptive service sizing (``adapt``, ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from repro_torch.data.pipeline import Pipeline, row_shard
from repro_torch.io import checkpoint as ckpt
from repro_torch.train import sharding
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import TrainStepConfig, make_step
from repro_torch.utils.treeutil import tree_leaves, tree_meta


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    log_every: int = 10
    fail_at_step: int | None = None  # test hook: raise to simulate a crash
    adapt: object | None = None  # ROADMAP A9


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, model, mesh, pipeline: Pipeline, opt_cfg: OptConfig,
                 ts_cfg: TrainStepConfig, tr_cfg: TrainerConfig):
        if tr_cfg.adapt is not None:
            raise NotImplementedError("adaptive service sizing is not ported yet: "
                                      "ROADMAP A9 (core/adapt)")
        self.model = model
        self.mesh = mesh
        self.pipeline = pipeline
        self.opt_cfg = opt_cfg
        self.ts_cfg = ts_cfg
        self.cfg = tr_cfg
        self.checkpointer = ckpt.AsyncCheckpointer(tr_cfg.ckpt_dir, keep=tr_cfg.keep)
        self.metrics_log: list[dict] = []
        self.resumed: dict | None = None  # {"step", "restore_s"} of the last resume
        self.moment_bytes = 0  # the moments this row held while it stepped
        self.step_fn = None

    # -- state ---------------------------------------------------------------
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

    def _from_row0(self, value: int) -> int:
        """Row 0's ``value`` on every row."""
        if not self.mesh.in_world:
            return value
        return int(self.mesh.broadcast(torch.tensor([value], dtype=torch.int64), 0)[0])

    # -- the loop ------------------------------------------------------------
    def run(self, state: dict | None = None, resume: bool = True) -> dict:
        """Steps from ``state["step"]`` (or from the newest committed
        checkpoint, with ``resume``) to ``total_steps``. Updates the state
        in place and returns it, with whole moments in every mode. Logs
        loss and wall time every ``log_every`` steps and at the last (row
        0 prints them)."""
        state = self.init_state() if state is None else state
        if resume:
            last = ckpt.latest_step(self.cfg.ckpt_dir) if self.mesh.row == 0 else None
            last = self._from_row0(-1 if last is None else last)
            if last >= 0:
                t0 = time.perf_counter()
                state.update(self.restore(last, state))
                self.resumed = {"step": last, "restore_s": time.perf_counter() - t0}
                if self.mesh.row == 0:
                    print(f"[trainer] resumed from step {last}", flush=True)
        self.step_fn = make_step(self.model, self.mesh, self.opt_cfg, self.ts_cfg,
                                 inplace=True)
        params, opt, step = state["params"], state["opt"], state["step"]
        plan = None
        if self.ts_cfg.mode == "overlap":  # keep only this row's parts of the moments
            plan = sharding.zero1_plan(params, self.mesh.n_rows, self.mesh.row)
            opt = state["opt"] = sharding.shard_opt_state(plan, opt)
        self.moment_bytes = sum(t.numel() * t.element_size() for k in sharding.MOMENTS
                                if k in opt for t in tree_leaves(opt[k]))

        def whole(opt):
            return opt if plan is None else sharding.gather_opt_state(plan, self.mesh, opt)

        final_opt = None  # the last step's whole moments, when its save gathered them
        t0 = time.time()
        try:
            while step < self.cfg.total_steps:
                if self.cfg.fail_at_step is not None and step == self.cfg.fail_at_step:
                    raise SimulatedFailure(f"injected failure at step {step}")
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
                if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                    whole_opt = whole(opt)  # collective: every row gathers
                    if self.mesh.row == 0:
                        self.checkpointer.save(step, {"params": params, "opt": whole_opt,
                                                      "step": step})
                    if step == self.cfg.total_steps:
                        final_opt = whole_opt
                    del whole_opt
        finally:
            self.checkpointer.wait()
        self.mesh.barrier()  # every row returns after the last write committed
        state.update(params=params, opt=whole(opt) if final_opt is None else final_opt,
                     step=step)
        return state

    # -- checkpoint plumbing ---------------------------------------------------
    def restore(self, step: int, like_state: dict) -> dict:
        """The committed checkpoint of ``step`` on this model's device, in
        the structure of ``like_state``'s parameters with whole moments."""
        params = tree_meta(like_state["params"])
        like = {"params": params, "opt": init_opt_state(self.opt_cfg, params), "step": 0}
        return ckpt.restore(self.cfg.ckpt_dir, step, like, device=self.model.device)

    def close(self) -> None:
        self.checkpointer.close()


__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
