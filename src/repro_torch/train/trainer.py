"""The fault-tolerant training loop (a port of the reference's
`train/trainer.py`).

Each rank of the world runs a `Trainer` over the same model, pipeline and
configs. In decoupled mode the global batch is laid out over the compute
rows (`Pipeline.padded_for_groups`); in conventional and overlap modes it
divides evenly over every row. Each rank takes its own row's shard. The
data is a pure function of (seed, step), so the loop keeps no pipeline
state and a resumed run sees the batches it would have seen.

Under FSDP (`train_step.fsdp_plan_for`: the config's ``fsdp``, by
default on where the f32 parameters pass ``fsdp_threshold``) each row
holds its parts of every unit's parameters and moments
(`train.sharding.FsdpPlan`), drawn unit by unit (`Model.init_unit`) or
taken from a whole state unit by unit, and `run` returns them so.

On a model axis (a world of more than one column; the model built with
``tp=mesh``) each rank holds its column's slices of the parameters and
moments (`train.sharding.param_specs`), drawn whole from the seed and
sliced, a unit at a time under FSDP.

Checkpoints (`io.checkpoint`): every ``ckpt_every`` steps and at the last
step, rank (0, 0) writes ``{"params", "opt", "step"}`` asynchronously; the
files hold whole trees, in the reference's names and shapes, whatever
the mode (ZeRO-1 overlap gathers its moment parts first; under FSDP the
rows gather one unit at a time and row 0 copies each to the host; on a
model axis row 0's columns gather each leaf, or unit, over it first), so
any mode on any (data, model) world, with or without FSDP, resumes from
them (`launch.elastic`). ``run(resume=True)``
restores the newest committed step, which row 0 reads and every row
takes from it. ``fail_at_step`` raises `SimulatedFailure` on every row at
that step, after the last write has committed.

Adaptive service sizing (``TrainerConfig.adapt``): in decoupled mode the
trainer closes the measure -> plan -> regroup loop of `core.adapt` around
the reduce (and analytics) groups. Each step's wall (the slowest row's,
agreed over the world) and the step's per-row token counts feed an
`AdaptiveGraph`; when the planner's hysteresis clears, the step is
rebuilt on the new partition. Parameters and moments are replicated on
the decoupled rows, or, under FSDP, held in parts of a plan that depends
on the row count alone, which a regroup keeps: nothing migrates, and the
rebuild is the regroup. The first sample after every (re)build is skipped
(`CompileGate`): the step updates in place, so it cannot be warmed. The
adaptive trainer on a model axis is not ported (ROADMAP A8), for any
family.
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from repro_torch.core.adapt import AdaptiveGraph, AdaptPolicy, CompileGate, agreed_wall
from repro_torch.data.pipeline import Pipeline, row_shard
from repro_torch.io import checkpoint as ckpt
from repro_torch.launch.elastic import restore_for_mesh
from repro_torch.train import sharding
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import (
    ANALYTICS,
    REDUCE,
    TrainStepConfig,
    check_model_axis,
    build_decoupled_step,
    fsdp_plan_for,
    make_step,
    param_shapes,
    train_service_graph,
    train_stage_traits,
)
from repro_torch.utils.treeutil import tree_leaves, tree_meta


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    log_every: int = 10
    fail_at_step: int | None = None  # test hook: raise to simulate a crash
    # closed-loop service re-sizing (decoupled mode only): an AdaptPolicy
    # switches it on; None keeps the static-alpha trainer
    adapt: AdaptPolicy | None = None


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, model, mesh, pipeline: Pipeline, opt_cfg: OptConfig,
                 ts_cfg: TrainStepConfig, tr_cfg: TrainerConfig):
        self.model = model
        self.mesh = mesh
        self.pipeline = pipeline
        self.opt_cfg = opt_cfg
        self.ts_cfg = ts_cfg
        self.cfg = tr_cfg
        self.checkpointer = ckpt.AsyncCheckpointer(tr_cfg.ckpt_dir, keep=tr_cfg.keep)
        self.metrics_log: list[dict] = []
        self.adapt_log: list[dict] = []  # regroup events of the adaptive loop
        self.adaptive_graph: AdaptiveGraph | None = None  # the last adaptive run's loop
        self.resumed: dict | None = None  # {"step", "restore_s"} of the last resume
        self.moment_bytes = 0  # the moments this row held while it stepped
        self.step_fn = None
        check_model_axis(model, mesh)
        if tr_cfg.adapt is not None and mesh.shape["model"] > 1:
            raise ValueError(f"the adaptive trainer on a model axis of {mesh.shape['model']} "
                             f"is not ported (ROADMAP A8)")
        self.fsdp = fsdp_plan_for(model, mesh, ts_cfg)  # this row's FsdpPlan, or None
        # the leaves' specs on a model axis (unit by unit under FSDP), else None
        self.specs = None
        if model.tp is not None:
            whole = param_shapes(model, whole=True)
            self.specs = model.specs(whole) if self.fsdp is None else [
                model.unit_specs(n, u) for n, u in sharding.units_of(whole)]

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict:
        """f32 parameters (the reference's master copies) and zero moments.
        Under FSDP, this row's parts, each unit drawn from its own
        generator (`Model.init_unit`), one at a time."""
        if self.fsdp is None:
            params = self.model.init(seed, param_dtype=torch.float32)
            return {"params": params, "opt": init_opt_state(self.opt_cfg, params), "step": 0}
        parts = self.fsdp.shard_units(
            lambda name: self.model.init_unit(seed, name, param_dtype=torch.float32))
        return {"params": parts, "opt": init_opt_state(self.opt_cfg, parts), "step": 0}

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

    def _regroup(self, rows: dict[str, int], graph):
        """Adopt the planner's row vector: the exact alphas, and the step
        rebuilt on ``graph`` (the regrouped partition). The new step keeps
        the old one's timings, so ``step_fn.timings`` covers every step."""
        n = self.mesh.shape["data"]
        updates = {"reduce_alpha": rows[REDUCE] / n}
        if ANALYTICS in rows:
            updates["analytics_alpha"] = rows[ANALYTICS] / n
        self.ts_cfg = dataclasses.replace(self.ts_cfg, **updates)
        step_fn = build_decoupled_step(self.model, self.opt_cfg, graph, self.ts_cfg, inplace=True,
                                       fsdp=self.fsdp)
        step_fn.timings[:0] = self.step_fn.timings
        return step_fn

    # -- the loop ------------------------------------------------------------
    def run(self, state: dict | None = None, resume: bool = True) -> dict:
        """Steps from ``state["step"]`` (or from the newest committed
        checkpoint, with ``resume``) to ``total_steps``. Updates the state
        in place and returns it, with whole moments in every mode but
        FSDP, which returns this row's parts of the parameters and moments
        (a whole ``state`` given is split into them, unit by unit). Logs
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
                if self.mesh.rank == 0:
                    print(f"[trainer] resumed from step {last}", flush=True)
        adaptive = self.cfg.adapt is not None and self.ts_cfg.mode == "decoupled"
        if adaptive:
            ag = self.adaptive_graph = AdaptiveGraph(train_service_graph(self.mesh, self.ts_cfg),
                                                     traits=train_stage_traits(self.ts_cfg),
                                                     policy=self.cfg.adapt)
            self.step_fn = build_decoupled_step(self.model, self.opt_cfg, ag.graph, self.ts_cfg,
                                                inplace=True, fsdp=self.fsdp)
        else:
            self.step_fn = make_step(self.model, self.mesh, self.opt_cfg, self.ts_cfg,
                                     inplace=True)
        # the first call of a (re)built step pays first-use costs and
        # updates in place, so it cannot be warmed: the gate skips its sample
        gate = CompileGate()
        params, opt, step = state["params"], state["opt"], state["step"]
        fsdp, plan = self.fsdp, None
        if fsdp is not None and isinstance(params, dict):  # a whole state: into parts
            params = state["params"] = fsdp.shard(params)
            opt = state["opt"] = fsdp.shard_opt_state(opt)
        elif fsdp is None and self.ts_cfg.mode == "overlap" and self.ts_cfg.zero1:
            plan = sharding.zero1_plan(params, self.mesh.n_rows, self.mesh.row)
            opt = state["opt"] = sharding.shard_opt_state(plan, opt)  # this row's moment parts
        self.moment_bytes = sum(t.numel() * t.element_size() for k in sharding.MOMENTS
                                if k in opt for t in tree_leaves(opt[k]))

        def whole(opt):
            return opt if plan is None else sharding.gather_opt_state(plan, self.mesh, opt)

        specs, keep = self.specs, self.mesh.row == 0 and self.mesh.col == 0

        def to_host(tree):
            """The whole tree of this rank's parts or column slices, on rank
            (0, 0) (collective: over the column's rows under FSDP, then over
            row 0's columns on a model axis)."""
            if fsdp is not None:
                return sharding.gather_to_host(fsdp, self.mesh, tree, keep, specs)
            if specs is not None:
                return sharding.model_to_host(tree, specs, self.mesh, keep)
            return tree

        def save(step: int, params, opt) -> dict | None:
            """Rank (0, 0) writes the whole state (collective where it
            gathers); the moments whole over the data rows, without FSDP."""
            whole_opt = opt if fsdp is not None else whole(opt)
            if fsdp is not None or self.mesh.row == 0:
                tree = {"params": to_host(params),
                        "opt": {k: to_host(v) if k in sharding.MOMENTS else v
                                for k, v in whole_opt.items()},
                        "step": step}
                if keep:
                    self.checkpointer.save(step, tree)
            return None if fsdp is not None else whole_opt

        final_opt = None  # the last step's whole moments, when its save gathered them
        t0 = time.time()
        try:
            while step < self.cfg.total_steps:
                if self.cfg.fail_at_step is not None and step == self.cfg.fail_at_step:
                    raise SimulatedFailure(f"injected failure at step {step}")
                batch = row_shard(self._batch_for(step), self.mesh.row, self.mesh.n_rows,
                                  self.model.device)
                t_step = time.perf_counter()
                params, opt, metrics = self.step_fn(params, opt, batch)
                step += 1
                if adaptive:
                    self.mesh.sync()
                    # the slowest row's wall: every rank plans on one sample
                    wall = agreed_wall(self.mesh, time.perf_counter() - t_step)
                    if gate.sample(wall):
                        compute_rows = self.mesh.shape["data"] - self._service_rows()
                        work = metrics["work_rows"].cpu().numpy()[:compute_rows]
                        decision = ag.step(wall, work)
                        if decision.regroup:
                            ag.apply(decision)  # collective: new process groups
                            self.step_fn = self._regroup(decision.rows, ag.graph)
                            gate.rebuilt()
                            event = {"step": step, "regroup": dict(decision.rows),
                                     "predicted_speedup": decision.predicted_speedup}
                            self.adapt_log.append(event)
                            if self.mesh.rank == 0:
                                print(f"[trainer] {json.dumps(event)}", flush=True)
                if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                    row = {"step": step, "loss": float(metrics["loss"]),
                           "wall_s": time.time() - t0}
                    self.metrics_log.append(row)
                    if self.mesh.rank == 0:
                        print(f"[trainer] {json.dumps(row)}", flush=True)
                if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                    whole_opt = save(step, params, opt)  # collective: every row gathers
                    if step == self.cfg.total_steps:
                        final_opt = whole_opt
                    del whole_opt
        finally:
            self.checkpointer.wait()
        self.mesh.barrier()  # every row returns after the last write committed
        if fsdp is None and final_opt is None:
            final_opt = whole(opt)
        state.update(params=params, opt=opt if fsdp is not None else final_opt, step=step)
        return state

    # -- checkpoint plumbing ---------------------------------------------------
    def restore(self, step: int, like_state: dict) -> dict:
        """The committed checkpoint of ``step`` on this model's device, in
        the structure of ``like_state``'s parameters with whole moments;
        on a model axis this column's slices of them, and under FSDP this
        row's parts (`launch.elastic.restore_for_mesh`), whatever world
        wrote the files."""
        if self.fsdp is not None or self.specs is not None:
            params = param_shapes(self.model, whole=True)
            like = {"params": params, "opt": init_opt_state(self.opt_cfg, params), "step": 0}
            return restore_for_mesh(self.cfg.ckpt_dir, step, like, self.mesh, self.fsdp,
                                    replicate_ssm=self.model.replicate_ssm)
        params = tree_meta(like_state["params"])
        like = {"params": params, "opt": init_opt_state(self.opt_cfg, params), "step": 0}
        return ckpt.restore(self.cfg.ckpt_dir, step, like, device=self.model.device)

    def close(self) -> None:
        self.checkpointer.close()


__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
