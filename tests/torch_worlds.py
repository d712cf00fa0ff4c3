"""World functions of the port's multi-rank tests: each runs in every
rank of a `repro_torch.launch.mesh.spawn` world on the CPU and returns
numpy results. This module imports no JAX (the ranks load only the
port); the test files hold the results against the JAX package.

Inputs come from an ``.npz`` the test writes, so both packages fold the
same numbers.
"""
import dataclasses

import numpy as np
import torch

N_ROWS = 8
ALPHA = 0.25  # 6 compute rows, 2 reduce rows: 3 waves
# (name, chunk_bytes, codec, wave_fold, generic combine)
TREE_VARIANTS = [("whole", None, c, None, False) for c in ("identity", "bf16", "int8")] + [
    (f"chunked_{f}", 64, c, f, False) for f in ("kernel", "add", "scan")
    for c in ("identity", "bf16", "int8")] + [
    ("whole_max", None, "identity", None, True), ("chunked_max", 64, "identity", None, True)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def channel_cases(mesh, inputs_path: str) -> dict:
    from repro_torch.core.channel import make_channel
    from repro_torch.core.decouple import (
        conventional_allreduce,
        group_pmax,
        group_psum,
        stream_reduce,
        stream_reduce_and_return,
    )
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.utils.treeutil import tree_map

    inp = dict(np.load(inputs_path))
    r = mesh.row
    gm = GroupedMesh.build(mesh, services={"reduce": ALPHA})
    ch = make_channel(gm, "reduce")
    x = torch.from_numpy(inp["x"][r])
    out = {}

    def op(acc, elem, k):
        acc[k] += elem * (k + 1)
        return acc

    out["fold"] = ch.stream_fold(x, op, torch.zeros_like(x))
    out["fold_count"] = ch.stream_fold(x, op, torch.zeros_like(x),
                                       count=torch.tensor(int(inp["count"][r])))
    out["fold_int8"] = ch.stream_fold(x, op, torch.zeros_like(x), codec="int8")
    out["reduce"] = stream_reduce(x, ch)
    out["reduce_return"] = stream_reduce_and_return(x, ch, transform=lambda v: v * 2.0)
    out["psum_reduce"] = group_psum(x, gm, "reduce")
    out["pmax_compute"] = group_pmax(x, gm, "compute")
    out["allreduce"] = conventional_allreduce(x, gm)

    payload = {"a": torch.from_numpy(inp["a"][r]), "b": torch.from_numpy(inp["b"][r]),
               "c": torch.from_numpy(inp["c"][r]).to(torch.bfloat16)}

    def max_combine(acc, new, ok):
        return tree_map(torch.maximum, acc, new) if ok else acc

    for name, chunk_bytes, codec, wave_fold, generic in TREE_VARIANTS:
        got = ch.stream_fold_tree(payload, codec=codec, chunk_bytes=chunk_bytes,
                                  wave_fold=wave_fold,
                                  combine=max_combine if generic else None)
        for k, v in got.items():
            out[f"tree_{name}_{codec}_{k}"] = v
    return {k: _np(v) for k, v in out.items()}


def train_cases(mesh, inputs_path: str) -> dict:
    """The decoupled step (with and without the analytics chain, and with
    the int8 wire) on the reference's parameters, the port's conventional
    step on the global batch and on compute row 1's shard alone, and a
    3-step `Trainer` run; f32 tinyllama smoke config."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (
        TrainStepConfig,
        build_conventional_step,
        make_step,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.treeutil import tree_flatten

    inp = dict(np.load(inputs_path))
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    model = build(cfg, device="cpu")
    params = params_from_numpy(unflatten_params(inp, "p0/"), cfg, "cpu",
                               param_dtype=torch.float32)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    batch = {k: torch.from_numpy(inp["batch/" + k]) for k in ("tokens", "labels", "mask")}
    out = {}

    def flat(tree, prefix):
        leaves, _ = tree_flatten(tree)
        out.update({f"{prefix}{i}": _np(v) for i, v in enumerate(leaves)})

    for name, analytics, compress in (("decoupled", 0.0, "none"), ("analytics", 0.125, "none"),
                                      ("int8", 0.0, "int8")):
        ts = TrainStepConfig(mode="decoupled", reduce_alpha=ALPHA, analytics_alpha=analytics,
                             compress=compress, wire_chunk_bytes=65536)
        step = make_step(model, mesh, sgd, ts)
        new, _, metrics = step(params, init_opt_state(sgd, params),
                               row_shard(batch, mesh.row, N_ROWS))
        flat(new, f"{name}/new/")
        for k in ("loss", "grad_norm", "grad_absmax"):
            if k in metrics:
                out[f"{name}/metric/{k}"] = np.float32(metrics[k])
        out[f"{name}/work_rows"] = metrics["work_rows"].numpy()
    conv = build_conventional_step(model, sgd)
    new, _, metrics = conv(params, init_opt_state(sgd, params), batch)
    flat(new, "conventional/new/")
    out["conventional/metric/loss"] = np.float32(metrics["loss"])
    # compute row 1's shard alone: its share of the gradient, the fault
    # the int8-wire test must tell from quantisation error
    shard = row_shard(batch, 1, N_ROWS)
    new, _, _ = conv(params, init_opt_state(sgd, params), shard)
    flat(new, "row1/new/")
    out["row1/share"] = np.float32(shard["mask"].sum() / batch["mask"].sum())

    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=6,
                               kind="zipf", skew=0.4))
    adamw = OptConfig(lr=1e-3, warmup_steps=10, total_steps=3)
    trainer = Trainer(model, mesh, pipe, adamw,
                      TrainStepConfig(mode="decoupled", reduce_alpha=ALPHA,
                                      wire_chunk_bytes=65536),
                      TrainerConfig(total_steps=3, log_every=1))
    state = {"params": params, "opt": init_opt_state(adamw, params), "step": 0}
    trainer.run(state)
    out["trainer/loss"] = np.array([row["loss"] for row in trainer.metrics_log], np.float64)
    return out


def unflatten_params(inp: dict, prefix: str) -> dict:
    """The reference's parameter tree from ``prefix``-keyed npz entries
    ("p0/layers/attn/wq/w" -> nested dicts)."""
    tree: dict = {}
    for key, v in inp.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def cuda_fold_case(mesh) -> dict:
    """A two-row world on the card: row 0 streams a ragged f32 payload to
    row 1 in wire chunks, which folds the wave with the chunk_accumulate
    kernel (the CUDA default) and with the in-scan add."""
    from repro_torch.core.channel import make_channel
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.kernels.stream_reduce import chunk_accumulate_kernel

    gm = GroupedMesh.build(mesh, services={"reduce": 0.5})
    ch = make_channel(gm, "reduce", chunk_bytes=1 << 20)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    payload = {"w": torch.randn((1000, 777), generator=gen, device=mesh.device),
               "b": torch.randn((333,), generator=gen, device=mesh.device)}
    before = chunk_accumulate_kernel.launches
    kernel = ch.stream_fold_tree(payload)
    launches = chunk_accumulate_kernel.launches - before
    scan = ch.stream_fold_tree(payload, wave_fold="scan")
    torch.cuda.synchronize()
    return {"launches": launches, "kernel": {k: v.cpu().numpy() for k, v in kernel.items()},
            "scan": {k: v.cpu().numpy() for k, v in scan.items()},
            "payload": {k: v.cpu().numpy() for k, v in payload.items()},
            "stats": mesh.stats.as_dict()}
