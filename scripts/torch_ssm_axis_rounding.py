"""How far mamba2-130m's f32 gradient moves under another summation order,
at full width on the CPU: one forward and backward of the loss (Zipf
tokens, seed 0) from the same weights,

  * on a (data 1, model 2) world against one process: the default split
    (`models.ssm.mamba_block(tp=)`: out_proj row-parallel, its two
    columns' partial products summed), and with every Mamba leaf whole
    on every column (out_proj whole too);
  * in one process, with out_proj computed as two half products summed
    (the row-parallel sum's order, no model axis);

each as the largest difference over max |gradient| and the leaf it lies
in, then the next three leaves.

    PYTHONPATH=src python scripts/torch_ssm_axis_rounding.py [--layers 24] [--seq 256]

~3 min on 8 CPU threads at the defaults.
"""
import argparse
import dataclasses

import numpy as np
import torch


def _config(layers: int):
    from repro_torch.configs import get

    return dataclasses.replace(get("mamba2-130m"), dtype=torch.float32, n_layers=layers)


def _batch(cfg, seq: int) -> dict:
    from repro_torch.data.pipeline import DataConfig, Pipeline

    return Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=2, seed=0,
                               kind="zipf", skew=0.4)).global_batch(0)


def _grads(model, params, batch) -> list:
    from repro_torch.utils.treeutil import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    model.loss(tree_unflatten(treedef, leaves), batch)[0].backward()
    return [t.grad for t in leaves]


def rank_grads(mesh, layers: int, seq: int, whole_mamba: bool) -> list:
    """This rank's gradient of the whole tree (gathered over the row)."""
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.train_step import param_shapes
    from repro_torch.utils.treeutil import tree_flatten

    torch.set_num_threads(4)
    if whole_mamba:
        spec_for_leaf = sharding.spec_for_leaf

        def whole(names, shape, model_size, **kw):
            spec = spec_for_leaf(names, shape, model_size, **kw)
            return (None,) * len(spec) if "mamba" in names else spec

        sharding.spec_for_leaf = whole
    cfg = _config(layers)
    model = build(cfg, device="cpu", tp=mesh)
    grads = _grads(model, model.init(0, param_dtype=torch.float32), _batch(cfg, seq))
    if model.tp is not None:
        treedef = tree_flatten(param_shapes(model))[1]
        grads = tree_flatten(sharding.gather_model(
            sharding.tree_unflatten(treedef, grads),
            model.specs(param_shapes(model, whole=True)), mesh))[0]
    return [g.numpy() for g in grads]


def halves_grads(layers: int, seq: int) -> list:
    """One process, out_proj as the sum of its two row halves' products."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.models.model_zoo import build

    def gate_out(p, y, z, cfg, dtype, tp=None):
        y = L.apply_norm(p["norm"], y, "rms", cfg.norm_eps)
        y = (y * F.silu(z.float()).to(y.dtype)).to(dtype)
        w = p["out_proj"]["w"].to(dtype)
        h = w.shape[0] // 2
        return y[..., :h] @ w[:h] + y[..., h:] @ w[h:]

    cfg = _config(layers)
    model = build(cfg, device="cpu")
    plain, ssm._gate_out = ssm._gate_out, gate_out
    try:
        return [g.numpy() for g in _grads(model, model.init(0, param_dtype=torch.float32),
                                          _batch(cfg, seq))]
    finally:
        ssm._gate_out = plain


def main() -> None:
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.train_step import param_shapes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    torch.set_num_threads(8)
    one = spawn(rank_grads, 1, model=1, device="cpu", args=(args.layers, args.seq, False))[0]
    names = [".".join(n) for n, _ in sharding._leaf_paths(
        param_shapes(build(_config(args.layers), device="meta")))]
    gmax = max(float(np.abs(g).max()) for g in one)

    def report(what: str, got: list) -> None:
        rel = sorted(((float(np.abs(a - b).max()) / gmax, n)
                      for n, a, b in zip(names, got, one)), reverse=True)
        print(f"{what}: {rel[0][0]:.4g} in {rel[0][1]}; then "
              + ", ".join(f"{r:.3g} {n}" for r, n in rel[1:4]), flush=True)

    print(f"mamba2-130m, {args.layers} layers, 2 x {args.seq} tokens, f32, max |g| {gmax:.6g}")
    for whole in (False, True):
        two = spawn(rank_grads, 1, model=2, device="cpu",
                    args=(args.layers, args.seq, whole))[0]
        report("(1, 2) " + ("with the Mamba leaves whole" if whole else "split"), two)
    report("one process, out_proj as two half products", halves_grads(args.layers, args.seq))


if __name__ == "__main__":
    main()
