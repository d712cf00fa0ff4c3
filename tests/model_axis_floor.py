"""The model axis's f32 floor against one column, leaf by leaf: the cases of
tests/test_torch_model_axis.py and tests/test_torch_model_axis_families.py
(or those named on the command line) take one SGD step (lr 1) on a (data
2, model 2) world of CPU ranks and on a (2, 1) world, from the
reference's initial parameters, and for each case and mode this prints
the largest difference over max |gradient|, the leaf it lies in, the
largest over the other leaves, and, for an MoE case or one with Mamba
blocks, the same with every MoE (or Mamba) leaf whole on every column
(`model_axis_worlds.whole_leaves`) and whether that step equals the split
one bit for bit.

    PYTHONPATH=src python tests/model_axis_floor.py [label ...]

A measurement, not a test (~2 min for every case); its readings stand in
ROADMAP.md under C ("The model-axis smoke configs' f32 floor").
"""
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _block(case: dict) -> str | None:
    """The block a case's floor is also read with whole: ``moe`` or ``mamba``."""
    from model_axis_worlds import case_config

    cfg = case_config(case)
    return "moe" if cfg.n_experts else "mamba" if cfg.family == "ssm" or cfg.hybrid else None


def main(labels: list) -> None:
    import test_torch_model_axis as t
    import test_torch_model_axis_families as f
    import train_family_common as common
    from model_axis_common import case_leaves, leaf_names, reference_p0
    from model_axis_worlds import DATA, MODEL, model_axis_cases, restore_case, run_tag
    from repro_torch.launch.mesh import spawn

    cases = [dict(c, adamw=False, fsdp=False, clip=False, count_folds=False)
             for c in t.CASES + f.CASES if not labels or c["label"] in labels]
    blocks = [dict(c, whole=_block(c)) for c in cases if _block(c)]
    tmp = tempfile.mkdtemp(prefix="model_axis_floor_")
    try:
        inputs = os.path.join(tmp, "inputs.npz")
        p0 = {}
        for c in cases:
            p0.update(reference_p0(c))
        np.savez(inputs, **p0)
        split = spawn(model_axis_cases, DATA, model=MODEL, device="cpu",
                      args=(inputs, os.path.join(tmp, "split"), cases), timeout_s=900)
        whole = spawn(model_axis_cases, DATA, model=MODEL, device="cpu",
                      args=(inputs, os.path.join(tmp, "whole"), blocks),
                      timeout_s=900) if blocks else None
        one = spawn(restore_case, DATA, model=1, device="cpu", args=(inputs, tmp, [], cases),
                    timeout_s=900)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def floor(rank, tag, names, ref, gmax):
        rel = [(float(np.abs(a - b).max()) / gmax, n)
               for n, a, b in zip(names, common.port_leaves(rank, tag), ref)]
        worst = max(rel)
        rest = max(r for r, n in rel if n != worst[1])
        return f"{worst[0]:.4g} in {worst[1]}, the other leaves {rest:.4g}"

    for c in cases:
        names = leaf_names(c)
        p0_leaves = case_leaves(p0, c, f"{c['label']}/p0/")
        for mode in c["modes"]:
            tag = f"{run_tag(c, False, mode)}/sgd/new/"
            ref = common.port_leaves(one, tag)
            gmax = common.max_diff(p0_leaves, ref)
            print(f"{c['label']} {mode}: {floor(split[0], tag, names, ref, gmax)}")
            if _block(c):
                same = all(a.tobytes() == b.tobytes() for a, b in zip(
                    common.port_leaves(whole[0], tag), common.port_leaves(split[0], tag)))
                print(f"{c['label']} {mode}, the {_block(c)} block whole: "
                      f"{floor(whole[0], tag, names, ref, gmax)}; bit for bit the split "
                      f"step: {same}")


if __name__ == "__main__":
    main(sys.argv[1:])
