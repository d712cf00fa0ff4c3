"""The model axis's f32 floor against one column, leaf by leaf: the cases of
tests/test_torch_model_axis.py (or those named on the command line) take
one SGD step (lr 1) on a (data 2, model 2) world of CPU ranks and on a
(2, 1) world, from the reference's initial parameters, and for each case
and mode this prints the largest difference over max |gradient|, the leaf
it lies in, the largest over the other leaves, and, for an MoE case, the
same with every MoE leaf whole on every column (`model_axis_worlds.moe_whole`)
and whether that step equals the split one bit for bit.

    PYTHONPATH=src python tests/model_axis_floor.py [label ...]

A measurement, not a test (~1 min for every case); its readings stand in
ROADMAP.md under C ("The MoE smoke configs' f32 floor").
"""
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def whole_case(mesh, inputs: str, ckpt: str, cases: list) -> dict:
    """`model_axis_worlds.model_axis_cases` with every case `moe_whole`."""
    from model_axis_worlds import model_axis_cases

    return model_axis_cases(mesh, inputs, ckpt, [dict(c, moe_whole=True) for c in cases])


def main(labels: list) -> None:
    import test_torch_model_axis as t
    import train_family_common as common
    from model_axis_worlds import DATA, MODEL, model_axis_cases, restore_case, run_tag
    from repro_torch.launch.mesh import spawn

    cases = [dict(c, adamw=False, fsdp=False, clip=False)
             for c in t.CASES if not labels or c["label"] in labels]
    moe = [c for c in cases if c.get("moe")]
    tmp = tempfile.mkdtemp(prefix="model_axis_floor_")
    try:
        inputs = os.path.join(tmp, "inputs.npz")
        p0 = {}
        for c in cases:
            p0.update(t._reference_p0(c))
        np.savez(inputs, **p0)
        split = spawn(model_axis_cases, DATA, model=MODEL, device="cpu",
                      args=(inputs, os.path.join(tmp, "split"), cases), timeout_s=900)
        whole = spawn(whole_case, DATA, model=MODEL, device="cpu",
                      args=(inputs, os.path.join(tmp, "whole"), moe),
                      timeout_s=900) if moe else None
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
        names = t._leaf_names(c)
        p0_leaves = t._case_leaves(p0, c, f"{c['label']}/p0/")
        for mode in c["modes"]:
            tag = f"{run_tag(c, False, mode)}/sgd/new/"
            ref = common.port_leaves(one, tag)
            gmax = common.max_diff(p0_leaves, ref)
            print(f"{c['label']} {mode}: {floor(split[0], tag, names, ref, gmax)}")
            if c.get("moe"):
                same = all(a.tobytes() == b.tobytes() for a, b in zip(
                    common.port_leaves(whole[0], tag), common.port_leaves(split[0], tag)))
                print(f"{c['label']} {mode}, the MoE whole: "
                      f"{floor(whole[0], tag, names, ref, gmax)}; bit for bit the split "
                      f"step: {same}")


if __name__ == "__main__":
    main(sys.argv[1:])
