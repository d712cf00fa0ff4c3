"""PyTorch port, what the training launcher stands on: the shape grid and
its cells, the parameter counts, `data.pipeline.build_for_arch`, the
elastic row counts (`launch.elastic.healthy_mesh` and its backoff) and
the planning mesh, each against the JAX package; then the launcher
(`python -m repro_torch.launch.train --smoke --device cpu`) end to end in
each step mode, and the training example, in subprocesses.

Tolerance: none; every comparison here is exact (counts, integer
batches, row counts, delays).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, run_multidevice
from repro import configs as jconfigs
from repro.data.pipeline import build_for_arch as j_build_for_arch
from repro.launch import mesh as jmesh
from repro_torch import configs
from repro_torch.data.pipeline import build_for_arch
from repro_torch.launch import elastic
from repro_torch.launch.mesh import make_host_mesh, required_devices

LAUNCH_STEPS = 4
MODES = ("conventional", "decoupled", "overlap")


def test_shape_grid_and_cells_match_the_reference():
    assert configs.SHAPES == {k: configs.ShapeCfg(v.name, v.seq_len, v.global_batch, v.kind)
                              for k, v in jconfigs.SHAPES.items()}
    ported = configs.ARCH_NAMES
    assert ported == tuple(a for a in jconfigs.ARCH_NAMES if a in ported)
    for skips in (False, True):
        want = [c for c in jconfigs.cells(include_skips=skips) if c[0] in configs.ARCH_NAMES]
        assert configs.cells(include_skips=skips) == want
    assert any(c[2] for c in configs.cells(include_skips=True))


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_counts_match_the_reference(name):
    for get, jget in ((configs.get, jconfigs.get), (configs.get_smoke, jconfigs.get_smoke)):
        assert get(name).param_count() == jget(name).param_count()
        assert get(name).active_param_count() == jget(name).active_param_count()


def test_unported_architectures_name_their_roadmap_item():
    """Every architecture of the reference is ported: the registry is the
    reference's, in its order, and `build_for_arch` takes a frontend
    (its batches carry the frontend embeddings after the tokens)."""
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in jconfigs.ARCH_NAMES:
        assert configs.get(name).name == jconfigs.get(name).name
    shape = configs.ShapeCfg("tiny", 16, 4, "train")
    cfg = dataclasses.replace(configs.get_smoke("qwen1.5-0.5b"), frontend="vision",
                              n_frontend_tokens=3)
    batch = build_for_arch(cfg, shape).global_batch(0)
    assert sorted(batch) == ["labels", "mask", "patches", "tokens"]
    assert tuple(batch["patches"].shape) == (4, 3, cfg.d_model)


@pytest.mark.parametrize("name,shape,skew", [("qwen1.5-0.5b", "train_4k", 0.0),
                                             ("mamba2-130m", "prefill_32k", 0.4)])
def test_build_for_arch_yields_the_reference_batches(name, shape, skew):
    port = build_for_arch(configs.get(name), configs.SHAPES[shape], seed=3, skew=skew)
    ref = j_build_for_arch(jconfigs.get(name), jconfigs.SHAPES[shape], seed=3, skew=skew)
    assert port.cfg.global_batch == ref.cfg.global_batch
    for step in (0, 1):
        got, want = port.global_batch(step), ref.global_batch(step)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_planning_mesh_and_production_device_count():
    mesh = make_host_mesh(4, device="cpu")  # model=2 by default, as the reference's
    assert mesh.n_rows == 4 and mesh.shape == {"data": 4, "model": 2} and not mesh.in_world
    for multi_pod in (False, True):
        assert required_devices(multi_pod=multi_pod) == jmesh.required_devices(
            multi_pod=multi_pod)


# (preferred shape, healthy devices) and (preferred shape, prober counts)
HEALTHY = [((8, 1), 8), ((8, 1), 7), ((8, 1), 3), ((4, 1), 1), ((6, 1), 5), ((8, 1), 5)]
BACKOFF = [((8, 1), [8]), ((8, 1), [5, 6, 8]), ((8, 1), [3, 3, 3, 3]), ((4, 1), [2, 4])]

JAX_ELASTIC = """
import json
from repro.launch.elastic import healthy_mesh, healthy_mesh_with_backoff
out = {{"healthy": [], "backoff": []}}
for shape, n in {healthy!r}:
    out["healthy"].append(healthy_mesh(tuple(shape), ("data", "model"), n_devices=n).shape["data"])
for shape, counts in {backoff!r}:
    it, slept, retries = iter(counts), [], []
    m = healthy_mesh_with_backoff(tuple(shape), ("data", "model"), prober=lambda: next(it),
                                  sleep=slept.append, on_retry=lambda a, d: retries.append([a, d]))
    out["backoff"].append([m.shape["data"], slept, retries])
print("RESULT", json.dumps(out))
"""


def test_healthy_row_counts_match_the_reference():
    stdout = run_multidevice(JAX_ELASTIC.format(healthy=HEALTHY, backoff=BACKOFF), n_devices=8,
                             timeout=300)
    want = json.loads(stdout.split("RESULT", 1)[1])
    got = [elastic.healthy_mesh(shape, ("data", "model"), n_devices=n, device="cpu").n_rows
           for shape, n in HEALTHY]
    assert got == want["healthy"]
    for (shape, counts), (rows, slept, retries) in zip(BACKOFF, want["backoff"]):
        it, my_slept, my_retries = iter(counts), [], []
        mesh = elastic.healthy_mesh_with_backoff(
            shape, ("data", "model"), prober=lambda: next(it), sleep=my_slept.append,
            on_retry=lambda a, d: my_retries.append([a, d]), device="cpu")
        assert (mesh.n_rows, my_slept, my_retries) == (rows, slept, retries)
    with pytest.raises(RuntimeError, match="not enough devices"):
        elastic.healthy_mesh((2, 2), n_devices=1, device="cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


def test_launcher_and_example_run_end_to_end(tmp_path):
    """`python -m repro_torch.launch.train --smoke --device cpu` in each
    step mode (4 rows, one column, 4 steps, all at once), once more for
    the MoE family (``--arch mixtral-8x7b``, conventional: its shards
    route as one global batch), and the training example on a (2, 2)
    world, each in a subprocess: exit 0, the launcher's last word, the
    committed checkpoint of the last step; a second launch, on the
    launcher's default model axis of 2 over 2 rows, resumes from the
    conventional run's files."""
    procs = {}
    runs = [(mode, "tinyllama-1.1b", mode) for mode in MODES] + [
        ("mixtral", "mixtral-8x7b", "conventional")]
    for name, arch, mode in runs:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
               "--device", "cpu", "--data", "4", "--model", "1", "--steps", str(LAUNCH_STEPS),
               "--seq", "32", "--batch", "8", "--mode", mode,
               "--ckpt-dir", str(tmp_path / name)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True, env=_env(), cwd=REPO)
    procs["example"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.train_lm", "--device", "cpu",
         "--data", "2", "--model", "2", "--steps", "3", "--layers", "2", "--d-model", "64",
         "--heads", "4", "--kv-heads", "2",
         "--seq", "32", "--batch", "8", "--vocab", "256", "--ckpt-dir", str(tmp_path / "example")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)
    outs = {k: p.communicate(timeout=240) for k, p in procs.items()}
    for name, p in procs.items():
        assert p.returncode == 0, (name, outs[name][1][-3000:])
    for name, _, _ in runs:
        lines = outs[name][0].strip().splitlines()
        assert lines[-1] == f"done at step {LAUNCH_STEPS}", lines
        step_dir = tmp_path / name / f"step_{LAUNCH_STEPS:08d}"
        assert (step_dir / "COMMIT").exists()
    assert "over 3 steps" in outs["example"][0]
    again = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                            "--device", "cpu", "--data", "2", "--steps", str(LAUNCH_STEPS),
                            "--seq", "32", "--batch", "8", "--mode", "overlap", "--ckpt-dir",
                            str(tmp_path / "conventional")],
                           capture_output=True, text=True, env=_env(), cwd=REPO, timeout=240)
    assert again.returncode == 0, again.stderr[-3000:]
    assert f"resumed from step {LAUNCH_STEPS}" in again.stdout
    assert again.stdout.strip().splitlines()[-1] == f"done at step {LAUNCH_STEPS}"
