"""The chip smoke's rank pool (`chip_smoke.RankPool`) on the CPU: worlds of
different shapes, one after another, on the same processes, each a fresh
gloo process group through the port's rank entry (`launch.mesh._rank_main`);
a failing rank fails the call with its traceback, and `close` stops every
process."""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the pool's processes import the smoke by name

import chip_smoke  # noqa: E402


def world_sum(mesh, scale: float) -> dict:
    import torch

    total = mesh.all_reduce(torch.tensor([float(mesh.row + 1)]))
    return {"row": mesh.row, "col": mesh.col, "pid": os.getpid(),
            "sum": float(total[0]) * scale}


def failing_rank(mesh) -> dict:
    raise ValueError(f"rank fault on row {mesh.row}")


def test_rank_pool_runs_worlds_one_after_another_on_the_same_processes():
    pool = chip_smoke.RankPool(4, device="cpu")
    try:
        four = pool.run(world_sum, 4, args=(1.0,), timeout_s=120)
        assert [r["row"] for r in four] == [0, 1, 2, 3]
        assert [r["sum"] for r in four] == [10.0] * 4
        two = pool.run(world_sum, 2, args=(2.0,), timeout_s=120)
        assert [r["sum"] for r in two] == [6.0] * 2
        # a (data 2, model 2) world: the data-axis sum reaches the rows of
        # the rank's own column
        grid = pool.run(world_sum, 2, model=2, args=(1.0,), timeout_s=120)
        assert [(r["row"], r["col"]) for r in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert [r["sum"] for r in grid] == [3.0] * 4
        assert [r["pid"] for r in grid] == [r["pid"] for r in four]
        assert [r["pid"] for r in two] == [r["pid"] for r in four[:2]]
        with pytest.raises(RuntimeError, match="rank fault on row"):
            pool.run(failing_rank, 2, timeout_s=120)
    finally:
        pool.close()
    assert not any(p.is_alive() for p in pool.procs)


def read_flat_file(mesh, path: str) -> dict:
    import numpy as np

    waited = chip_smoke.wait_for_file(path, timeout_s=60)
    return {"row": mesh.row, "waited": waited, "flat": np.load(path).tolist()}


def test_a_world_started_before_its_file_reads_the_file_whole(tmp_path):
    """`RankPool.start` returns while the world runs: the parent writes a
    one-process file after the start (`write_units`, unit by unit, moved
    into place whole), each rank waits for it (`wait_for_file`) and reads
    every unit's leaves in order; `wait` then takes the results."""
    import numpy as np
    import torch

    params = {"embed": {"table": torch.arange(6.0).reshape(2, 3)},
              "layers": [{"w": torch.full((2,), 10.0)}, {"w": torch.full((2,), 20.0)}],
              "final_norm": {"scale": torch.tensor([7.0])}}
    path = str(tmp_path / "step.npy")
    pool = chip_smoke.RankPool(2, device="cpu")
    try:
        world = pool.start(read_flat_file, 2, args=(path,), timeout_s=120)
        assert not os.path.exists(path)
        chip_smoke.write_units(np, params, path)
        ranks = pool.wait(world)
    finally:
        pool.close()
    want = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 10.0, 10.0, 20.0, 20.0, 7.0]
    assert [r["row"] for r in ranks] == [0, 1]
    assert all(r["flat"] == want for r in ranks)
    assert not os.path.exists(path + ".part")
