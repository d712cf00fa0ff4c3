"""PyTorch port, checkpoints (`repro_torch.io.checkpoint`): the six
behaviours of the reference's tests/test_checkpoint.py, the on-disk
format read across packages in both directions, and a host snapshot that
an in-place update after `save` cannot change. One process, on the CPU.

Tolerance: none. Every comparison is bit for bit (the files hold the
values themselves).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.io import checkpoint as jckpt
from repro_torch.io import checkpoint as ckpt
from repro_torch.utils.treeutil import tree_flatten, tree_map, tree_meta


@pytest.fixture
def tmpdir_ckpt(tmp_path):
    return str(tmp_path / "ckpts")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
                       "b": torch.zeros(4)},
            "step": 7}


def _mixed(seed=0):
    """A dict-of-dicts tree of f32, int32 and a scalar step, as numpy."""
    rng = np.random.default_rng(seed)
    return {"opt": {"m": rng.normal(size=(3, 5)).astype(np.float32),
                    "count": rng.integers(-9, 9, size=(6,)).astype(np.int32)},
            "params": {"embed": {"table": rng.normal(size=(7, 2)).astype(np.float32)},
                       "scale": np.array(rng.normal(), np.float32)},
            "step": 11}


def _leaves_as(fn, tree):
    """``tree`` with ``fn`` over its array leaves; the step stays an int."""
    return {**tree_map(fn, {k: v for k, v in tree.items() if k != "step"}),
            "step": tree["step"]}


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_roundtrip(tmpdir_ckpt):
    t = _tree()
    ckpt.save(tmpdir_ckpt, 7, t)
    assert ckpt.latest_step(tmpdir_ckpt) == 7
    out = ckpt.restore(tmpdir_ckpt, 7, t)
    assert torch.equal(out["params"]["w"], t["params"]["w"])
    assert out["step"] == 7 and isinstance(out["step"], int)


def test_torn_write_ignored(tmpdir_ckpt):
    t = _tree()
    ckpt.save(tmpdir_ckpt, 5, t)
    # a crash mid-write at step 10: a directory without COMMIT
    torn = os.path.join(tmpdir_ckpt, "step_00000010")
    os.makedirs(torn)
    with open(os.path.join(torn, "leaf_00000.npy"), "wb") as f:
        f.write(b"garbage")
    assert ckpt.latest_step(tmpdir_ckpt) == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmpdir_ckpt, 10, t)


def test_retention(tmpdir_ckpt):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmpdir_ckpt, s, t)
    ckpt.retain(tmpdir_ckpt, keep=2)
    kept = sorted(n for n in os.listdir(tmpdir_ckpt) if n.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]


def test_shape_mismatch_rejected(tmpdir_ckpt):
    ckpt.save(tmpdir_ckpt, 1, _tree())
    wrong = {"params": {"w": torch.zeros(9, 4), "b": torch.zeros(4)}, "step": 0}
    with pytest.raises(ValueError):
        ckpt.restore(tmpdir_ckpt, 1, wrong)


def test_async_checkpointer(tmpdir_ckpt):
    t = _tree()
    ac = ckpt.AsyncCheckpointer(tmpdir_ckpt, keep=2)
    for s in (10, 20, 30):
        ac.save(s, t)
    ac.close()
    assert ckpt.latest_step(tmpdir_ckpt) == 30
    kept = sorted(n for n in os.listdir(tmpdir_ckpt) if n.startswith("step_"))
    assert len(kept) == 2
    assert [e["step"] for e in ac.log] == [10, 20, 30]
    assert all(e["bytes"] == (32 + 4) * 4 + 8 and e["write_s"] > 0 for e in ac.log)
    with pytest.raises(RuntimeError):
        ac.save(40, t)


def test_restore_onto_another_device_and_placement(tmpdir_ckpt):
    """The same files restore into a shape-only tree (meta tensors) on a
    named device, and into a tree of other dtypes."""
    t = _tree()
    ckpt.save(tmpdir_ckpt, 3, t)
    out = ckpt.restore(tmpdir_ckpt, 3, {**t, "params": tree_meta(t["params"])}, device="cpu")
    assert out["params"]["w"].device.type == "cpu"
    assert torch.equal(out["params"]["w"], t["params"]["w"])
    other = {"w": torch.zeros(8, 4, dtype=torch.float64), "b": np.zeros(4, np.float32)}
    f64 = ckpt.restore(tmpdir_ckpt, 3, {**t, "params": other})
    assert f64["params"]["w"].dtype == torch.float64
    assert isinstance(f64["params"]["b"], np.ndarray)


def test_port_files_read_by_the_reference(tmpdir_ckpt):
    tree = _mixed()
    ckpt.save(tmpdir_ckpt, 11, _leaves_as(torch.from_numpy, tree))
    assert jckpt.latest_step(tmpdir_ckpt) == 11
    got = jckpt.restore_tree(tmpdir_ckpt, 11)
    flat_want, _ = tree_flatten(tree)
    flat_got, _ = tree_flatten(got)
    assert len(flat_got) == len(flat_want)
    assert all(_equal(a, b) for a, b in zip(flat_got[:-1], flat_want[:-1]))
    assert int(flat_got[-1]) == 11
    like = {"opt": {"m": jnp.zeros((3, 5)), "count": jnp.zeros((6,), jnp.int32)},
            "params": {"embed": {"table": jnp.zeros((7, 2))}, "scale": jnp.zeros(())},
            "step": 0}
    back = jckpt.restore(tmpdir_ckpt, 11, like)
    assert _equal(back["opt"]["count"], tree["opt"]["count"])
    assert _equal(back["params"]["embed"]["table"], tree["params"]["embed"]["table"])
    assert _equal(back["params"]["scale"], tree["params"]["scale"])
    assert int(back["step"]) == 11
    with open(os.path.join(tmpdir_ckpt, "step_00000011", "treedef.json")) as f:
        paths = json.load(f)["paths"]
    assert paths[0] == "['opt']['count']" and paths[-1] == "['step']"


def test_reference_files_read_by_the_port(tmpdir_ckpt):
    tree = _mixed(1)
    jckpt.save(tmpdir_ckpt, 4, _leaves_as(jnp.asarray, tree))
    assert ckpt.latest_step(tmpdir_ckpt) == 4
    got = ckpt.restore_tree(tmpdir_ckpt, 4)
    assert all(_equal(a, b) for a, b in zip(tree_flatten(got)[0][:-1],
                                             tree_flatten(tree)[0][:-1]))
    like = {"opt": {"m": torch.zeros(3, 5), "count": torch.zeros(6, dtype=torch.int32)},
            "params": {"embed": {"table": torch.zeros(7, 2)}, "scale": torch.zeros(())},
            "step": 0}
    back = ckpt.restore(tmpdir_ckpt, 4, like)
    assert _equal(back["opt"]["m"].numpy(), tree["opt"]["m"])
    assert _equal(back["opt"]["count"].numpy(), tree["opt"]["count"])
    assert _equal(back["params"]["scale"].numpy(), tree["params"]["scale"])
    assert back["step"] == tree["step"]


def test_snapshot_survives_an_in_place_update(tmpdir_ckpt):
    """`save` returns with a host copy: an update into the live tensors
    before the write runs must not reach the files."""
    t = _tree(2)
    before = t["params"]["w"].clone()
    ac = ckpt.AsyncCheckpointer(tmpdir_ckpt, keep=1)
    ac.save(1, t)
    t["params"]["w"].add_(1.0)
    ac.wait()
    out = ckpt.restore(tmpdir_ckpt, 1, t)
    assert torch.equal(out["params"]["w"], before)
    assert not torch.equal(out["params"]["w"], t["params"]["w"])
    ac.close()


def test_bf16_leaves_are_refused(tmpdir_ckpt):
    with pytest.raises(ValueError, match="bf16"):
        ckpt.save(tmpdir_ckpt, 1, {"w": torch.zeros(2, dtype=torch.bfloat16)})
