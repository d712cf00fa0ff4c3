"""PyTorch port, the channel wire: `WirePacker` and the identity, bf16
and int8 codecs against the JAX package's `core/wire.py`, on the same
numpy payloads on the CPU.

Tolerances: packing, unpacking, identity and bf16 are exact (bit copies
and one round-to-nearest-even); int8 is held within one quantisation
step per element (scales to 1e-6 relative): the reference under `jit`
may divide by 127 as a multiplication by its reciprocal, one ulp off the
quotient, which moves a value on a rounding edge by one step (ROADMAP C,
`kv_quantize`).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro_torch.core import wire
from repro_torch.utils.convert import tensor_from_numpy
from repro_torch.utils.treeutil import tree_leaves, tree_meta


def _payload(seed=0):
    """Mixed dtypes and ragged sizes: f32, int32, bf16, bool leaves."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(37, 5)).astype(np.float32),
            "ids": rng.integers(-50, 50, size=(11,)).astype(np.int32),
            "kv": rng.normal(size=(3, 7)).astype(ml_dtypes.bfloat16),
            "b": (rng.normal(size=(13,)) * 100).astype(np.float32),
            "ok": rng.integers(0, 2, size=(4,)).astype(bool)}


def _torch(tree):
    return {k: tensor_from_numpy(v, "cpu") for k, v in tree.items()}


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("chunk_bytes", [64, 100, 4096])
def test_packer_matches_jax(chunk_bytes):
    p = _payload()
    jp = jwire.WirePacker.plan(jax.tree.map(jnp.asarray, p), chunk_bytes)
    tp = wire.WirePacker.plan(_torch(p), chunk_bytes)
    assert [(g.leaf_idx, g.total, g.chunk_elems, g.n_chunks) for g in tp.groups] == \
        [(g.leaf_idx, g.total, g.chunk_elems, g.n_chunks) for g in jp.groups]
    assert tp.raw_bytes() == jp.raw_bytes()
    for codec in ("identity", "bf16", "int8"):
        assert tp.encoded_bytes(codec) == jp.encoded_bytes(codec)
    jbufs = jp.pack(jax.tree.map(jnp.asarray, p))
    tbufs = tp.pack(_torch(p))
    for g, jb, tb in zip(tp.groups, jbufs, tbufs):
        np.testing.assert_array_equal(_np(tb).view(np.uint8), np.asarray(jb).view(np.uint8))
        assert not tb.reshape(-1)[g.total:].any()  # the ragged tail is zero padding
    back = tp.unpack(tbufs)
    for k, v in p.items():
        assert back[k].dtype == _torch(p)[k].dtype
        np.testing.assert_array_equal(_np(back[k]), v)
    for z, tb in zip(tp.zeros(), tbufs):
        assert z.shape == tb.shape and z.dtype == tb.dtype and not z.any()


def test_packer_plans_from_meta_tensors():
    p = _torch(_payload())
    meta = tree_meta(p)
    assert wire.WirePacker.plan(meta, 64) == wire.WirePacker.plan(p, 64)


@pytest.mark.parametrize("codec", ["identity", "bf16", "int8"])
def test_codecs_match_jax(codec):
    rng = np.random.default_rng(3)
    buf = (rng.normal(size=(5, 64)) * rng.uniform(0.01, 10, size=(5, 1))).astype(np.float32)
    jc, tc = jwire.get_codec(codec), wire.get_codec(codec)
    assert tc.name == jc.name and tc.applies(torch.float32) == jc.applies(jnp.float32)
    assert tc.applies(torch.int32) == jc.applies(jnp.int32) is False
    jw = jc.encode_chunks(jnp.asarray(buf))
    tw = tc.encode_chunks(torch.from_numpy(buf))
    jd = np.asarray(jc.decode_chunk(jw))
    td = tc.decode_chunk(tw).numpy()
    jl = np.asarray(jc.decode_leaf(jc.encode_leaf(jnp.asarray(buf))))
    tl = tc.decode_leaf(tc.encode_leaf(torch.from_numpy(buf))).numpy()
    if codec != "int8":
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        return
    np.testing.assert_allclose(tw["scale"].numpy(), np.asarray(jw["scale"]), rtol=1e-6)
    assert np.abs(tw["q"].numpy().astype(int) - np.asarray(jw["q"]).astype(int)).max() <= 1
    step = np.asarray(jw["scale"])  # one quantisation step per chunk
    assert (np.abs(td - jd) <= step * (1 + 1e-6)).all()
    assert (np.abs(tl - jl) <= float(jc.encode_leaf(jnp.asarray(buf))["scale"]) * (1 + 1e-6)).all()
    assert wire.is_int8_payload(tw) and tw["q"].dtype == torch.int8


def test_tree_codec_passes_integers_and_rounds_once():
    p = _torch(_payload())
    for name in ("bf16", "int8"):
        c = wire.get_codec(name)
        back = c.decode_tree(c.encode_tree(p))
        assert torch.equal(back["ids"], p["ids"]) and torch.equal(back["ok"], p["ok"])
        assert back["w"].dtype == torch.float32
    assert wire.WireSpec.of("int8") == wire.WireSpec(codec="int8")
    assert wire.WireSpec.of(None) == wire.WireSpec()
    with pytest.raises(KeyError, match="unknown codec"):
        wire.get_codec("zstd")
    assert len(tree_leaves(wire.get_codec("int8").encode_tree(p))) == 5 + 3  # q and scale


def test_treeutil_flatten_matches_jax():
    from repro.utils import treeutil as jtree
    from repro_torch.utils import treeutil

    p = {k: v for k, v in _payload(5).items() if k != "ok"}
    jp, tp = jax.tree.map(jnp.asarray, p), _torch(p)
    jspec, tspec = jtree.spec_of(jp), treeutil.spec_of(tp)
    assert tspec.shapes == jspec.shapes and tspec.sizes == jspec.sizes
    assert tspec.total == jspec.total
    flat = treeutil.flatten(tp)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jtree.flatten(jp)))
    padded = treeutil.pad_to_multiple(flat, 16)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jtree.pad_to_multiple(
        jtree.flatten(jp), 16)))
    assert treeutil.num_chunks(tspec.total, 16) == jtree.num_chunks(jspec.total, 16)
    back = treeutil.unflatten(tspec, padded)
    for k, v in p.items():
        assert back[k].dtype == tp[k].dtype
        np.testing.assert_array_equal(_np(back[k]), v)


def test_tree_utilities_free_their_leaves_without_the_collector():
    """No reference cycle keeps a flattened tree's leaves alive: at full
    width a leaked gradient tree is 1.86 GB of device memory."""
    import gc
    import weakref

    from repro_torch.utils.treeutil import tree_flatten, tree_map, tree_unflatten

    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        leaves, treedef = tree_flatten({"a": [t, (t,)], "b": t})
        tree_unflatten(treedef, leaves)
        tree_map(lambda x: x + 1, {"a": [t]})
        del t, leaves
        assert ref() is None
    finally:
        gc.enable()


def test_spec_payloads_pass_every_codec_and_count_bytes_as_jax():
    """The draft block and the verdict cross the draft <-> verify edge bit
    for bit under every codec in `CODECS` (their token and count leaves
    are integers; the identity codec keeps the f32 probabilities too), and
    `leaf_encoded_bytes` counts each payload's bytes as the reference's."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 151_936, (4, 4)).astype(np.int32)
    probs = rng.random((4, 4)).astype(np.float32)
    accepts = rng.integers(0, 5, (4,)).astype(np.int32)
    corrected = rng.integers(0, 151_936, (4,)).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in dict(tokens=tokens, probs=probs, accepts=accepts,
                                                 corrected=corrected).items()}
    assert set(wire.CODECS) == set(jwire.CODECS)
    for name, codec in wire.CODECS.items():
        fwd = wire.make_draft_payload(t["tokens"], t["probs"].double())
        t2, p2 = wire.split_draft_payload(codec.decode_tree(codec.encode_tree(fwd)))
        assert t2.dtype == torch.int32 and torch.equal(t2, t["tokens"])
        if name == "identity":
            assert p2.dtype == torch.float32 and torch.equal(p2, t["probs"])
        back = wire.make_accept_payload(t["accepts"].long(), t["corrected"])
        a2, c2 = wire.split_accept_payload(codec.decode_tree(codec.encode_tree(back)))
        assert torch.equal(a2, t["accepts"]) and torch.equal(c2, t["corrected"])
        jfwd = jwire.make_draft_payload(jnp.asarray(tokens), jnp.asarray(probs))
        jback = jwire.make_accept_payload(jnp.asarray(accepts), jnp.asarray(corrected))
        assert wire.leaf_encoded_bytes(fwd, name) == jwire.leaf_encoded_bytes(jfwd, name)
        assert wire.leaf_encoded_bytes(back, name) == jwire.leaf_encoded_bytes(jback, name)
    mixed = _payload(1)
    for name in wire.CODECS:
        assert wire.leaf_encoded_bytes({k: tensor_from_numpy(v, "cpu") for k, v in mixed.items()},
                                       name) == \
            jwire.leaf_encoded_bytes({k: jnp.asarray(v) for k, v in mixed.items()}, name)
