"""PyTorch port, the dense decoder LM: `repro_torch.models.transformer`
against `repro.models.transformer` on the tinyllama, qwen2.5 and
starcoder2 smoke configs (rms/swiglu, qkv bias + tied embeddings,
ln/gelu with biases), in f32 on the CPU. The reference's `init_lm`
weights are carried over with `utils.convert.params_from_numpy`.

Tolerance: 1e-4 absolute and relative on logits, KV and decode rows.
Both sides run the same op sequence in f32; the ops differ only in the
summation order of XLA's and ATen's CPU matmuls (the differences seen
are below 3e-6), compounded over two layers and the unembedding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.operators import kv_quantize as j_kv_quantize
from repro.models import build as j_build
from repro.models import transformer as jt
from repro_torch.configs import get_smoke
from repro_torch.core.operators import kv_quantize
from repro_torch.models import transformer as tt
from repro_torch.models.model_zoo import build
from repro_torch.utils.convert import params_from_numpy

NAMES = ["tinyllama-1.1b", "qwen2.5-3b", "starcoder2-15b"]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", params=NAMES)
def lm(request):
    """(name, jax cfg, jax params, port cfg, port params), f32."""
    name = request.param
    jc = dataclasses.replace(j_get_smoke(name), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return name, jc, jp, tc, tp


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_fields_match_reference(lm):
    name, jc, _, tc, _ = lm
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.d_q, tc.d_kv, tc.layer_windows()) == (jc.d_q, jc.d_kv, jc.layer_windows())


def test_init_lm_matches_reference_tree(lm):
    """The port's own init draws other numbers, but the tree, the shapes
    and the scales are the reference's; matmul weights are kept in the
    compute dtype and norms in f32."""
    _, jc, jp, tc, tp = lm
    bf = dataclasses.replace(tc, dtype=torch.bfloat16)
    mine = tt.init_lm(bf, torch.Generator().manual_seed(0), "cpu")
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), bf, "cpu")

    def flat(tree, prefix=""):
        if isinstance(tree, list):
            return {k: v for i, x in enumerate(tree) for k, v in flat(x, f"{prefix}{i}.").items()}
        if isinstance(tree, dict):
            return {k: v for n, x in tree.items() for k, v in flat(x, f"{prefix}{n}.").items()}
        return {prefix: tree}

    fm, fc = flat(mine), flat(conv)
    assert fm.keys() == fc.keys()
    for k in fm:
        assert fm[k].shape == fc[k].shape and fm[k].dtype == fc[k].dtype, k
        assert fm[k].dtype == (torch.float32 if "norm" in k else torch.bfloat16), k
    w = mine["layers"][0]["attn"]["wq"]["w"].float()
    assert abs(w.std().item() * np.sqrt(tc.d_model) - 1.0) < 0.05  # N(0,1)/sqrt(fan_in)
    assert abs(mine["embed"]["table"].float().std().item() - 0.02) < 0.002


@pytest.mark.parametrize("length", ["none", "scalar", "ragged"])
def test_prefill_matches_reference(lm, length):
    """Logits at each row's last position and the f32 KV cache, for an
    unpadded, a right-padded and a packed ragged prompt buffer."""
    _, jc, jp, tc, tp = lm
    b, s = 3, 16
    toks = _tokens(tc, b, s)
    lens = {"none": None, "scalar": 11, "ragged": np.array([16, 9, 1], np.int32)}[length]
    jlen = None if lens is None else jnp.asarray(lens)
    tlen = None if lens is None else (lens if np.isscalar(lens) else torch.from_numpy(lens))
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                  jt.init_cache(jc, b, s + 4, jnp.float32), length=jlen)
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, b, s + 4, torch.float32, "cpu"),
                               length=tlen)
    assert tl.shape == (b, 1, tc.vocab_size)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("cursor", ["scalar", "ragged"])
def test_decode_step_lm_matches_reference(lm, cursor):
    """`decode_step_lm` after a prefill into a 12-token f32 cache, four
    steps fed the reference's greedy tokens. Scalar: the shared cursor
    starts at 10 and runs past the cache's end, where both packages write
    its last row. Ragged: per-slot cursors from a packed prefill of
    lengths 10, 7 and 3; the first slot reaches the end and then writes
    nothing. Logits, K/V caches and cursors each step."""
    _, jc, jp, tc, tp = lm
    b, s, max_len = 3, 10, 12
    toks = _tokens(tc, b, s, seed=3)
    lens = np.array([10, 7, 3], np.int32) if cursor == "ragged" else None
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                  jt.init_cache(jc, b, max_len, jnp.float32),
                                  length=None if lens is None else jnp.asarray(lens))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, b, max_len, torch.float32, "cpu"),
                               length=None if lens is None else torch.from_numpy(lens))
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = jt.decode_step_lm(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = tt.decode_step_lm(tc, tp, tcache, torch.from_numpy(nxt).long())
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert tcache["pos"].ndim == (1 if cursor == "ragged" else 0)


def test_model_prefill_keeps_bf16_cache(lm):
    """`Model.prefill` without a cache makes the reference's default
    bf16 cache (`init_cache`'s dtype), whatever the compute dtype."""
    _, _, _, tc, tp = lm
    model = build(tc, device="cpu")
    logits, cache = model.prefill(tp, torch.from_numpy(_tokens(tc, 2, 8)).long())
    assert logits.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    assert int(cache["pos"]) == 8


def _paged_view(cfg, seed, quantized):
    """A random f32 pool of 9 blocks of 4 tokens, four slots: mid-block,
    an inactive cursor at mb*bs, a fresh slot at pos 0 and one at a block
    boundary; unmapped entries are -1 and block 0 is the zero block."""
    rng = np.random.default_rng(seed)
    ln, nb, bs, mb = cfg.n_layers, 9, 4, 3
    k = rng.normal(size=(ln, nb, bs, cfg.d_kv)).astype(np.float32)
    v = rng.normal(size=(ln, nb, bs, cfg.d_kv)).astype(np.float32)
    k[:, 0] = v[:, 0] = 0
    tables = np.array([[3, 5, -1], [-1, -1, -1], [-1, -1, -1], [1, 8, -1]], np.int32)
    pos = np.array([6, mb * bs, 0, 8], np.int32)
    tv = {"k_pool": torch.from_numpy(k), "v_pool": torch.from_numpy(v),
          "tables": torch.from_numpy(tables), "pos": torch.from_numpy(pos)}
    jv = {"k_pool": jnp.asarray(k), "v_pool": jnp.asarray(v),
          "tables": jnp.asarray(tables), "pos": jnp.asarray(pos)}
    if quantized:
        tv["k_pool"], tv["k_scale"] = kv_quantize(tv["k_pool"])
        tv["v_pool"], tv["v_scale"] = kv_quantize(tv["v_pool"])
        jv["k_pool"], jv["k_scale"] = j_kv_quantize(jv["k_pool"])
        jv["v_pool"], jv["v_scale"] = j_kv_quantize(jv["v_pool"])
    tv["rows_like"] = torch.zeros((0,), dtype=torch.float32)
    jv["rows_like"] = jnp.zeros((0,), jnp.float32)
    return tv, jv


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_paged_matches_reference(lm, quantized):
    _, jc, jp, tc, tp = lm
    tv, jv = _paged_view(tc, 1, quantized)
    tok = _tokens(tc, 4, 1, seed=2)
    jl, jk, jvv = jt.decode_step_paged_lm(jc, jp, jv, jnp.asarray(tok))
    tl, tk, tvv = tt.decode_step_paged_lm(tc, tp, tv, torch.from_numpy(tok).long())
    assert tl.shape == (4, 1, tc.vocab_size) and tk.shape == (tc.n_layers, 4, tc.d_kv)
    _close(tl, jl)
    _close(tk, jk)
    _close(tvv, jvv)


def test_paged_decode_continues_prefill(lm):
    """Prefill a prompt, lay its KV into blocks, and decode one token
    through the pool: the logits equal a prefill of the prompt plus that
    token (the decode path and the prefill path agree in the port)."""
    _, _, _, tc, tp = lm
    toks = torch.from_numpy(_tokens(tc, 1, 7, seed=4)).long()
    _, cache = tt.prefill_lm(tc, tp, toks[:, :6],
                             tt.init_cache(tc, 1, 8, torch.float32, "cpu"))
    pview = {"k_pool": cache["k"][:, :, :8].reshape(tc.n_layers, 2, 4, tc.d_kv).clone(),
             "v_pool": cache["v"][:, :, :8].reshape(tc.n_layers, 2, 4, tc.d_kv).clone(),
             "tables": torch.tensor([[0, 1]], dtype=torch.int32),
             "pos": torch.tensor([6], dtype=torch.int32)}
    logits, _, _ = tt.decode_step_paged_lm(tc, tp, pview, toks[:, 6:7])
    want, _ = tt.prefill_lm(tc, tp, toks, tt.init_cache(tc, 1, 8, torch.float32, "cpu"))
    torch.testing.assert_close(logits, want, **TOL)


@pytest.mark.parametrize("s,window", [(40, 0), (36, 6), (36, 0)],
                         ids=["whole-blocks", "window", "padded-block"])
def test_prefill_past_blockwise_threshold_matches_reference(lm, monkeypatch, s, window):
    """Past `BLOCKWISE_THRESHOLD` both packages take `attention_blockwise`
    (thresholds lowered to 16, blocks of 8): logits and the f32 cache of
    a packed ragged prompt buffer, with full causal and sliding-window
    layers, and a length that leaves a padded last block."""
    _, jc, jp, tc, tp = lm
    monkeypatch.setattr(jt, "BLOCKWISE_THRESHOLD", 16)
    monkeypatch.setattr(tt, "BLOCKWISE_THRESHOLD", 16)
    monkeypatch.setattr(tt, "KV_BLOCK", 8)
    monkeypatch.setenv("REPRO_KV_BLOCK", "8")

    def plain(*a, **kw):
        raise AssertionError("a prompt past the threshold took attention_plain")

    monkeypatch.setattr(tt.layers, "attention_plain", plain)
    if window:
        jc = dataclasses.replace(jc, attn_kind="swa", window=window)
        tc = dataclasses.replace(tc, attn_kind="swa", window=window)
    b = 2
    toks = _tokens(tc, b, s, seed=5)
    lens = np.array([s, s - 11], np.int32)
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                  jt.init_cache(jc, b, s, jnp.float32), length=jnp.asarray(lens))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, b, s, torch.float32, "cpu"),
                               length=torch.from_numpy(lens))
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


def test_prefill_impl_ref_on_cpu_is_the_default_route(lm):
    """On a CPU tensor ``impl="ref"`` and the default take the same
    route, bit for bit; an unknown impl raises."""
    _, _, _, tc, tp = lm
    toks = torch.from_numpy(_tokens(tc, 2, 12, seed=6)).long()
    a, _ = tt.prefill_lm(tc, tp, toks, tt.init_cache(tc, 2, 12, torch.float32, "cpu"))
    b, _ = tt.prefill_lm(tc, tp, toks, tt.init_cache(tc, 2, 12, torch.float32, "cpu"),
                         impl="ref")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown impl"):
        tt.prefill_lm(tc, tp, toks, tt.init_cache(tc, 2, 12, torch.float32, "cpu"),
                      impl="flash")


def test_model_zoo_device_and_families():
    tc = get_smoke("tinyllama-1.1b")
    assert build(tc, device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(tc)  # the default device is cuda: no quiet CPU fallback
    for name in ("hymba-1.5b", "pixtral-12b", "whisper-small"):  # every family builds
        assert build(get_smoke(name), device="cpu").cfg.family == get_smoke(name).family


@pytest.mark.parametrize("entry", ["init_lm", "init_cache", "params_from_numpy"])
def test_entry_points_default_to_cuda(entry):
    """Every entry point that makes tensors runs on cuda unless the caller
    names another device: without a GPU, no device is an error, never a
    quiet CPU fallback; device="cpu" works."""
    tc = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32, n_layers=1)
    tree = {"embed": {"table": np.zeros((tc.vocab_size, tc.d_model), np.float32)},
            "final_norm": {"scale": np.ones((tc.d_model,), np.float32)},
            "layers": {"norm1": {"scale": np.ones((1, tc.d_model), np.float32)}}}
    make = {
        "init_lm": lambda **kw: tt.init_lm(tc, torch.Generator().manual_seed(0), **kw),
        "init_cache": lambda **kw: tt.init_cache(tc, 1, 4, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(tree, tc, **kw),
    }[entry]
    flat = jax.tree_util.tree_leaves(make(device="cpu"))
    assert flat and all(t.device.type == "cpu" for t in flat)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device=None)
