"""PyTorch port, the encoder-decoder family (whisper-small):
`repro_torch.models.encdec` and `model_zoo`'s encoder-decoder model
against the JAX package on the f32 whisper smoke config (2 + 2 layers,
4 heads of 16, LayerNorm, GELU, biased projections, sinusoidal
positions, 32 frames), with the reference's `init_encdec` weights
carried over by `params_from_numpy`, on the CPU.

Tolerances: the encoder memory, hidden states, f32 caches and logits
within 1e-4 absolute and relative (tests/test_torch_transformer.py's
budget: ATen's and XLA's CPU matmuls sum in another order); bf16 caches
(the model's default, and the cross-attention cache's dtype even in an
f32 model, as in the reference) within one bf16 ulp (2^-7 relative) plus
1e-3: each side rounds an f32 value that differs by ~1e-7 between the
packages, and after a decode tick that attended bf16 caches in which
such roundings fell apart, a new K/V row's small elements sit a few ulps
apart (1.8e-4 at 0.008 measured); the loss within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.models import encdec as jed
from repro_torch.configs import get, get_smoke
from repro_torch.models import encdec as ted
from repro_torch.models import transformer as tt
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, Request, make_engine
from repro_torch.utils.convert import params_from_numpy

NAME = "whisper-small"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-3, rtol=2.0 ** -7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the tier-1 run shares the cores
    between its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ed():
    """(jax cfg, jax params, port cfg, port params), f32 smoke."""
    jc = dataclasses.replace(j_get_smoke(NAME), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return jc, jp, tc, tp


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(cfg, b, seed=1, n=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n or cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(
        np.float32)


def _check_cache(tcache, jcache):
    """Every leaf: the same shapes and dtypes, f32 ones within `TOL`, bf16
    ones within `BF16_TOL`, ``pos`` equal."""
    assert set(tcache) == set(jcache) == {"pos", "k", "v", "xk", "xv"}
    for key in ("k", "v", "xk", "xv"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype)), key
        _close(tcache[key], jcache[key],
               **(BF16_TOL if tcache[key].dtype == torch.bfloat16 else TOL))
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_configs_match_the_reference():
    """Every field of CONFIG and SMOKE (the dtype as a torch dtype) and the
    parameter count (the reference's encoder terms: 0.28B)."""
    for mine, ref in ((get(NAME), j_get(NAME)), (get_smoke(NAME), j_get_smoke(NAME))):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert mine.param_count() == ref.param_count()
    assert get(NAME).param_count() == 277_891_584
    assert get(NAME).cross_attention and get(NAME).encoder_layers == 12


def test_init_encdec_matches_reference_tree(ed):
    """The port's own init: the reference's tree (``enc_layers`` and
    ``dec_layers`` unstacked), shapes and storage dtypes (norm scales and
    biases f32, the rest in the model dtype)."""
    _, jp, tc, _ = ed
    bf = dataclasses.replace(tc, dtype=torch.bfloat16)
    mine = ted.init_encdec(bf, torch.Generator().manual_seed(0), "cpu")
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
    assert len(conv["enc_layers"]) == tc.encoder_layers and len(conv["dec_layers"]) == tc.n_layers
    assert sorted(conv["dec_layers"][0]) == ["attn", "mlp", "norm1", "norm2", "norm_x", "xattn"]
    assert conv["enc_norm"]["bias"].dtype == torch.float32


def test_encode_matches_reference(ed):
    jc, jp, tc, tp = ed
    frames = _frames(tc, 2)
    want = jed.encode(jc, jp, jnp.asarray(frames))
    got = ted.encode(tc, tp, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, tc.n_frontend_tokens, tc.d_model)
    _close(got, want)


def test_decode_train_matches_reference(ed):
    """The teacher-forced decoder over 12 tokens: hidden states and every
    layer's self-attention K/V."""
    jc, jp, tc, tp = ed
    frames, toks = _frames(tc, 2, seed=2), _tokens(tc, 2, 12, seed=3)
    jmem = jed.encode(jc, jp, jnp.asarray(frames))
    tmem = ted.encode(tc, tp, torch.from_numpy(frames))
    jh, (jk, jv) = jed.decode_train(jc, jp, jnp.asarray(toks), jmem, want_kv=True)
    th, kv = ted.decode_train(tc, tp, torch.from_numpy(toks).long(), tmem, want_kv=True)
    _close(th, jh)
    assert len(kv) == tc.n_layers
    for li, (k, v) in enumerate(kv):
        _close(k, jk[li])
        _close(v, jv[li])
    assert ted.decode_train(tc, tp, torch.from_numpy(toks).long(), tmem)[1] is None


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_prime_cross_cache_matches_reference(ed, dtype):
    """The cross-attention K/V of every decoder layer in the cache's dtype;
    a memory of another frame count replaces the cache's ``xk``/``xv``."""
    jc, jp, tc, tp = ed
    frames = _frames(tc, 2, seed=4, n=20)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[dtype]
    jcache = jed.prime_cross_cache(jc, jp, jed.encode(jc, jp, jnp.asarray(frames)),
                                   jed.init_encdec_cache(jc, 2, 8, tc.n_frontend_tokens, jdt))
    tcache = ted.prime_cross_cache(tc, tp, ted.encode(tc, tp, torch.from_numpy(frames)),
                                   ted.init_encdec_cache(tc, 2, 8, tc.n_frontend_tokens, tdt,
                                                         "cpu"))
    assert tuple(tcache["xk"].shape) == (tc.n_layers, 2, 20, tc.d_kv)
    _check_cache(tcache, jcache)


def test_prefill_with_frames_matches_reference(ed):
    """`model.prefill(tokens, frames=)` with no cache (bf16, tokens + 64
    positions, as the reference sizes it): the last-position logits, the
    decoder's K/V over the prompt, the cross-attention cache, ``pos``."""
    jc, jp, tc, tp = ed
    frames, toks = _frames(tc, 2, seed=5), _tokens(tc, 2, 10, seed=6)
    jl, jcache, _ = j_build(jc).prefill(jp, jnp.asarray(toks), frames=jnp.asarray(frames))
    tl, tcache = build(tc, device="cpu").prefill(tp, torch.from_numpy(toks).long(),
                                                 frames=torch.from_numpy(frames))
    assert tuple(tcache["k"].shape) == (tc.n_layers, 2, 74, tc.d_kv)
    _close(tl, jl)
    _check_cache(tcache, jcache)
    assert int(tcache["pos"]) == 10


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_decode_ticks_match_reference(ed, dtype):
    """A 6-token prompt prefilled into a 16-position cache (bf16, the
    model's default, or f32), then eight `decode_step_encdec` ticks fed
    the reference's greedy tokens: logits and every cache leaf each tick.
    The port's ticks also match its own teacher-forced decoder over the
    whole stream: within 1e-4 with f32 caches, within the reference's own
    teacher-forcing budget (tests/test_decode_consistency.py: 1e-2
    relative, 5e-3 absolute) with bf16 ones."""
    jc, jp, tc, tp = ed
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[dtype]
    frames, toks = _frames(tc, 2, seed=7), _tokens(tc, 2, 6, seed=8)
    jmodel, tmodel = j_build(jc), build(tc, device="cpu")
    jl, jcache, _ = jmodel.prefill(jp, jnp.asarray(toks), jed.init_encdec_cache(
        jc, 2, 16, tc.n_frontend_tokens, jdt), frames=jnp.asarray(frames))
    tl, tcache = tmodel.prefill(tp, torch.from_numpy(toks).long(), ted.init_encdec_cache(
        tc, 2, 16, tc.n_frontend_tokens, tdt, "cpu"), frames=torch.from_numpy(frames))
    j_decode = jax.jit(jmodel.decode_step)
    stream, logits = [toks], []
    for _ in range(8):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        stream.append(nxt)
        jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tmodel.decode_step(tp, tcache, torch.from_numpy(nxt).long())
        logits.append(tl[:, 0])
        _close(tl, jl)
        _check_cache(tcache, jcache)
    assert int(tcache["pos"]) == 14
    full = np.concatenate(stream, axis=1)
    hidden, _ = ted.decode_train(tc, tp, torch.from_numpy(full).long(),
                                 ted.encode(tc, tp, torch.from_numpy(frames)))
    teacher = tt.lm_logits(tc, tp, hidden)[:, 6:]
    budget = TOL if dtype == "f32" else dict(atol=5e-3, rtol=1e-2)
    _close(torch.stack(logits, dim=1), teacher.numpy(), **budget)


def test_loss_matches_reference(ed):
    jc, jp, tc, tp = ed
    toks, labels = _tokens(tc, 2, 24, seed=8), _tokens(tc, 2, 24, seed=9)
    frames = _frames(tc, 2, seed=10)
    mask = np.ones((2, 24), np.float32)
    mask[1, 17:] = 0
    jloss, jm = j_build(jc).loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                      "mask": jnp.asarray(mask), "frames": jnp.asarray(frames)})
    tloss, tm = build(tc, device="cpu").loss(tp, {"tokens": torch.from_numpy(toks).long(),
                                                  "labels": torch.from_numpy(labels).long(),
                                                  "mask": torch.from_numpy(mask),
                                                  "frames": torch.from_numpy(frames)})
    assert sorted(tm) == sorted(jm) == ["ce"]
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


def test_encdec_refuses_what_the_reference_refuses(ed):
    """No paged decode and no verify step; continuous batching refused; a
    length-masked prefill refused; the aligned engine's prefill, which
    passes no frames, fails on a ValueError naming them (the reference's
    fails inside `encode` on ``frames=None``)."""
    _, _, tc, tp = ed
    model = build(tc, device="cpu")
    assert model.decode_step_paged is None and model.verify_step is None
    with pytest.raises(ValueError, match="attention-only"):
        make_engine(model, tp, EngineConfig(mode="continuous", max_len=64))
    toks = torch.from_numpy(_tokens(tc, 1, 4)).long()
    with pytest.raises(ValueError, match="length-masked"):
        model.prefill(tp, toks, length=3, frames=torch.from_numpy(_frames(tc, 1)))
    eng = make_engine(model, tp, EngineConfig(max_batch=2, max_len=32))
    eng.submit(Request(uid=0, prompt=_tokens(tc, 1, 4)[0], max_new_tokens=2))
    with pytest.raises(ValueError, match="frames"):
        eng.step()
    with pytest.raises(ValueError, match="encoder-decoder"):
        tt.forward_lm(tc, tp, toks)
