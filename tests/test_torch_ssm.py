"""PyTorch port, the Mamba-2 SSM family: `repro_torch.models.ssm`, the
transformer's SSM branches, `model_zoo.build` and the aligned engine
against the JAX package on the f32 mamba2 smoke config, with the
reference's `init_lm` weights carried over by `params_from_numpy`.

Tolerances: the block and the decode step 1e-5 (one layer, f32 on both
sides, only summation orders differ); logits and caches through the
whole model 1e-4, as tests/test_torch_transformer.py holds the dense
family. The conv cache is bf16 on both sides (`init_cache`'s dtype) and
must agree bit for bit. The engines must give identical token streams,
ticks and admissions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import make_engine as j_make_engine
from repro_torch.configs import get, get_smoke
from repro_torch.kernels.sample import argmax_last_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, Request, make_engine
from repro_torch.utils.convert import F32_LEAVES, params_from_numpy

NAME = "mamba2-130m"
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def lm():
    """(jax cfg, jax params, port cfg, port params), f32."""
    jc = dataclasses.replace(j_get_smoke(NAME), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return jc, jp, tc, tp


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _bits(t, j):
    """Bitwise equality of a bf16 port tensor and a bf16 JAX array."""
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_matches_reference(lm):
    jc, _, tc, _ = lm
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.ssm_heads, tc.d_inner) == (jc.ssm_heads, jc.d_inner)
    full = get(NAME)
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_heads, full.ssm_head_dim,
            full.ssm_state, full.ssm_chunk, full.vocab_size) == \
           (24, 768, 1536, 24, 64, 128, 256, 50280)


def test_params_from_numpy_keeps_ssm_leaves_f32(lm):
    """In a bf16 config, the SSM's own leaves arrive f32 and equal the
    reference's f32 leaves bit for bit; projections go to bf16, norms stay
    f32."""
    _, jp, tc, _ = lm
    bf = dataclasses.replace(tc, dtype=torch.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    conv = params_from_numpy(tree, bf, "cpu")
    for li in range(bf.n_layers):
        mine = conv["layers"][li]["mamba"]
        for key in sorted(F32_LEAVES):
            want = tree["layers"]["mamba"][key][li]
            assert want.dtype == np.float32, key
            assert mine[key].dtype == torch.float32, key
            np.testing.assert_array_equal(mine[key].numpy(), want)
        assert mine["in_proj"]["w"].dtype == torch.bfloat16
        assert mine["out_proj"]["w"].dtype == torch.bfloat16
        assert mine["norm"]["scale"].dtype == torch.float32
    assert conv["embed"]["table"].dtype == torch.bfloat16


def test_init_lm_matches_reference_tree(lm):
    """The port's own init: the reference's tree and shapes, projections
    in the compute dtype, norms and the SSM's own leaves in f32."""
    _, jp, tc, _ = lm
    bf = dataclasses.replace(tc, dtype=torch.bfloat16)
    mine = tt.init_lm(bf, torch.Generator().manual_seed(0), "cpu")
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), bf, "cpu")

    def flat(tree, prefix=""):
        if isinstance(tree, (list, dict)):
            items = enumerate(tree) if isinstance(tree, list) else tree.items()
            return {k: v for n, x in items for k, v in flat(x, f"{prefix}{n}.").items()}
        return {prefix: tree}

    fm, fc = flat(mine), flat(conv)
    assert fm.keys() == fc.keys()
    for k in fm:
        assert fm[k].shape == fc[k].shape and fm[k].dtype == fc[k].dtype, k
    m0 = mine["layers"][0]["mamba"]
    torch.testing.assert_close(torch.exp(m0["A_log"]), torch.linspace(1.0, 16.0, tc.ssm_heads))
    assert abs(m0["conv_w"].std().item() - 0.2) < 0.02


@pytest.mark.parametrize("s", [1, 40, 77])
def test_mamba_block_matches_reference(lm, s):
    """One block on a random (2, S, d) input: its output, and with
    ``want_state`` the final SSM state and the conv tail (S=1 pads the
    tail at the front). S=40 and 77 cross the 32-token chunk."""
    jc, jp, tc, tp = lm
    x = np.random.default_rng(s).normal(size=(2, s, tc.d_model)).astype(np.float32)
    jpl = _layer(jp["layers"], 0)["mamba"]
    jout, jst = jssm.mamba_block(jpl, jnp.asarray(x), jc, jnp.float32, want_state=True)
    out, st = tssm.mamba_block(tp["layers"][0]["mamba"], torch.from_numpy(x), tc,
                               torch.float32, want_state=True)
    _close(out, jout, **BLOCK_TOL)
    _close(st["state"], jst["state"], **BLOCK_TOL)
    _close(st["conv"], jst["conv"], **BLOCK_TOL)
    plain = tssm.mamba_block(tp["layers"][0]["mamba"], torch.from_numpy(x), tc, torch.float32,
                             impl="ref")
    assert torch.equal(plain, out)


def test_causal_conv_matches_reference(lm):
    _, jp, tc, tp = lm
    seq = np.random.default_rng(5).normal(size=(2, 9, 6)).astype(np.float32)
    w = np.random.default_rng(6).normal(size=(4, 6)).astype(np.float32)
    b = np.random.default_rng(7).normal(size=(6,)).astype(np.float32)
    got = tssm._causal_conv(*(torch.from_numpy(a) for a in (seq, w, b)))
    _close(got, jssm._causal_conv(*(jnp.asarray(a) for a in (seq, w, b))), **BLOCK_TOL)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(8)
    b, h, p, n = 3, 4, 32, 16
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, size=(b, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    Bt, Ct = (rng.normal(size=(b, n)).astype(np.float32) for _ in range(2))
    args = (state, x, dt, A, Bt, Ct)
    y, new = tssm.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    jy, jnew = jssm.ssd_decode_step(*(jnp.asarray(a) for a in args))
    _close(y, jy, **BLOCK_TOL)
    _close(new, jnew, **BLOCK_TOL)


def test_mamba_decode_matches_reference(lm):
    """One decode step from a random f32 state and bf16 conv window: the
    bf16 window concatenates with the f32 row as the reference promotes
    it, and the new window is stored back in bf16 bit for bit."""
    jc, jp, tc, tp = lm
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 1, tc.d_model)).astype(np.float32)
    state = rng.normal(size=(3, tc.ssm_heads, tc.ssm_head_dim, tc.ssm_state)).astype(np.float32)
    conv = rng.normal(size=(3, tc.ssm_conv - 1, tc.d_inner + 2 * tc.ssm_state)).astype(
        ml_dtypes.bfloat16)
    jout, jnew = jssm.mamba_decode(_layer(jp["layers"], 1)["mamba"], jnp.asarray(x),
                                   {"state": jnp.asarray(state), "conv": jnp.asarray(conv)},
                                   jc, jnp.float32)
    tconv = torch.from_numpy(conv.view(np.uint16).copy()).view(torch.bfloat16)
    out, new = tssm.mamba_decode(tp["layers"][1]["mamba"], torch.from_numpy(x),
                                 {"state": torch.from_numpy(state), "conv": tconv},
                                 tc, torch.float32)
    assert out.shape == (3, 1, tc.d_model)
    _close(out, jout, **BLOCK_TOL)
    _close(new["state"], jnew["state"], **BLOCK_TOL)
    _bits(new["conv"], jnew["conv"])


def test_init_cache_matches_reference(lm):
    jc, _, tc, _ = lm
    mine = tt.init_cache(tc, 3, 16, device="cpu")
    want = jt.init_cache(jc, 3, 16)
    assert set(mine) == set(want) == {"pos", "ssm_state", "ssm_conv"}
    for key in want:
        assert tuple(mine[key].shape) == want[key].shape
        assert mine[key].dtype == getattr(torch, str(want[key].dtype)), key
    mine, want = tssm.init_mamba_cache(tc, 3, device="cpu"), jssm.init_mamba_cache(jc, 3)
    for key in ("state", "conv"):
        assert tuple(mine[key].shape) == want[key].shape
        assert mine[key].dtype == getattr(torch, str(want[key].dtype)), key


def test_prefill_and_ten_decode_steps_match_reference(lm):
    """`prefill_lm` on (2, 45) tokens (a chunk and a ragged tail), then ten
    `decode_step_lm` steps fed the reference's greedy tokens: logits and
    ``ssm_state`` within 1e-4, ``ssm_conv`` bit for bit, ``pos`` equal."""
    jc, jp, tc, tp = lm
    toks = _tokens(tc, 2, 45)
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks), jt.init_cache(jc, 2, 64))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, 2, 64, device="cpu"))
    hidden, _, kv, states = tt.forward_lm(tc, tp, torch.from_numpy(toks).long(), want_kv=True)
    assert kv is None and len(states) == tc.n_layers
    _close(tt.lm_logits(tc, tp, hidden[:, -1:]), jl)
    for step in range(11):
        _close(tl, jl)
        _close(tcache["ssm_state"], jcache["ssm_state"])
        _bits(tcache["ssm_conv"], jcache["ssm_conv"])
        assert int(tcache["pos"]) == int(jcache["pos"]) == 45 + step
        if step == 10:
            break
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = jt.decode_step_lm(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = tt.decode_step_lm(tc, tp, tcache, torch.from_numpy(nxt).long())


def test_ssm_rejects_length_masks_and_ragged_cursors(lm):
    _, _, tc, tp = lm
    toks = torch.from_numpy(_tokens(tc, 2, 8)).long()
    with pytest.raises(ValueError, match="attention-only"):
        tt.prefill_lm(tc, tp, toks, tt.init_cache(tc, 2, 8, device="cpu"), length=5)
    cache = tt.init_cache(tc, 2, 8, device="cpu")
    cache["pos"] = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        tt.decode_step_lm(tc, tp, cache, toks[:, :1])


def test_model_zoo_builds_ssm(lm):
    _, _, tc, tp = lm
    model = build(tc, device="cpu")
    assert model.decode_step_paged is None
    logits, cache = model.prefill(tp, torch.from_numpy(_tokens(tc, 1, 9)).long())
    assert logits.shape == (1, 1, tc.vocab_size) and cache["ssm_conv"].dtype == torch.bfloat16
    logits, cache = model.decode_step(tp, cache, torch.zeros((1, 1), dtype=torch.long))
    assert int(cache["pos"]) == 10 and bool(torch.isfinite(logits).all())
    hybrid = build(get_smoke("hymba-1.5b"), device="cpu")  # attention beside the SSM
    assert hybrid.decode_step_paged is None and hybrid.verify_step is None


def _requests(cfg, seed=11):
    """5 requests, prompts of 5-70 tokens, 6 new tokens each."""
    rng = np.random.default_rng(seed)
    lens = [5, 70, 33, 12, 48]
    return [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
            for i, n in enumerate(lens)]


def test_aligned_engine_matches_reference(lm):
    """The same 5 requests through both packages' default (aligned)
    engines with 3 slots, ticked in lockstep: the same slots, prefill
    lengths and decode batches every tick, logits within 1e-4, identical
    token streams, first-token and done ticks, stats and ledger. On the
    CPU no kernel launches."""
    jc, jp, tc, tp = lm
    je = j_make_engine(j_build(jc), jp, JEngineConfig(max_batch=3, max_len=128))
    te = make_engine(build(tc, device="cpu"), tp, EngineConfig(max_batch=3, max_len=128))
    assert te.cfg.mode == je.cfg.mode == "aligned"
    before = (ssd_scan_kernel.launches, argmax_last_kernel.launches)
    for uid, prompt, m in _requests(tc):
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    while not (je.idle() and te.idle()):
        je.step()
        te.step()
        assert [s.uid if s else None for s in te.slots] == \
               [s.uid if s else None for s in je.slots], te.tick
        for key in ("prefill_lens", "decode_batch"):
            assert te.last_tick[key] == je.last_tick[key], (te.tick, key)
        if te.last_tick["decode_batch"]:
            _close(te.last_logits, je.last_logits)
        assert te.tick < 100
    assert te.tick == je.tick == 12
    done = {r.uid: (tuple(r.out_tokens), r.first_token_tick, r.done_tick) for r in te.finished}
    assert done == {r.uid: (tuple(r.out_tokens), r.first_token_tick, r.done_tick)
                    for r in je.finished}
    assert len(done) == 5 and te.stats == je.stats
    assert [dataclasses.astuple(c) for c in te.ledger.completions] == \
           [dataclasses.astuple(c) for c in je.ledger.completions]
    assert (ssd_scan_kernel.launches, argmax_last_kernel.launches) == before


def test_continuous_mode_rejects_ssm(lm):
    _, _, tc, tp = lm
    with pytest.raises(ValueError, match="attention-only"):
        make_engine(build(tc, device="cpu"), tp, EngineConfig(mode="continuous", max_len=64))
