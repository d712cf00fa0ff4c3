"""PyTorch port, the hybrid family (hymba-1.5b): the transformer's hybrid
branches (attention and a Mamba-2 block side by side on one norm1 output,
their outputs averaged), `model_zoo.build` and the aligned engine against
the JAX package on the f32 hymba smoke config (a global layer and a
16-token window, GQA 4/2 of 32, Mamba-2 heads of 32, state 16), with the
reference's `init_lm` weights carried over by `params_from_numpy`, on
the CPU.

Tolerances: logits and f32 caches through the whole model within 1e-4
absolute and relative, as tests/test_torch_ssm.py and
tests/test_torch_transformer.py hold the SSM and dense families (ATen's
and XLA's CPU matmuls sum in another order). The engine keeps K/V and
the conv window in bf16 (`init_cache`'s default, on both sides): those
leaves within one bf16 ulp (2^-7 relative) plus 1e-4, since each side
rounds an f32 value that differs by ~1e-7 between the packages. The
engines give identical token streams, ticks and admissions.
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
from repro.models import transformer as jt
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import make_engine as j_make_engine
from repro_torch.configs import get, get_smoke
from repro_torch.kernels.sample import argmax_last_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.models import transformer as tt
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, Request, SpecConfig, make_engine
from repro_torch.utils.convert import F32_LEAVES, params_from_numpy

NAME = "hymba-1.5b"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-4, rtol=2.0 ** -7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the tier-1 run shares the cores
    between its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
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


def _check_cache(tcache, jcache):
    """Every leaf of a hybrid cache: the same dtypes, f32 leaves within
    `TOL`, bf16 ones within `BF16_TOL`, ``pos`` equal."""
    assert set(tcache) == set(jcache) == {"pos", "k", "v", "ssm_state", "ssm_conv"}
    for key in ("k", "v", "ssm_state", "ssm_conv"):
        assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype)), key
        _close(tcache[key], jcache[key],
               **(BF16_TOL if tcache[key].dtype == torch.bfloat16 else TOL))
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_configs_match_the_reference():
    """Every field of CONFIG and SMOKE (the dtype as a torch dtype), the
    windows (three global layers: 0, 15, 31) and the parameter count
    (the reference's hybrid terms: 1.64B)."""
    for mine, ref in ((get(NAME), j_get(NAME)), (get_smoke(NAME), j_get_smoke(NAME))):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert mine.layer_windows() == ref.layer_windows()
        assert mine.param_count() == ref.param_count()
    assert get(NAME).param_count() == 1_640_664_896
    assert [i for i, w in enumerate(get(NAME).layer_windows()) if w == 0] == [0, 15, 31]


def test_init_lm_and_params_from_numpy_trees(lm):
    """The port's own init has the reference's tree, shapes and storage
    dtypes (a hybrid layer: attn, mamba, mlp, two norms); the converted
    tree keeps the Mamba-2 leaves f32 in a bf16 model."""
    _, jp, tc, _ = lm
    bf = dataclasses.replace(tc, dtype=torch.bfloat16)
    mine = tt.init_lm(bf, torch.Generator().manual_seed(0), "cpu")
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), bf, "cpu")
    assert sorted(conv["layers"][0]) == ["attn", "mamba", "mlp", "norm1", "norm2"]
    for a, b in zip(mine["layers"], conv["layers"]):
        assert a.keys() == b.keys()
        for part in a:
            for leaf in a[part]:
                x, y = a[part][leaf], b[part][leaf]
                if isinstance(x, dict):
                    assert {k: (v.shape, v.dtype) for k, v in x.items()} == \
                           {k: (v.shape, v.dtype) for k, v in y.items()}, (part, leaf)
                else:
                    assert (x.shape, x.dtype) == (y.shape, y.dtype), (part, leaf)
    for leaf in F32_LEAVES:
        assert conv["layers"][1]["mamba"][leaf].dtype == torch.float32
    assert conv["layers"][1]["mamba"]["in_proj"]["w"].dtype == torch.bfloat16


def test_init_cache_matches_reference(lm):
    jc, _, tc, _ = lm
    mine, want = tt.init_cache(tc, 3, 16, device="cpu"), jt.init_cache(jc, 3, 16)
    assert set(mine) == set(want) == {"pos", "k", "v", "ssm_state", "ssm_conv"}
    for key in want:
        assert tuple(mine[key].shape) == want[key].shape
        assert mine[key].dtype == getattr(torch, str(want[key].dtype)), key


@pytest.mark.parametrize("s", [9, 40])
def test_prefill_matches_reference(lm, s):
    """`prefill_lm` on (2, s) tokens, inside and past the 16-token window,
    into f32 caches: last-position logits and ``k``, ``v``, ``ssm_state``,
    ``ssm_conv`` within 1e-4, ``pos``; `forward_lm` returns both the K/V
    and the SSM state of every layer."""
    jc, jp, tc, tp = lm
    toks = _tokens(tc, 2, s)
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                  jt.init_cache(jc, 2, 48, jnp.float32))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, 2, 48, torch.float32, "cpu"))
    _close(tl, jl)
    _check_cache(tcache, jcache)
    _, _, kv, states = tt.forward_lm(tc, tp, torch.from_numpy(toks).long(), want_kv=True)
    assert len(kv) == len(states) == tc.n_layers


def test_decode_ticks_match_reference(lm):
    """Prefill 20 tokens into a 32-position f32 cache, then eight
    `decode_step_lm` ticks past the window, fed the reference's greedy
    tokens: logits and every cache leaf each tick."""
    jc, jp, tc, tp = lm
    toks = _tokens(tc, 2, 20, seed=3)
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                  jt.init_cache(jc, 2, 32, jnp.float32))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, 2, 32, torch.float32, "cpu"))
    j_decode = jax.jit(lambda p, c, t: jt.decode_step_lm(jc, p, c, t))
    for _ in range(8):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tt.decode_step_lm(tc, tp, tcache, torch.from_numpy(nxt).long())
        _close(tl, jl)
        _check_cache(tcache, jcache)
    assert int(tcache["pos"]) == 28


def test_loss_matches_reference(lm):
    jc, jp, tc, tp = lm
    toks, labels = _tokens(tc, 2, 24, seed=8), _tokens(tc, 2, 24, seed=9)
    mask = np.ones((2, 24), np.float32)
    mask[1, 17:] = 0
    jloss, jm = j_build(jc).loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                      "mask": jnp.asarray(mask)})
    tloss, tm = build(tc, device="cpu").loss(tp, {"tokens": torch.from_numpy(toks).long(),
                                                  "labels": torch.from_numpy(labels).long(),
                                                  "mask": torch.from_numpy(mask)})
    assert sorted(tm) == sorted(jm) == ["ce"]
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


def test_hybrid_refuses_what_the_reference_refuses(lm):
    """No paged decode and no verify step (`model_zoo`), no length-masked
    prefill, no ragged decode cursors, no continuous batching and no
    speculative engine: a recurrent state has no per-slot rewind."""
    _, jp, tc, tp = lm
    model = build(tc, device="cpu")
    assert model.decode_step_paged is None and model.verify_step is None
    toks = torch.from_numpy(_tokens(tc, 2, 8)).long()
    with pytest.raises(ValueError, match="attention-only"):
        tt.prefill_lm(tc, tp, toks, tt.init_cache(tc, 2, 8, device="cpu"), length=5)
    cache = tt.init_cache(tc, 2, 8, device="cpu")
    cache["pos"] = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        tt.decode_step_lm(tc, tp, cache, toks[:, :1])
    with pytest.raises(ValueError, match="attention-only"):
        tt.verify_step_lm(tc, tp, cache, toks[:, :2], torch.tensor([2, 2]))
    view = {"k_pool": cache["k"], "v_pool": cache["v"], "pos": cache["pos"],
            "tables": torch.zeros((2, 1), dtype=torch.int32)}
    with pytest.raises(ValueError, match="attention-only"):
        tt.decode_step_paged_lm(tc, tp, view, toks[:, :1])
    with pytest.raises(ValueError, match="attention-only"):
        make_engine(model, tp, EngineConfig(mode="continuous", max_len=64))
    with pytest.raises(ValueError):
        make_engine(model, tp, SpecConfig(max_len=64), draft=(model, tp))


def _requests(cfg, seed=11):
    """4 requests, prompts of 5-40 tokens (two past the 16-token window),
    5 new tokens each."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 5)
            for i, n in enumerate([5, 40, 12, 23])]


def test_aligned_engine_matches_reference(lm):
    """The same 4 requests through both packages' default (aligned)
    engines with 2 slots, ticked in lockstep: each prompt prefilled alone
    at its exact length (no bucket), the same slots, prefill lengths and
    decode batches every tick, logits within 1e-4, identical streams,
    first-token and done ticks, stats and ledger; the bf16 slot cache's
    four leaves after the drain. On the CPU no kernel launches."""
    jc, jp, tc, tp = lm
    je = j_make_engine(j_build(jc), jp, JEngineConfig(max_batch=2, max_len=96))
    te = make_engine(build(tc, device="cpu"), tp, EngineConfig(max_batch=2, max_len=96))
    assert te.cfg.mode == je.cfg.mode == "aligned"
    before = (ssd_scan_kernel.launches, argmax_last_kernel.launches)
    for uid, prompt, m in _requests(tc):
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    prefill_lens = []
    while not (je.idle() and te.idle()):
        je.step()
        te.step()
        assert [s.uid if s else None for s in te.slots] == \
               [s.uid if s else None for s in je.slots], te.tick
        for key in ("prefill_lens", "decode_batch"):
            assert te.last_tick[key] == je.last_tick[key], (te.tick, key)
        prefill_lens += te.last_tick["prefill_lens"]
        if te.last_tick["decode_batch"]:
            _close(te.last_logits, je.last_logits)
        assert te.tick < 60
    assert sorted(prefill_lens) == [5, 12, 23, 40]
    done = {r.uid: (tuple(r.out_tokens), r.first_token_tick, r.done_tick) for r in te.finished}
    assert done == {r.uid: (tuple(r.out_tokens), r.first_token_tick, r.done_tick)
                    for r in je.finished}
    assert len(done) == 4 and te.stats == je.stats
    assert [dataclasses.astuple(c) for c in te.ledger.completions] == \
           [dataclasses.astuple(c) for c in je.ledger.completions]
    _check_cache(te.kv.cache, je.kv.cache)
    assert (ssd_scan_kernel.launches, argmax_last_kernel.launches) == before
