"""PyTorch port, the VLM family (pixtral-12b): frontend-extended sequences
(patch embeddings prepended to the text, RoPE positions over both, the
cache sized for both, the loss over the text positions only), the
serving of text requests through the continuous paged engine, and the
pipeline's frontend inputs, against the JAX package on the f32 pixtral
smoke config (16 patch embeddings), with the reference's `init_lm`
weights carried over by `params_from_numpy`, on the CPU. Also the one
gradient test of the three families this slice ports (hybrid, VLM,
encoder-decoder) against `jax.grad`.

Tolerances: logits, hidden states and f32 caches within 1e-4 absolute
and relative (tests/test_torch_transformer.py's budget: ATen's and
XLA's CPU matmuls sum in another order); a bf16 cache within one bf16
ulp (2^-7 relative) plus 1e-4; the loss within 1e-5 relative; gradients
within 1e-5 of the largest gradient element (tests/test_torch_train_step.py's
budget); engine streams, ticks and admissions identical; the pipeline's
batches bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.data.pipeline import build_for_arch as j_build_for_arch
from repro.models import build as j_build
from repro.models import transformer as jt
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import KVSpec as JKVSpec
from repro.serve import Request as JRequest
from repro.serve import make_engine as j_make_engine
from repro_torch.configs import ShapeCfg, get, get_smoke
from repro_torch.data.pipeline import build_for_arch
from repro_torch.models import transformer as tt
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, KVSpec, Request, make_engine
from repro_torch.train.train_step import value_and_grad
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.treeutil import tree_leaves

NAME = "pixtral-12b"
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


def _frontend(cfg, b, seed=1):
    """(B, n_frontend_tokens, d) f32 embeddings, N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(
        np.float32)


def test_configs_match_the_reference():
    """Every field of CONFIG and SMOKE (the dtype as a torch dtype) and the
    parameter count (12.2B)."""
    for mine, ref in ((get(NAME), j_get(NAME)), (get_smoke(NAME), j_get_smoke(NAME))):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert mine.param_count() == ref.param_count()
    assert get(NAME).param_count() == 12_247_777_280
    assert get(NAME).n_frontend_tokens == 256 and get(NAME).frontend == "vision"


def test_forward_lm_with_extra_embeds_matches_reference(lm):
    """`forward_lm(extra_embeds=)`: the hidden states over the 16 patches
    and the 20 tokens after them, within 1e-4."""
    jc, jp, tc, tp = lm
    toks, patches = _tokens(tc, 2, 20), _frontend(tc, 2)
    jh, _, _, _ = jt.forward_lm(jc, jp, jnp.asarray(toks), extra_embeds=jnp.asarray(patches),
                                remat=False)
    th, _, _, _ = tt.forward_lm(tc, tp, torch.from_numpy(toks).long(),
                                extra_embeds=torch.from_numpy(patches))
    assert tuple(th.shape) == (2, 36, tc.d_model)
    _close(th, jh)


def test_prefill_with_patches_matches_reference(lm):
    """`model.prefill(tokens, patches=)` with no cache: both packages size
    the (bf16) cache to tokens + 16 patches; last-position logits within
    1e-4, ``k``/``v`` over all 36 positions within one bf16 ulp, ``pos``
    = 36. Then the same prefill into f32 caches: ``k``/``v`` within 1e-4."""
    jc, jp, tc, tp = lm
    toks, patches = _tokens(tc, 2, 20, seed=2), _frontend(tc, 2, seed=3)
    jl, jcache, _ = j_build(jc).prefill(jp, jnp.asarray(toks), patches=jnp.asarray(patches))
    tl, tcache = build(tc, device="cpu").prefill(tp, torch.from_numpy(toks).long(),
                                                 patches=torch.from_numpy(patches))
    assert tuple(tcache["k"].shape) == jcache["k"].shape == (tc.n_layers, 2, 36, tc.d_kv)
    _close(tl, jl)
    for key in ("k", "v"):
        assert tcache[key].dtype == torch.bfloat16
        _close(tcache[key], jcache[key], **BF16_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 36
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks), jt.init_cache(jc, 2, 40, jnp.float32),
                                  extra_embeds=jnp.asarray(patches))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, 2, 40, torch.float32, "cpu"),
                               extra_embeds=torch.from_numpy(patches))
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


def test_decode_after_an_image_prompt_matches_reference(lm):
    """Prefill 16 patches + 12 tokens into a 36-position f32 cache, then
    six `decode_step_lm` ticks fed the reference's greedy tokens: logits
    and K/V each tick, the positions running on after the patches."""
    jc, jp, tc, tp = lm
    toks, patches = _tokens(tc, 2, 12, seed=4), _frontend(tc, 2, seed=5)
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks), jt.init_cache(jc, 2, 36, jnp.float32),
                                  extra_embeds=jnp.asarray(patches))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, 2, 36, torch.float32, "cpu"),
                               extra_embeds=torch.from_numpy(patches))
    j_decode = jax.jit(lambda p, c, t: jt.decode_step_lm(jc, p, c, t))
    for _ in range(6):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tt.decode_step_lm(tc, tp, tcache, torch.from_numpy(nxt).long())
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
    assert int(tcache["pos"]) == int(jcache["pos"]) == 34


def test_length_with_patches_is_refused_as_the_reference_refuses(lm):
    """A length-masked prefill of a frontend-extended sequence raises the
    reference's ValueError in both packages; the VLM keeps the paged
    decode and the verify step; a dense model's prefill takes no
    patches."""
    jc, jp, tc, tp = lm
    toks, patches = _tokens(tc, 1, 8), _frontend(tc, 1)
    msg = "length-masked prefill does not support extra_embeds"
    with pytest.raises(ValueError, match=msg):
        j_build(jc).prefill(jp, jnp.asarray(toks), length=5, patches=jnp.asarray(patches))
    model = build(tc, device="cpu")
    with pytest.raises(ValueError, match=msg):
        model.prefill(tp, torch.from_numpy(toks).long(), length=5,
                      patches=torch.from_numpy(patches))
    assert model.decode_step_paged is not None and model.verify_step is not None
    with pytest.raises(TypeError, match="patches"):
        build(get_smoke("tinyllama-1.1b"), device="cpu").prefill(
            {}, torch.zeros((1, 4), dtype=torch.long), patches=torch.from_numpy(patches))


def test_loss_matches_reference(lm):
    """`model.loss` with patches: the frontend positions are dropped
    before the cross-entropy over the masked text positions."""
    jc, jp, tc, tp = lm
    toks, labels = _tokens(tc, 2, 24, seed=8), _tokens(tc, 2, 24, seed=9)
    patches = _frontend(tc, 2, seed=10)
    mask = np.ones((2, 24), np.float32)
    mask[1, 17:] = 0
    jloss, jm = j_build(jc).loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                      "mask": jnp.asarray(mask), "patches": jnp.asarray(patches)})
    tloss, tm = build(tc, device="cpu").loss(tp, {"tokens": torch.from_numpy(toks).long(),
                                                  "labels": torch.from_numpy(labels).long(),
                                                  "mask": torch.from_numpy(mask),
                                                  "patches": torch.from_numpy(patches)})
    assert sorted(tm) == sorted(jm) == ["ce"]
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    text_only, _ = build(tc, device="cpu").loss(tp, {"tokens": torch.from_numpy(toks).long(),
                                                     "labels": torch.from_numpy(labels).long(),
                                                     "mask": torch.from_numpy(mask)})
    assert text_only.item() != tloss.item()


def _batch(cfg, seed: int) -> dict:
    """A masked numpy batch of 2 x 24 tokens, with the config's frontend
    embeddings."""
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 24), np.float32)
    mask[1, 13:] = 0.0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32), "mask": mask}
    key = {"audio": "frames", "vision": "patches"}.get(cfg.frontend)
    if key:
        out[key] = _frontend(cfg, 2, seed + 1)
    return out


@pytest.mark.parametrize("name", ["hymba-1.5b", "pixtral-12b", "whisper-small"])
def test_gradients_match_jax_grad(name):
    """Each family's loss and its gradient with respect to every parameter
    (f32 masters, `value_and_grad` as the train step takes it) against
    `jax.value_and_grad` of the reference's `model.loss`."""
    jc = dataclasses.replace(j_get_smoke(name), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    jmodel = j_build(jc)
    jp = jmodel.init(jax.random.PRNGKey(0))
    data = _batch(tc, seed=5)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, data))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu",
                               param_dtype=torch.float32)
    loss, _, grads = value_and_grad(build(tc, device="cpu").loss, params,
                                    {k: torch.from_numpy(v) for k, v in data.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = params_from_numpy(jax.tree.map(np.asarray, jgrads), tc, "cpu",
                             param_dtype=torch.float32)
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert [g.shape for g in got_leaves] == [g.shape for g in want_leaves]
    gmax = max(float(g.abs().max()) for g in want_leaves)
    for a, b in zip(want_leaves, got_leaves):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5 * gmax)


def _workload(vocab: int, n: int = 6):
    """Prompts of 3..14 tokens, half behind a shared 16-token prefix."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(3, 15)))
        if i % 2:
            prompt = np.concatenate([prefix, prompt])
        out.append((i, prompt.astype(np.int32), int(rng.integers(3, 8))))
    return out


def test_text_requests_through_the_continuous_paged_engine(lm):
    """Pixtral's text requests through the continuous engine (3 slots, paged
    store of 8-token blocks with the prefix cache) in lockstep with the
    reference's: every tick's admissions and decode batch, the logits of
    every decode tick, the streams and the prefix hits. (The reference's
    engine passes no patches, so an image prompt serves only through
    `model.prefill`.)"""
    jc, jp, tc, tp = lm
    kv = dict(kind="paged", block_size=8, prefix_cache=True)
    je = j_make_engine(j_build(jc), jp, JEngineConfig(mode="continuous", max_batch=3,
                                                      max_len=64, kv=JKVSpec(**kv)))
    te = make_engine(build(tc, device="cpu"), tp,
                     EngineConfig(mode="continuous", max_batch=3, max_len=64, kv=KVSpec(**kv)))
    for uid, prompt, m in _workload(tc.vocab_size):
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    while not (je.idle() and te.idle()):
        je.step()
        te.step()
        for key in ("prefill_lens", "decode_batch", "prefix_hit_tokens"):
            assert te.last_tick[key] == je.last_tick[key], (te.tick, key)
        if te.last_tick["decode_batch"]:
            _close(te.last_logits, je.last_logits)
        assert te.tick < 200
    got = {r.uid: (tuple(r.out_tokens), r.done_tick) for r in te.finished}
    want = {r.uid: (tuple(r.out_tokens), r.done_tick) for r in je.finished}
    assert got == want and len(got) == 6
    assert te.stats["prefix_hit_tokens"] == je.stats["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("name", ["pixtral-12b", "whisper-small"])
def test_build_for_arch_yields_the_reference_frontend_batches(name):
    """`build_for_arch` of a frontend architecture (the smoke config, skewed
    document lengths): every key of the global batch, ``patches`` /
    ``frames`` drawn after the tokens, bit for bit, and
    `padded_for_groups` over 3 compute rows of 4."""
    shape = ShapeCfg("frontend_smoke", 32, 5, "train")
    port = build_for_arch(get_smoke(name), shape, seed=3, skew=0.4)
    ref = j_build_for_arch(j_get_smoke(name), shape, seed=3, skew=0.4)
    key = {"pixtral-12b": "patches", "whisper-small": "frames"}[name]
    for step in (0, 1):
        for got, want in ((port.global_batch(step), ref.global_batch(step)),
                          (port.padded_for_groups(step, 3, 4), ref.padded_for_groups(step, 3, 4))):
            assert sorted(got) == sorted(want) == sorted(["tokens", "labels", "mask", key])
            for k in got:
                assert got[k].dtype == getattr(torch, str(np.asarray(want[k]).dtype)), k
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tuple(port.global_batch(0)[key].shape) == (5, get_smoke(name).n_frontend_tokens,
                                                     get_smoke(name).d_model)
