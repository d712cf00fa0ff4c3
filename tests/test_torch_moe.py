"""PyTorch port, the MoE family: `repro_torch.models.moe` and the MoE
branches of `transformer`, `model_zoo` and the serving engines against
the JAX package, on the mixtral-8x7b and llama4-scout-17b-a16e smoke
configs in f32 (4 experts each: top-2; top-1 beside a shared expert),
with the reference's `init_lm` weights carried over by
`utils.convert.params_from_numpy`, on the CPU.

The reference's dispatch and combine tensors are read from its own
`apply_moe` by wrapping the `jnp.einsum` its module calls (a proxy set
on `repro.models.moe.jnp` for the test; nothing in the JAX package
changes); the port's come from its `moe.route`.

The gradient of ``ce + 0.01 * aux_loss`` against `jax.grad` (through
the router's softmax, the combine weights, the index dispatch, the
expert products, the ragged tail and ``me``), and `apply_moe` routed
over the rows of a world (`RouteWorld`; the rows are threads sharing one
process here) against the reference's on the global batch.

Tolerances, each relative to the largest magnitude of the tensor held
(random expert weights at 1/sqrt(E) make the MoE's output reach several
hundred at d_model 128):
- f32: the dispatch identical, the combine weights within 1e-6
  absolute (probabilities from the same f32 softmax), the MoE's output
  within 1e-5 of its largest magnitude, the aux metrics within 1e-6
  relative; the loss's gradient within 1e-5 of its largest element (the
  budget of tests/test_torch_train_step.py); logits through a whole model within 1e-4 of their largest
  magnitude (the budget of tests/test_torch_transformer.py: ATen's and
  XLA's CPU matmuls sum in another order), K/V within 1e-4.
- bf16: the dispatch identical, the output within `BF16_OUT` of its
  largest magnitude: both packages round every expert product and the
  SwiGLU gate to bf16 (2^-8 of an element each), in another order and,
  for the gate, another formula (ATen's silu rounds once, jax.nn.silu
  rounds x * sigmoid(x)); four bf16 ulps of the largest element hold
  that, a dropped or misrouted token moves its row by about its size.
- Greedy streams (the continuous engine over the paged store with the
  prefix cache; `SpecEngine` with a noised draft) identical to the
  reference engine's, in lockstep.
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
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import KVSpec as JKVSpec
from repro.serve import Request as JRequest
from repro.serve import SpecConfig as JSpecConfig
from repro.serve import make_engine as j_make_engine
from repro_torch.configs import get, get_smoke
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tt
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, KVSpec, Request, SpecConfig, make_engine
from repro_torch.utils.convert import params_from_numpy

NAMES = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
OUT_REL = 1e-5
LOGIT_REL = 1e-4
BF16_OUT = 2.0 ** -6  # four bf16 ulps of the largest element


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the tier-1 run shares the cores
    between its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=NAMES)
def lm(request):
    """(name, jax cfg, jax params, port cfg, port params), f32 smoke."""
    name = request.param
    jc = dataclasses.replace(j_get_smoke(name), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return name, jc, jp, tc, tp


def _rel_close(got, want, rel):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_the_reference(name):
    """Every field of CONFIG and SMOKE (the dtype as a torch dtype), the
    windows, and both parameter counts (the reference's `param_count`:
    46.7B and 107.8B)."""
    for mine, ref in ((get(name), j_get(name)), (get_smoke(name), j_get_smoke(name))):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert mine.layer_windows() == ref.layer_windows()
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
    assert get(name).param_count() == {"mixtral-8x7b": 46_702_788_608,
                                       "llama4-scout-17b-a16e": 107_769_856_000}[name]


def test_build_gives_the_serving_entry_points():
    """Both full configs build (no weights made) with the paged decode and
    the verify step; an MoE model's train step builds (one row: the
    conventional step on the whole batch; its worlds are held in
    tests/test_torch_train_moe.py)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainStepConfig, make_step

    for name in NAMES:
        m = build(get(name), device="cpu")
        assert m.decode_step_paged is not None and m.verify_step is not None
    assert callable(make_step(build(get_smoke("mixtral-8x7b"), device="cpu"),
                              Mesh(n_rows=1, device="cpu"), OptConfig(), TrainStepConfig()))


@pytest.mark.parametrize("group", [1, 4, 8, 31, 100, 512, 1024])
def test_capacity_matches_reference(group):
    for e in (4, 8, 16):
        for k in (1, 2):
            for factor in (0.5, 1.0, 1.25, 2.0, 3.3):
                assert moe._capacity(group, e, k, factor) == \
                    j_moe._capacity(group, e, k, factor), (group, e, k, factor)


@pytest.mark.parametrize("chunk", [1, 4, 32])
def test_chunked_local_mask_matches_reference(chunk):
    q = np.array([0, 3, 4, 31, 32, 33, 70], np.int32)
    k = np.arange(72, dtype=np.int32)
    got = layers.chunked_local_mask(torch.from_numpy(q), torch.from_numpy(k), chunk)
    want = j_layers.chunked_local_mask(jnp.asarray(q), jnp.asarray(k), chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_lm_matches_reference_tree(lm):
    """The port's own init: the reference's tree, shapes, storage dtypes
    and the experts' 1/sqrt(E) scale (fan-in from the first axis)."""
    _, _, jp, tc, _ = lm
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
    w = mine["layers"][0]["moe"]["w_gate"].float()
    assert abs(w.std().item() * np.sqrt(tc.n_experts) - 1.0) < 0.05


# -- the MoE layer ---------------------------------------------------------------


class _Einsums:
    """Stands in for `jnp` in the reference's moe module while it is traced:
    records the dispatch and combine operands of its einsums, and
    computes them."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec in ("gtec,gtd->gecd", "gtec,gecd->gtd"):
            self.seen[spec] = ops[0]
        return jnp.einsum(spec, *ops, **kw)


def _ref_moe(monkeypatch, jc, p, x, dtype):
    """The reference's `apply_moe` under `jax.jit` -> (y, aux, dispatch,
    combine), the last two as its einsums received them."""
    cap = _Einsums()
    monkeypatch.setattr(j_moe, "jnp", cap)

    def run(p, x):
        y, aux = j_moe.apply_moe(p, x, jc, dtype)
        return y, aux, cap.seen["gtec,gtd->gecd"], cap.seen["gtec,gecd->gtd"]

    y, aux, disp, comb = jax.jit(run)(p, x)
    monkeypatch.setattr(j_moe, "jnp", jnp)
    return (np.asarray(y.astype(jnp.float32)), aux, np.asarray(disp, np.float32),
            np.asarray(comb, np.float32))


def _port_dispatch(r: moe.Route, e: int):
    """The port's route as the reference's (g, t, E, C) dispatch and
    combine tensors."""
    k, g, t = r.choice.shape
    disp = np.zeros((g, t, e, r.capacity), np.float32)
    comb = np.zeros_like(disp)
    probs = r.probs.numpy()
    for i in range(k):
        gi, ti = np.nonzero(r.keep[i].numpy())
        ch, sl = r.choice[i].numpy()[gi, ti], r.slot[i].numpy()[gi, ti]
        disp[gi, ti, ch, sl] = 1.0
        comb[gi, ti, ch, sl] = probs[gi, ti, ch]
    return disp, comb


def _moe_pair(monkeypatch, jc, jp, tc, tp, x, layer=0, jdtype=jnp.float32,
              tdtype=torch.float32):
    """Both packages' `apply_moe` on ``x`` (numpy (B, S, d)) with layer
    ``layer``'s weights -> (port y, port aux, port route, ref y, ref aux,
    ref dispatch, ref combine)."""
    jpm = jax.tree_util.tree_map(lambda a: a[layer], jp["layers"]["moe"])
    jy, jaux, jdisp, jcomb = _ref_moe(monkeypatch, jc, jpm, jnp.asarray(x).astype(jdtype),
                                      jdtype)
    routes = []
    real_route = moe.route

    def recording(*a, **kw):
        routes.append(real_route(*a, **kw))
        return routes[-1]

    monkeypatch.setattr(moe, "route", recording)
    ty, taux = moe.apply_moe(tp["layers"][layer]["moe"], torch.from_numpy(x).to(tdtype), tc,
                             tdtype)
    return ty, taux, routes[0], jy, jaux, jdisp, jcomb


@pytest.mark.parametrize("shape", [(8, 1), (4, 64), (1, 1100)],
                         ids=["decode-8", "prefill-4x64", "ragged-tail-1100"])
def test_apply_moe_matches_reference(lm, monkeypatch, shape):
    """f32: the same tokens in the same slots (and dropped alike), the same
    combine weights, the output and the aux metrics. 1,100 tokens make one
    group of 1,024 and a tail of 76 through expert 0."""
    _, jc, jp, tc, tp = lm
    b, s = shape
    x = np.random.default_rng(1).normal(size=(b, s, tc.d_model)).astype(np.float32)
    ty, taux, r, jy, jaux, jdisp, jcomb = _moe_pair(monkeypatch, jc, jp, tc, tp, x, layer=1)
    disp, comb = _port_dispatch(r, tc.n_experts)
    np.testing.assert_array_equal(disp, jdisp)
    np.testing.assert_allclose(comb, jcomb, rtol=0, atol=1e-6)
    g, t = r.choice.shape[1:]
    tail = b * s - g * t
    assert tail == (76 if shape == (1, 1100) else 0)
    if tail:  # the tail really went through expert 0
        assert np.abs(jy.reshape(-1, tc.d_model)[-tail:]).max() > 0
    _rel_close(ty, jy, OUT_REL)
    for key in ("aux_loss", "router_entropy"):
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]), rtol=1e-6)


def test_apply_moe_drops_under_a_skewed_router(lm, monkeypatch):
    """A router skewed toward expert 0 overflows its capacity: the
    reference drops tokens, and the port drops the same ones."""
    _, jc, jp, tc, tp = lm
    skew = np.zeros((tc.n_layers, tc.d_model, tc.n_experts), np.float32)
    skew[..., 0] = 0.5
    jp = jax.tree_util.tree_map(lambda a: a, jp)
    jp["layers"]["moe"]["router"]["w"] = jp["layers"]["moe"]["router"]["w"] + skew
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    x = np.abs(np.random.default_rng(2).normal(size=(4, 64, tc.d_model))).astype(np.float32)
    ty, taux, r, jy, jaux, jdisp, _ = _moe_pair(monkeypatch, jc, jp, tc, tp, x)
    kept = jdisp.sum()
    assert kept < x.shape[0] * x.shape[1] * tc.experts_per_token  # drops happened
    assert (r.choice[0] == 0).float().mean() > 0.9
    disp, _ = _port_dispatch(r, tc.n_experts)
    np.testing.assert_array_equal(disp, jdisp)
    _rel_close(ty, jy, OUT_REL)
    np.testing.assert_allclose(taux["aux_loss"].item(), float(jaux["aux_loss"]), rtol=1e-6)


def test_apply_moe_bf16_matches_reference(lm, monkeypatch):
    """bf16 weights and activations: the dispatch identical, the output
    within `BF16_OUT` of its largest magnitude."""
    _, jc, jp, tc, _ = lm
    jb = dataclasses.replace(jc, dtype=jnp.bfloat16)
    tb = dataclasses.replace(tc, dtype=torch.bfloat16)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tb, "cpu")
    x = np.random.default_rng(3).normal(size=(4, 64, tc.d_model)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    ty, _, r, jy, _, jdisp, _ = _moe_pair(monkeypatch, jb, jp, tb, tp, x,
                                          jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_port_dispatch(r, tc.n_experts)[0], jdisp)
    _rel_close(ty, jy, BF16_OUT)


# -- the model -------------------------------------------------------------------


@pytest.mark.parametrize("length", ["none", "ragged"])
def test_prefill_matches_reference(lm, length):
    """Last-position logits and the f32 cache: an unpadded buffer of 3 x
    20 tokens (60 tokens: one group), and a packed ragged one of 3 x 400
    (one group of 1,024 and a tail of 176, bucket padding routed too)."""
    _, jc, jp, tc, tp = lm
    b, s = (3, 20) if length == "none" else (3, 400)
    toks = _tokens(tc, b, s)
    lens = None if length == "none" else np.array([400, 211, 5], np.int32)
    jl, jcache, jaux = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                     jt.init_cache(jc, b, s, jnp.float32),
                                     length=None if lens is None else jnp.asarray(lens))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, b, s, torch.float32, "cpu"),
                               length=None if lens is None else torch.from_numpy(lens))
    _rel_close(tl, jl, LOGIT_REL)
    for key in ("k", "v"):
        _rel_close(tcache[key], jcache[key], LOGIT_REL)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_forward_lm_aux_is_the_layer_mean(lm):
    """`forward_lm`'s aux: each metric's mean over the layers, as the
    reference's."""
    _, jc, jp, tc, tp = lm
    toks = _tokens(tc, 2, 24, seed=7)
    _, jaux, _, _ = jt.forward_lm(jc, jp, jnp.asarray(toks), remat=False)
    _, taux, kv, states = tt.forward_lm(tc, tp, torch.from_numpy(toks).long())
    assert kv is None and states is None and sorted(taux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]), rtol=1e-5)


def test_decode_step_lm_matches_reference(lm):
    """Four ragged decode steps after a packed prefill (lengths 10, 7, 3)
    into a 12-token f32 cache, fed the reference's greedy tokens; the
    first slot reaches the end and then writes nothing, but is routed."""
    _, jc, jp, tc, tp = lm
    b, s, max_len = 3, 10, 12
    toks = _tokens(tc, b, s, seed=3)
    lens = np.array([10, 7, 3], np.int32)
    jl, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                  jt.init_cache(jc, b, max_len, jnp.float32),
                                  length=jnp.asarray(lens))
    tl, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                               tt.init_cache(tc, b, max_len, torch.float32, "cpu"),
                               length=torch.from_numpy(lens))
    j_decode = jax.jit(lambda p, c, t: jt.decode_step_lm(jc, p, c, t))
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tt.decode_step_lm(tc, tp, tcache, torch.from_numpy(nxt).long())
        _rel_close(tl, jl, LOGIT_REL)
        for key in ("k", "v"):
            _rel_close(tcache[key], jcache[key], LOGIT_REL)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_decode_step_paged_matches_reference(lm):
    """The paged step's plain route over a random f32 pool: four slots
    (mid-block, inactive, fresh, block boundary), logits and K/V rows."""
    _, jc, jp, tc, tp = lm
    rng = np.random.default_rng(1)
    ln, nb, bs, mb = tc.n_layers, 9, 4, 3
    k = rng.normal(size=(ln, nb, bs, tc.d_kv)).astype(np.float32)
    v = rng.normal(size=(ln, nb, bs, tc.d_kv)).astype(np.float32)
    k[:, 0] = v[:, 0] = 0
    tables = np.array([[3, 5, -1], [-1, -1, -1], [-1, -1, -1], [1, 8, -1]], np.int32)
    pos = np.array([6, mb * bs, 0, 8], np.int32)
    arrays = {"k_pool": k, "v_pool": v, "tables": tables, "pos": pos}
    tv = {key: torch.from_numpy(a) for key, a in arrays.items()}
    jv = {key: jnp.asarray(a) for key, a in arrays.items()}
    tv["rows_like"], jv["rows_like"] = torch.zeros((0,)), jnp.zeros((0,), jnp.float32)
    tok = _tokens(tc, 4, 1, seed=2)
    jl, jk, jvv = jt.decode_step_paged_lm(jc, jp, jv, jnp.asarray(tok))
    tl, tk, tvv = tt.decode_step_paged_lm(tc, tp, tv, torch.from_numpy(tok).long(), impl="ref")
    _rel_close(tl, jl, LOGIT_REL)
    _rel_close(tk, jk, LOGIT_REL)
    _rel_close(tvv, jvv, LOGIT_REL)


def test_verify_step_matches_reference(lm):
    """A packed prefill of prompts of 5, 9 and 3 tokens into ragged f32
    caches, then one verify forward of a ragged chunk (n_new 4, 2, 1): the
    B x S tokens route as one group, padding included. Logits and K/V."""
    _, jc, jp, tc, tp = lm
    batch, s_chunk, max_len = 3, 4, 16
    lens = np.array([5, 9, 3], np.int32)
    n_new = np.array([4, 2, 1], np.int32)
    toks = _tokens(tc, batch, 9, seed=4)
    chunk = _tokens(tc, batch, s_chunk, seed=5)
    _, jcache, _ = jt.prefill_lm(jc, jp, jnp.asarray(toks),
                                 jt.init_cache(jc, batch, max_len, jnp.float32),
                                 length=jnp.asarray(lens))
    _, tcache = tt.prefill_lm(tc, tp, torch.from_numpy(toks).long(),
                              tt.init_cache(tc, batch, max_len, torch.float32, "cpu"),
                              length=torch.from_numpy(lens))
    jl, jcache = jt.verify_step_lm(jc, jp, jcache, jnp.asarray(chunk), jnp.asarray(n_new))
    tl, tcache = tt.verify_step_lm(tc, tp, tcache, torch.from_numpy(chunk).long(),
                                   torch.from_numpy(n_new))
    for i in range(batch):
        _rel_close(tl[i, : n_new[i]], jl[i, : n_new[i]], LOGIT_REL)
    for key in ("k", "v"):
        _rel_close(tcache[key], jcache[key], LOGIT_REL)
    np.testing.assert_array_equal(tcache["pos"].numpy(), [9, 11, 4])


def test_loss_matches_reference(lm):
    """`model.loss`: ce + 0.01 * aux_loss and its three metrics."""
    _, jc, jp, tc, tp = lm
    toks, labels = _tokens(tc, 2, 24, seed=8), _tokens(tc, 2, 24, seed=9)
    mask = np.ones((2, 24), np.float32)
    mask[1, 17:] = 0
    jloss, jm = j_build(jc).loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                      "mask": jnp.asarray(mask)})
    tloss, tm = build(tc, device="cpu").loss(tp, {"tokens": torch.from_numpy(toks).long(),
                                                  "labels": torch.from_numpy(labels).long(),
                                                  "mask": torch.from_numpy(mask)})
    assert sorted(tm) == sorted(jm) == ["aux_loss", "ce", "router_entropy"]
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for key in jm:
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-5)
    assert tloss.item() == pytest.approx(tm["ce"].item() + 0.01 * tm["aux_loss"].item(),
                                         rel=1e-6)


# -- serving ---------------------------------------------------------------------


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


def test_continuous_engine_matches_reference(lm):
    """The continuous engine (3 slots, paged store of 8-token blocks with
    the prefix cache) in lockstep with the reference's: every tick's
    admissions and decode batch, the logits of every decode tick, the
    streams and the prefix hits."""
    _, jc, jp, tc, tp = lm
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
            _rel_close(te.last_logits, je.last_logits, LOGIT_REL)
        assert te.tick < 200
    got = {r.uid: (tuple(r.out_tokens), r.done_tick) for r in te.finished}
    want = {r.uid: (tuple(r.out_tokens), r.done_tick) for r in je.finished}
    assert got == want and len(got) == 6
    assert te.stats["prefix_hit_tokens"] == je.stats["prefix_hit_tokens"] > 0


def _noised(params, eps: float):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        leaf + eps * jax.random.normal(k, leaf.shape, leaf.dtype) for leaf, k in zip(leaves, keys)])


def _spec_drive(eng, requests, request_cls) -> dict:
    for uid, prompt, m in requests:
        eng.submit(request_cls(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    ticks = []
    while not eng.idle():
        eng.step()
        ticks.append(tuple(eng.last_tick.get(k) for k in ("accepted", "drafted", "verify")))
        assert eng.tick < 300
    return {"streams": {r.uid: list(r.out_tokens) for r in eng.finished}, "ticks": ticks,
            "stats": {k: eng.stats.get(k) for k in ("accepted", "drafted", "verify_calls",
                                                   "tokens_out")}}


def test_spec_engine_matches_reference():
    """`SpecEngine` (greedy, k = 4, dense store) on the mixtral smoke target
    with a noised draft, against the reference's: identical streams,
    per-tick accepted / drafted / verify, and counters. Greedy spec is
    not held to greedy decoding for MoE: the verify routes B x S tokens
    where a decode step routes B, so capacity and drops differ."""
    name = "mixtral-8x7b"
    jc = dataclasses.replace(j_get_smoke(name), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    jm, tm = j_build(jc), build(tc, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    jd = _noised(jp, 1e-2)

    def port(p):
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), tc, "cpu")

    reqs = _workload(tc.vocab_size, n=4)
    want = _spec_drive(j_make_engine(jm, jp, JSpecConfig(
        max_batch=3, max_len=64, spec_k=4), draft=(jm, jd)), reqs, JRequest)
    got = _spec_drive(make_engine(tm, port(jp), SpecConfig(
        max_batch=3, max_len=64, spec_k=4), draft=(tm, port(jd))), reqs, Request)
    assert got == want
    assert got["stats"]["drafted"] > 0


def test_moe_takes_no_environment_variable(monkeypatch):
    """The reference's REPRO_MOE_GROUP and REPRO_MOE_CAP change nothing
    in the port."""
    tc = dataclasses.replace(get_smoke("mixtral-8x7b"), dtype=torch.float32, n_layers=1)
    p = tt.init_lm(tc, torch.Generator().manual_seed(0), "cpu")["layers"][0]["moe"]
    x = torch.randn((2, 40, tc.d_model), generator=torch.Generator().manual_seed(1))
    want, _ = moe.apply_moe(p, x, tc, torch.float32)
    monkeypatch.setenv("REPRO_MOE_GROUP", "16")
    monkeypatch.setenv("REPRO_MOE_CAP", "0.1")
    got, _ = moe.apply_moe(p, x, tc, torch.float32)
    assert torch.equal(got, want) and moe.DEFAULT_GROUP == 1024


# -- the gradient, and routing over the rows of a world ------------------------------


def _skewed(jp, tc, weight: float = 0.5):
    """The reference's params with every router pushed toward expert 0."""
    skew = np.zeros((tc.n_layers, tc.d_model, tc.n_experts), np.float32)
    skew[..., 0] = weight
    jp = jax.tree_util.tree_map(lambda a: a, jp)
    jp["layers"]["moe"]["router"]["w"] = jp["layers"]["moe"]["router"]["w"] + skew
    return jp


@pytest.mark.parametrize("case", ["masked-2x24", "drops-4x64", "ragged-tail-1x1100"])
def test_loss_gradient_matches_jax(lm, case):
    """`value_and_grad` of `model.loss` (``ce + 0.01 * aux_loss``) against
    `jax.grad` on the reference's f32 params: every leaf within 1e-5 of
    the largest gradient element. ``drops``: a router skewed toward
    expert 0 overflows its capacity (the spare row's tokens get no
    gradient through the experts); ``ragged-tail``: one group of 1,024
    and 76 tokens through expert 0, unweighted."""
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.utils.treeutil import tree_leaves

    _, jc, jp, tc, _ = lm
    b, s = {"masked-2x24": (2, 24), "drops-4x64": (4, 64), "ragged-tail-1x1100": (1, 1100)}[case]
    if case.startswith("drops"):
        jp = _skewed(jp, tc)
    toks, labels = _tokens(tc, b, s, seed=11), _tokens(tc, b, s, seed=12)
    mask = np.ones((b, s), np.float32)
    mask[-1, s // 2:] = 0.0
    data = {"tokens": toks, "labels": labels, "mask": mask}
    (jloss, jm), jgrads = jax.value_and_grad(j_build(jc).loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in data.items()})
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu",
                           param_dtype=torch.float32)
    loss, metrics, grads = value_and_grad(build(tc, device="cpu").loss, tp,
                                          {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jgrads), tc, "cpu",
                             param_dtype=torch.float32)
    gmax = max(float(g.abs().max()) for g in tree_leaves(want))
    for a, g in zip(tree_leaves(want), tree_leaves(grads)):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0, atol=1e-5 * gmax)
    router = [lay["moe"]["router"]["w"] for lay in grads["layers"]]
    assert all(float(g.abs().max()) > 0 for g in router)  # the router learns


class _ThreadMesh:
    """The collectives `moe.RouteWorld` uses, for rows that are threads of
    one process: all-gather in row order and sum, each a barrier."""

    def __init__(self, n_rows: int):
        import threading

        self.n_rows = n_rows
        self.slots = [None] * n_rows
        self.barrier = threading.Barrier(n_rows)
        self.calls = [0] * n_rows

    def row_view(self, row: int):
        mesh = self

        class View:
            n_rows = mesh.n_rows

            def __init__(self):
                self.row = row

            def _swap(self, t):
                mesh.calls[row] += 1
                mesh.barrier.wait()
                mesh.slots[row] = t.clone()
                mesh.barrier.wait()
                every = list(mesh.slots)
                mesh.barrier.wait()
                return every

            def all_gather(self, t):
                return torch.cat(self._swap(t))

            def all_reduce(self, t):
                return torch.stack(self._swap(t)).sum(0)

        return View()


def _moe_over_rows(tc, p, x: torch.Tensor, n_rows: int, *, grad: bool = False):
    """`apply_moe` on each of ``n_rows`` equal shards of ``x`` routed over
    the rows (threads) -> per row (y, aux), and the collectives each row
    ran. With ``grad``, each row also takes its gradient of its
    ``aux_share`` (the layer under `torch.utils.checkpoint`, so the
    backward recomputes it from the stash)."""
    from concurrent.futures import ThreadPoolExecutor
    from torch.utils.checkpoint import checkpoint

    mesh = _ThreadMesh(n_rows)
    shards = x.chunk(n_rows)

    def run(row):
        torch.set_num_threads(1)
        world = moe.RouteWorld(mesh.row_view(row))
        world.start()
        xs = shards[row].clone().requires_grad_(grad)
        if grad:
            y, aux = checkpoint(moe.apply_moe, p, xs, tc, torch.float32, world.at(0),
                                use_reentrant=False)
            (g,) = torch.autograd.grad(aux["aux_share"], xs)
            return y.detach(), {k: v.detach() for k, v in aux.items()}, g
        y, aux = moe.apply_moe(p, xs, tc, torch.float32, world=world.at(0))
        return y, aux, None

    with ThreadPoolExecutor(n_rows) as pool:
        out = list(pool.map(run, range(n_rows)))
    return out, mesh.calls


@pytest.mark.parametrize("group,shape,rows", [(1024, (4, 40), 4), (48, (4, 40), 4),
                                              (64, (8, 32), 4), (1024, (2, 1100), 2)],
                         ids=["one-group-straddles", "groups-straddle-tail",
                              "whole-groups", "ragged-tail"])
def test_apply_moe_over_rows_matches_the_global_batch(lm, monkeypatch, group, shape, rows):
    """Rows routing their shards over a world give the reference's
    `apply_moe` on the global batch: every token's output (capacity slots
    counted in global token order, a group straddling rows), the global
    ``aux_loss`` and ``router_entropy`` on every row, and shares of
    ``aux_loss`` that sum to it; the reference's group size is set with
    its own REPRO_MOE_GROUP, the port's module constant alike. Per-row
    routing of the same shards differs."""
    _, jc, jp, tc, tp = lm
    monkeypatch.setenv("REPRO_MOE_GROUP", str(group))
    monkeypatch.setattr(moe, "DEFAULT_GROUP", group)
    b, s = shape
    x = np.random.default_rng(5).normal(size=(b, s, tc.d_model)).astype(np.float32)
    jpm = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["moe"])
    jy, jaux = jax.jit(lambda p, x: j_moe.apply_moe(p, x, jc, jnp.float32))(jpm, jnp.asarray(x))
    jy = np.asarray(jy)
    p = tp["layers"][1]["moe"]
    out, calls = _moe_over_rows(tc, p, torch.from_numpy(x), rows)
    got = torch.cat([y for y, _, _ in out]).numpy()
    _rel_close(got, jy, OUT_REL)
    for _, aux, _ in out:
        for key in ("aux_loss", "router_entropy"):
            np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-6)
    np.testing.assert_allclose(sum(float(aux["aux_share"]) for _, aux, _ in out),
                               float(jaux["aux_loss"]), rtol=1e-6)
    assert calls == [tc.experts_per_token + 1] * rows  # a count exchange a round, one sum
    per_row = torch.cat([moe.apply_moe(p, xs, tc, torch.float32)[0]
                         for xs in torch.from_numpy(x).chunk(rows)]).numpy()
    err = float(np.abs(per_row - jy).max()) / float(np.abs(jy).max())
    assert err > 100 * OUT_REL or shape == (8, 32)  # whole groups: per row is the same


def test_route_world_recompute_runs_no_collective_again(lm):
    """Under `torch.utils.checkpoint` the backward recomputes the layer
    from the stashed exchanges: each row's collectives run once, and the
    rows' gradients of their ``aux_share`` sum to the gradient of the
    global ``aux_loss`` in one process (the reference's routing of the
    global batch)."""
    _, _, _, tc, tp = lm
    p = tp["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 30, tc.d_model))
                         .astype(np.float32))
    out, calls = _moe_over_rows(tc, p, x, 4, grad=True)
    assert calls == [tc.experts_per_token + 1] * 4
    xg = x.clone().requires_grad_(True)
    _, aux = moe.apply_moe(p, xg, tc, torch.float32)
    (want,) = torch.autograd.grad(aux["aux_loss"], xg)
    got = torch.cat([g for _, _, g in out])
    _rel_close(got, want.numpy(), 1e-5)
    world = moe.RouteWorld(_ThreadMesh(1).row_view(0))
    world.start()
    with pytest.raises(RuntimeError, match="one forward pass"):
        world.start()
