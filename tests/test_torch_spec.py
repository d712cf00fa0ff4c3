"""PyTorch port, speculative decoding: `layers.attention_verify`,
`transformer.verify_step_lm` and `serve.spec.SpecEngine` against the JAX
package's, on the same f32 qwen1.5 smoke weights (the reference test's
target) converted with `params_from_numpy`; the draft is the reference
test's noised copy of the target (`_noised`), converted the same way.

One JAX `SpecEngine` run per configuration (dense, paged, and dense with
the adapt loop) is made once in a module fixture, and every case reads
its results. Greedy mode against the reference: identical streams, ticks
(accepted, drafted and the draft batches of every tick), counters, ledger
acceptance and replans. Sampled mode is held to replay only: the port's
generator (`utils.prng`) gives other bits than `jax.random`.

Tolerances: `attention_verify` 1e-6 (the same f32 einsums and softmax);
the verify's logits 1e-4 against JAX and against k + 1 sequential decode
steps in the port (the budget of tests/test_torch_engine.py: other GEMM
shapes sum in another order; the reference's bitwise version of the
second comparison fails on every run, ROADMAP C), K/V rows one bf16 ulp
of their value (the cache is bf16 in both packages, and f32 rows ~1e-7
apart can round to neighbouring bf16 values).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import KVSpec as JKVSpec
from repro.serve import Request as JRequest
from repro.serve import SpecConfig as JSpecConfig
from repro.serve import make_engine as j_make_engine
from repro.serve import make_kvstore as j_make_kvstore
from repro_torch.configs import get_smoke
from repro_torch.models import layers
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, KVSpec, Request, SpecConfig, make_engine
from repro_torch.serve.kvstore import make_kvstore
from repro_torch.utils.convert import params_from_numpy

NAME = "qwen1.5-0.5b"
MAX_LEN = 64
SLOTS = 4
N_REQUESTS = 8
MAX_NEW = 8
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 values in [1, 2)


def _noised(params, eps: float):
    """Draft = target params + eps * N(0, 1) (the reference test's dial)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        leaf + eps * jax.random.normal(k, leaf.shape, leaf.dtype)
        if jnp.issubdtype(leaf.dtype, jnp.floating) else leaf
        for leaf, k in zip(leaves, keys)])


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(j_get_smoke(NAME), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    jm = j_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build(tc, device="cpu")

    def port(p):
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), tc, "cpu")

    drafts = {eps: _noised(jp, eps) for eps in (1e-3, 1e-2)}
    return {"j": (jm, jp), "t": (tm, port(jp)), "j_draft": drafts[1e-3],
            "t_draft": {0.0: port(jp), **{e: port(p) for e, p in drafts.items()}}}


def _requests(vocab: int):
    rng = np.random.RandomState(0)
    return [(u, rng.randint(1, vocab, rng.randint(4, 16)).astype(np.int32), MAX_NEW)
            for u in range(N_REQUESTS)]


def _drive(eng, on_tick=None) -> dict:
    """Drain, recording each tick's spec counters; the run's summary."""
    ticks = []
    while not eng.idle():
        eng.step()
        lt = eng.last_tick
        ticks.append(tuple(lt.get(k) for k in ("accepted", "drafted", "draft_batches",
                                                "verify", "spec_k", "draft_rows")))
        if on_tick is not None:
            on_tick(eng)
        assert eng.tick < 500, "engine did not drain"
    return {"streams": {r.uid: list(r.out_tokens) for r in eng.finished},
            "done": {r.uid: (r.first_token_tick, r.done_tick) for r in eng.finished},
            "ticks": ticks, "tick": eng.tick,
            "stats": {k: eng.stats.get(k) for k in ("accepted", "drafted", "verify_calls",
                                                   "draft_steps", "tokens_out", "prefills")},
            "acceptance": eng.ledger.acceptance_rate(),
            "replans": list(getattr(eng, "replans", []))}


def _kv(paged: bool, spec_cls):
    return spec_cls(kind="paged", block_size=4) if paged else spec_cls()


CONFIGS = {"dense": dict(paged=False), "paged": dict(paged=True),
           "adapt": dict(paged=False, adapt=True, report_window=2, cost_ratio=6.0)}


def _j_run(models, name):
    jm, jp = models["j"]
    kw = dict(CONFIGS[name])
    paged = kw.pop("paged")
    eng = j_make_engine(jm, jp, JSpecConfig(max_batch=SLOTS, max_len=MAX_LEN, spec_k=4,
                                            kv=_kv(paged, JKVSpec), **kw),
                        draft=(jm, models["j_draft"]))
    for uid, prompt, m in _requests(jm.cfg.vocab_size):
        eng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
    return _drive(eng)


def _t_engine(models, paged=False, eps=1e-3, **cfg_kw):
    tm, tp = models["t"]
    eng = make_engine(tm, tp, SpecConfig(max_batch=SLOTS, max_len=MAX_LEN,
                                         kv=_kv(paged, KVSpec), **{"spec_k": 4, **cfg_kw}),
                      draft=(tm, models["t_draft"][eps]))
    for uid, prompt, m in _requests(tm.cfg.vocab_size):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    return eng


def _t_run(models, name, **extra):
    kw = dict(CONFIGS[name])
    return _drive(_t_engine(models, **kw, **extra))


@pytest.fixture(scope="module")
def ref_runs(models):
    return {name: _j_run(models, name) for name in CONFIGS}


def _base_streams(models, paged: bool) -> dict:
    tm, tp = models["t"]
    eng = make_engine(tm, tp, EngineConfig(max_batch=SLOTS, max_len=MAX_LEN, mode="continuous",
                                           kv=_kv(paged, KVSpec)))
    for uid, prompt, m in _requests(tm.cfg.vocab_size):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    return _drive(eng)["streams"]


# -- the verify forward ---------------------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
def test_attention_verify_matches_reference(window):
    from repro.models import layers as jl

    rng = np.random.default_rng(0)
    b, sq, h, n_kv, hd, s = 3, 4, 6, 2, 8, 20
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    kc = rng.normal(size=(b, s, n_kv * hd)).astype(np.float32)
    vc = rng.normal(size=(b, s, n_kv * hd)).astype(np.float32)
    valid = np.array([[3, 4, 5, 6], [9, 10, 11, 12], [20, 20, 20, 20]], np.int32)
    got = layers.attention_verify(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), n_kv, torch.from_numpy(valid),
                                  window, 0.3)
    want = jl.attention_verify(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), n_kv,
                               jnp.asarray(valid), window, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def _verify_setup(models):
    """Both packages' dense stores holding prompts of 5, 9 and 3 tokens, and
    a ragged chunk (n_new 4, 2, 1)."""
    (jm, jp), (tm, tp) = models["j"], models["t"]
    batch, s_chunk, n_new = 3, 4, [4, 2, 1]
    rng = np.random.RandomState(3)
    chunk = rng.randint(1, tm.cfg.vocab_size, (batch, s_chunk)).astype(np.int32)
    js = j_make_kvstore(jm, batch, MAX_LEN, JKVSpec(), ragged=True)
    ts = [make_kvstore(tm, batch, MAX_LEN, KVSpec(), ragged=True) for _ in range(2)]
    for slot, plen in enumerate((5, 9, 3)):
        prompt = rng.randint(1, tm.cfg.vocab_size, (1, plen)).astype(np.int32)
        js.admit(slot, jm.prefill(jp, jnp.asarray(prompt))[1], plen)
        _, c1 = tm.prefill(tp, torch.from_numpy(prompt))
        for st in ts:
            st.admit(slot, c1, plen)
    return chunk, n_new, js, ts


def _rows_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


def test_verify_step_matches_reference(models):
    (jm, jp), (tm, tp) = models["j"], models["t"]
    chunk, n_new, js, (ts, _) = _verify_setup(models)
    active = [0, 1, 2]
    jl, jc = jm.verify_step(jp, js.view(active), jnp.asarray(chunk), jnp.asarray(n_new))
    js.absorb_span(jc, active, n_new)
    tl, tc = tm.verify_step(tp, ts.view(active), torch.from_numpy(chunk),
                            torch.tensor(n_new, dtype=torch.int32))
    ts.absorb_span(tc, active, n_new)
    assert tl.shape == (3, 4, tm.cfg.vocab_size)
    for i in active:
        np.testing.assert_allclose(tl[i, : n_new[i]].numpy(), np.asarray(jl[i, : n_new[i]]),
                                   **LOGIT_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), [9, 11, 4])
    for key in ("k", "v"):
        _rows_close(ts.cache[key].float().numpy(), np.asarray(js.cache[key], np.float32))
    assert list(ts.lens) == list(js.lens) == [9, 11, 4]


def test_verify_step_equals_sequential_decode(models):
    """The port's own contract: one width-(k+1) verify forward equals k + 1
    sequential `decode_step_lm` calls (ragged n_new: rows stop writing
    and attending where their chunk ends), logits within 1e-4, K/V rows
    within one bf16 ulp, the same lengths."""
    tm, tp = models["t"]
    chunk, n_new, _, (seq, ver) = _verify_setup(models)
    seq_logits = np.zeros((3, 4, tm.cfg.vocab_size), np.float32)
    for j in range(4):
        active_j = [i for i in range(3) if n_new[i] > j]
        logits, cache = tm.decode_step(tp, seq.view(active_j),
                                       torch.from_numpy(chunk[:, j : j + 1]))
        seq.absorb(cache, active_j)
        for i in active_j:
            seq_logits[i, j] = logits[i, -1].numpy()
    logits, vcache = tm.verify_step(tp, ver.view([0, 1, 2]), torch.from_numpy(chunk),
                                    torch.tensor(n_new, dtype=torch.int32))
    ver.absorb_span(vcache, [0, 1, 2], n_new)
    for i in range(3):
        np.testing.assert_allclose(logits[i, : n_new[i]].numpy(), seq_logits[i, : n_new[i]],
                                   **LOGIT_TOL)
    for key in ("k", "v"):
        _rows_close(ver.cache[key].float().numpy(), seq.cache[key].float().numpy())
    assert list(seq.lens) == list(ver.lens)


def test_verify_step_refuses_ssm_and_a_shared_cursor(models):
    tm, tp = models["t"]
    ssm = build(dataclasses.replace(get_smoke("mamba2-130m"), dtype=torch.float32),
                device="cpu")
    assert ssm.verify_step is None
    from repro_torch.models import transformer

    with pytest.raises(ValueError, match="attention-only"):
        transformer.verify_step_lm(ssm.cfg, {}, {"pos": torch.zeros(2, dtype=torch.int32)},
                                   torch.zeros((2, 3), dtype=torch.int32), torch.ones(2))
    cache = tm.init_cache(2, 16)
    with pytest.raises(ValueError, match="ragged-only"):
        tm.verify_step(tp, cache, torch.zeros((2, 3), dtype=torch.int32),
                       torch.ones(2, dtype=torch.int32))


# -- the engine against the reference -------------------------------------------


@pytest.mark.parametrize("name", ["dense", "paged", "adapt"])
def test_spec_engine_matches_reference(models, ref_runs, name):
    """The same target, draft and requests through both packages'
    `SpecEngine` (greedy, k = 4): identical streams, first-token and done
    ticks, per-tick accepted / drafted / draft batches / verify shape,
    counters and ledger acceptance; with the adapt loop (a replan every
    two ticks, the planner's cost ratio 6), identical replans."""
    got, want = _t_run(models, name), ref_runs[name]
    for key in ("streams", "done", "ticks", "tick", "stats", "acceptance"):
        assert got[key] == want[key], key
    assert got["stats"]["drafted"] > 0 and 0 < got["acceptance"] < 1
    assert [(r["tick"], r["from"], r["to"]) for r in got["replans"]] == \
           [(r["tick"], r["from"], r["to"]) for r in want["replans"]]
    for a, b in zip(got["replans"], want["replans"]):
        assert a["acceptance"] == pytest.approx(b["acceptance"], rel=1e-12)
        assert a["predicted_speedup"] == pytest.approx(b["predicted_speedup"], rel=1e-12)
    if name == "adapt":
        assert got["replans"], "the adapt loop never replanned"


def test_spec_adapt_regroups_its_service_graph(models):
    """With a mesh, the engine lays its draft and verify rows out as a
    ServiceGraph joined by the bidirectional (compute, verify) edge, and a
    replan regroups it to the new split."""
    from repro_torch.core.dataflow import COMPUTE
    from repro_torch.launch.mesh import Mesh

    tm, tp = models["t"]
    eng = make_engine(tm, tp, SpecConfig(max_batch=SLOTS, max_len=MAX_LEN, adapt=True,
                                         report_window=2, cost_ratio=6.0),
                      draft=(tm, models["t_draft"][1e-3]), mesh=Mesh(n_rows=8, device="cpu"))
    g = eng.graph
    assert g.is_bidirectional(COMPUTE, "verify") and g.is_bidirectional("verify", COMPUTE)
    assert g.gmesh.group("verify").size == 6
    for uid, prompt, m in _requests(tm.cfg.vocab_size):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    _drive(eng)
    assert eng.replans
    assert eng.graph.gmesh.group("verify").size == eng.n_rows - eng.draft_rows
    assert eng.graph.is_bidirectional(COMPUTE, "verify")


# -- the reference test's contracts, in the port ---------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_greedy_equals_target_only(models, paged):
    """Greedy speculative streams equal the target-only engine's, and
    nothing leaks: both stores drain to zero blocks."""
    eng = _t_engine(models, paged=paged)
    run = _drive(eng)
    assert run["streams"] == _base_streams(models, paged)
    assert run["stats"]["drafted"] > 0 and run["stats"]["verify_calls"] > 0
    if paged:
        assert eng.kv.stats["blocks_in_use"] == 0 and eng.draft_kv.stats["blocks_in_use"] == 0


def test_spec_acceptance_falls_with_disagreement(models):
    """Identical weights accept every draft; acceptance falls as the draft
    is noised away from the target."""
    accs = []
    for eps in (0.0, 1e-3, 1e-2):
        run = _drive(_t_engine(models, eps=eps))
        accs.append(run["stats"]["accepted"] / max(1, run["stats"]["drafted"]))
    assert accs[0] == 1.0, accs
    assert all(a >= b for a, b in zip(accs, accs[1:])) and accs[-1] < accs[0], accs


def test_spec_paged_refcounts_exact_and_draft_in_step(models):
    """At every tick: private blocks in use equal the live-token block
    demand in both stores, and the draft store's lengths equal the target
    store's for every live slot (the catch-up step after a full accept);
    both pools drain to zero."""
    eng = _t_engine(models, paged=True)
    full_accepts = []
    verdict = eng._greedy_verdict

    def spy(active, chunk, n_draft, targets):
        accepts, corrected = verdict(active, chunk, n_draft, targets)
        full_accepts.extend(accepts[i] == n_draft[i] > 0 for i in active)
        return accepts, corrected

    eng._greedy_verdict = spy

    def check(e):
        for store in (e.kv, e.draft_kv):
            st = store.stats
            assert st["blocks_in_use"] - st.get("evictable_blocks", 0) == \
                st["live_block_demand"], st
        live = [i for i, s in enumerate(e.slots) if s is not None]
        assert [int(e.draft_kv.lens[i]) for i in live] == [int(e.kv.lens[i]) for i in live]

    _drive(eng, on_tick=check)
    assert any(full_accepts), "no slot accepted every draft: the catch-up went untested"
    assert eng.kv.stats["blocks_in_use"] == 0 and eng.draft_kv.stats["blocks_in_use"] == 0


def test_spec_survives_preemption(models):
    """A preemption of two slots shrinks the pool (overflow re-queued, none
    lost), the slots come back after the notice period, and the streams
    still equal target-only greedy."""
    from repro_torch.serve.faults import FaultEvent

    eng = _t_engine(models, paged=True)
    for _ in range(3):
        eng.step()
    eng.inject_fault(FaultEvent(eng.tick, "preempt", rows=2, duration=3))
    assert eng.cfg.max_batch == SLOTS - 2 and eng.tokens.shape == (SLOTS - 2, 1)
    run = _drive(eng)
    assert eng.cfg.max_batch == SLOTS
    assert run["streams"] == _base_streams(models, paged=True)
    assert eng.kv.stats["blocks_in_use"] == 0 and eng.draft_kv.stats["blocks_in_use"] == 0


def test_spec_sampled_mode_replays(models):
    """Seeded rejection sampling replays under a fixed seed and differs
    under another; every request still gets its tokens."""
    runs = [_drive(_t_engine(models, spec_mode="sampled", seed=s)) for s in (3, 3, 4)]
    assert runs[0]["streams"] == runs[1]["streams"] and runs[0]["ticks"] == runs[1]["ticks"]
    assert runs[0]["streams"] != runs[2]["streams"]
    assert all(len(v) == MAX_NEW for v in runs[0]["streams"].values())


def test_spec_config_validation(models):
    tm, tp = models["t"]
    for kw in (dict(mode="aligned"), dict(spec_k=0), dict(spec_mode="argmax-ish"),
               dict(n_rows=8, draft_rows=8)):
        with pytest.raises(ValueError):
            SpecConfig(**kw)
    with pytest.raises(ValueError, match="SpecConfig-only"):
        make_engine(tm, tp, EngineConfig(mode="continuous"), draft=(tm, tp))
    with pytest.raises(ValueError, match="share a vocabulary"):
        wide = build(dataclasses.replace(get_smoke(NAME), vocab_size=600,
                                         dtype=torch.float32), device="cpu")
        make_engine(tm, tp, SpecConfig(max_len=MAX_LEN), draft=(wide, wide.init(0)))
    assert JSpecConfig().spec_k == SpecConfig().spec_k and \
        JEngineConfig().max_batch == EngineConfig().max_batch


def test_sampled_verdict_first_token_is_distributed_as_p():
    """The rejection rule's guarantee: with drafts drawn from q, the first
    emitted token of a tick is distributed as the target's p. 5 ticks of
    2,000 rows over a 5-word vocabulary (synthetic p and q, k = 1); a
    chi-square test against p at the 0.1 % level (4 degrees of freedom:
    18.47)."""
    from types import SimpleNamespace

    from repro_torch.serve.spec import SpecEngine
    from repro_torch.utils import prng

    p = np.array([0.4, 0.25, 0.2, 0.1, 0.05])
    q = np.array([0.1, 0.3, 0.1, 0.2, 0.3])
    rows, ticks = 2000, 5
    logits = torch.log(torch.from_numpy(p)).float().expand(rows, 2, 5)
    counts = np.zeros(5)
    for tick in range(1, ticks + 1):
        fake = SimpleNamespace(_base_key=prng.key(11), tick=tick)
        d = prng.categorical(prng.fold_in(prng.key(12), tick),
                             torch.log(torch.from_numpy(q)).expand(rows, 5)).numpy()
        chunk = np.stack([np.zeros(rows, np.int64), d], axis=1)
        q_rows = [np.broadcast_to(q, (rows, 5))]
        accepts, corrected = SpecEngine._sampled_verdict(
            fake, list(range(rows)), chunk, {i: 1 for i in range(rows)}, logits, q_rows)
        for i in range(rows):
            counts[d[i] if accepts[i] else corrected[i]] += 1
    expected = p * rows * ticks
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 18.47, (chi2, counts, expected)


# -- the example -----------------------------------------------------------------


def test_serve_lm_spec_example(tmp_path):
    """`python -m repro_torch.examples.serve_lm --smoke --device cpu --spec
    --paged` runs and prints its acceptance line; its streams equal the
    same example's target-only streams."""
    import os
    import subprocess
    import sys

    from repro_torch.examples import serve_lm

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    argv = ["--smoke", "--device", "cpu", "--spec", "--paged"]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.examples.serve_lm", *argv],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[speculative k=4+paged] served 10 requests" in proc.stdout
    assert "speculative: acceptance rate" in proc.stdout
    streams = [{r.uid: r.out_tokens for r in serve_lm.main(a)["engine"].finished}
               for a in (argv, argv[:3] + ["--paged"])]
    assert streams[0] == streams[1] and len(streams[0]) == 10
    with pytest.raises(SystemExit, match="--spec composes"):
        serve_lm.parse_args(["--spec", "--fail-at", "3"])
