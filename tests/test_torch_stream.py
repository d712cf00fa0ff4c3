"""PyTorch port, the stream layer in one process: `StreamChunker`, the
stream operators, the copied `perfmodel` and `imbalance`, MapReduce's
corpus, packing and fold, and the accumulating plain histogram, each held
against the JAX package on the same numpy inputs.

Tolerances: `StreamChunker`, the corpus, its layout, the imbalance draws,
the packed elements and every histogram are exact (integer-valued f32
counts sum exactly in any order); `perfmodel` 1e-12 relative (a copy,
the same arithmetic); `sum_op` 1e-6 relative (the same f32 additions in
the same order); `workload_stats_op` exact on min, max and count, 1e-6
relative on the median (numpy's mean of the two middle samples on both
sides).
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import mapreduce as jmr
from repro.core import imbalance as jimb
from repro.core import operators as jops
from repro.core import perfmodel as jpm
from repro.core import stream as jstream
from repro_torch.apps import mapreduce as tmr
from repro_torch.core import imbalance as timb
from repro_torch.core import operators as tops
from repro_torch.core import perfmodel as tpm
from repro_torch.core import stream as tstream
from repro_torch.kernels.stream_reduce import ops as reduce_ops


def _tree(rng):
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(11,)).astype(np.float32),
            "s": np.float32(rng.normal()), "ids": rng.integers(0, 50, size=(3, 2))
            .astype(np.int32)}


# -- StreamChunker -----------------------------------------------------------------

@pytest.mark.parametrize("chunk_elems", [1, 7, 16, 64, 1000, 0])
def test_stream_chunker_matches_jax(chunk_elems):
    tree = _tree(np.random.default_rng(chunk_elems))
    jplan = jstream.StreamChunker.plan({k: jnp.asarray(v) for k, v in tree.items()},
                                       chunk_elems)
    tplan = tstream.StreamChunker.plan({k: torch.from_numpy(np.asarray(v))
                                        for k, v in tree.items()}, chunk_elems)
    for attr in ("chunk_elems", "n_chunks", "padded", "element_bytes", "total_bytes"):
        assert getattr(tplan, attr) == getattr(jplan, attr), attr
    assert tplan.overhead_calls() == jplan.overhead_calls()
    jpacked = np.asarray(jplan.pack({k: jnp.asarray(v) for k, v in tree.items()}))
    tpacked = tplan.pack({k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()})
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    back = tplan.unpack(tpacked)
    for k, v in tree.items():
        assert back[k].dtype == torch.from_numpy(np.asarray(v)).dtype
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("nbytes", [1, 3, 64, 1000, 65536])
def test_granularity_from_bytes_matches_jax(nbytes):
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                   (jnp.int8, torch.int8)):
        assert tstream.granularity_from_bytes(nbytes, td) == \
            jstream.granularity_from_bytes(nbytes, jd)


# -- stream operators --------------------------------------------------------------

def _fold(op_apply, state, elements):
    for k, e in enumerate(elements):
        state = op_apply(state, e, k)
    return state


def _jfold(op, elements):
    state = op.init()
    for k, e in enumerate(elements):
        state = op.apply(state, jnp.asarray(e), jnp.int32(k))
    return state


def _tfold(op, elements):
    return _fold(op.apply, op.init(), [torch.from_numpy(e) for e in elements])


def test_sum_op_matches_jax():
    elems = np.random.default_rng(1).normal(size=(9, 33)).astype(np.float32)
    want = np.asarray(_jfold(jops.sum_op(33), elems))
    got = _tfold(tops.sum_op(33, device="cpu"), elems).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n_bins", [7, 64, 500])
def test_histogram_op_matches_jax(n_bins):
    """Negative keys are padding; keys at and past n_bins land in the last
    bin (the reference clips them; the port clamps before the kernel)."""
    rng = np.random.default_rng(n_bins)
    kpe = 40
    elems = []
    for _ in range(6):
        keys = rng.integers(-3, n_bins + 5, size=kpe).astype(np.float32)
        counts = rng.integers(0, 4, size=kpe).astype(np.float32)
        elems.append(np.asarray(jops.pack_kv(jnp.asarray(keys), jnp.asarray(counts), 2 * kpe + 6)))
        tpacked = tops.pack_kv(torch.from_numpy(keys), torch.from_numpy(counts), 2 * kpe + 6)
        np.testing.assert_array_equal(tpacked.numpy(), elems[-1])
    want = np.asarray(_jfold(jops.histogram_op(n_bins, kpe), elems))
    got = _tfold(tops.histogram_op(n_bins, kpe, device="cpu"), elems).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[n_bins - 1] > 0


@pytest.mark.parametrize("n_elems", [3, 4, 11])
def test_buffer_op_matches_jax(n_elems):
    """A ring of 4 rows: 11 elements wrap around it twice."""
    elems = np.random.default_rng(n_elems).normal(size=(n_elems, 6)).astype(np.float32)
    jbuf, jptr = _jfold(jops.buffer_op(4, 6), elems)
    tbuf, tptr = _tfold(tops.buffer_op(4, 6, device="cpu"), elems)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert int(tptr) == int(jptr) == n_elems


@pytest.mark.parametrize("n_elems", [0, 1, 6, 7, 70])
def test_workload_stats_op_matches_jax(n_elems):
    """Odd and even counts (the median's two middle samples), and more
    samples than the 64 slots (the last slot is overwritten)."""
    elems = np.random.default_rng(n_elems).normal(size=(n_elems, 8)).astype(np.float32)
    want = jops.finalize_workload_stats(_jfold(jops.workload_stats_op(64), elems))
    got = tops.finalize_workload_stats(_tfold(tops.workload_stats_op(64, device="cpu"), elems))
    for k in ("min", "max", "count"):
        assert float(got[k]) == float(want[k]), k
    if n_elems:
        np.testing.assert_allclose(float(got["median"]), float(want["median"]), rtol=1e-6)
    else:
        assert math.isnan(float(got["median"])) and math.isnan(float(want["median"]))


# -- perfmodel (a copy) ------------------------------------------------------------

def _flat(x) -> list:
    if dataclasses.is_dataclass(x):
        return _flat(dataclasses.asdict(x))
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in [k, *_flat(x[k])]]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [x]


def _perf_case(m, name: str, p: int):
    def congest(total, n, n1):
        return 0.05 * math.log2(max(n1, 2)) + 6e-3 * n1

    prof = m.WorkloadProfile(t_w0=1.0, t_w1=0.4, d_bytes=2.9e12 / 8192, sigma=0.08,
                             t_w1_prime=congest)
    plain = m.WorkloadProfile(t_w0=2.0, t_w1=0.7, d_bytes=1e9, sigma=0.02)
    costs = m.StreamCosts(o_seconds=2e-6)
    stages = [m.StageWorkload("reduce", 0.3, 1e8), m.StageWorkload("io", 0.1, 5e7)]
    serve = m.ServeWorkload(prompt_tokens=512, decode_tokens=128, t_prefill_token=2e-4,
                            t_decode_token=1e-2, kv_bytes_per_token=4096, prompt_cv=1.2)
    cases = {
        "t_sigma": lambda: m.t_sigma(0.08, p),
        "default_beta": lambda: m.default_beta(64e3 * p, 1e9),
        "t_conventional": lambda: m.t_conventional(prof, p),
        "t_decoupled": lambda: [m.t_decoupled(w, p, a, 64e3, costs, pessimistic_max=pm)
                                for w in (prof, plain) for a in (1 / 16, 1 / 8, 1 / 4)
                                for pm in (False, True)],
        "speedup": lambda: m.speedup(plain, p, 0.125, 64e3, costs),
        "memory_bytes": lambda: [m.memory_bytes(1e9, 64e3 * p, b) for b in (False, True)],
        "optimal_alpha": lambda: [m.optimal_alpha(w, p, 64e3, costs) for w in (prof, plain)],
        "optimal_granularity": lambda: m.optimal_granularity(plain, p, 0.125, costs),
        "chain": lambda: [m.t_conventional_chain(1.0, stages, 0.05, p),
                          m.t_decoupled_chain(1.0, stages, 0.05, p, {"reduce": 2, "io": 1},
                                              64e3, costs),
                          m.chain_speedup(1.0, stages, 0.05, p, {"reduce": 2, "io": 1},
                                          64e3, costs)],
        "recommend_allocation": lambda: m.recommend_allocation(1.0, stages, 0.05, p, 64e3,
                                                               costs, row_budget=min(p // 2, 16)),
        "serve": lambda: [m.t_colocated_serve(serve, p),
                          m.t_disagg_serve(serve, p, 0.25, 64e3, costs),
                          m.serve_speedup(serve, p, 0.25, 64e3, costs),
                          m.recommend_disaggregation(serve, p, 64e3, costs)],
        "spec": lambda: [m.spec_expected_tokens(0.7, 4),
                         m.t_spec_serve(1e-3, lambda k: 5e-3 + 1e-4 * k, 0.7, 4, 1, p),
                         m.recommend_spec_split(1e-3, lambda k: 5e-3 + 1e-4 * k, 0.7, p)],
        "criteria": lambda: [m.decoupling_criteria(m.OperationTraits(orthogonal=True,
                                                                     high_variance=True)),
                             m.recommend_decoupling(m.OperationTraits(orthogonal=True)),
                             m.prefill_traits(serve)],
    }
    return _flat(cases[name]())


PERF_NAMES = ["t_sigma", "default_beta", "t_conventional", "t_decoupled", "speedup",
              "memory_bytes", "optimal_alpha", "optimal_granularity", "chain",
              "recommend_allocation", "serve", "spec", "criteria"]


@pytest.mark.parametrize("p", [8, 32, 2048, 8192])
@pytest.mark.parametrize("name", PERF_NAMES)
def test_perfmodel_matches_jax(name, p):
    want, got = _perf_case(jpm, name, p), _perf_case(tpm, name, p)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0.0)
        else:
            assert g == w


# -- imbalance (a copy, draw for draw) ---------------------------------------------

@pytest.mark.parametrize("kind", ["gaussian", "lognormal", "pareto"])
def test_imbalance_draws_match_jax(kind):
    jm = jimb.ImbalanceModel(kind=kind, mean=200.0, sigma=0.3)
    tm = timb.ImbalanceModel(kind=kind, mean=200.0, sigma=0.3)
    for fn in (lambda m, r: m.sample_process_times(64, r),
               lambda m, r: m.sample_lengths(64, r, minimum=4, cap=500)):
        np.testing.assert_array_equal(fn(tm, np.random.default_rng(3)),
                                      fn(jm, np.random.default_rng(3)))
    assert tm.expected_t_sigma(16, n_trials=8) == jm.expected_t_sigma(16, n_trials=8)


@pytest.mark.parametrize("skew", [0.0, 0.5, 1.0])
def test_partitions_and_estimators_match_jax(skew):
    for n_parts in (1, 7, 64):
        np.testing.assert_array_equal(
            timb.skewed_partition(10_000, n_parts, skew, np.random.default_rng(5)),
            jimb.skewed_partition(10_000, n_parts, skew, np.random.default_rng(5)))
        np.testing.assert_array_equal(timb.sheet_partition(10_000, n_parts, skew, 0.3),
                                      jimb.sheet_partition(10_000, n_parts, skew, 0.3))
    work = np.random.default_rng(6).random((5, 8)) * (1 + skew)
    assert timb.empirical_t_sigma_work(work) == jimb.empirical_t_sigma_work(work)
    assert timb.empirical_sigma(work, 0.5) == jimb.empirical_sigma(work, 0.5)


# -- MapReduce: corpus, layout, packing, the fold ----------------------------------

CORPORA = [jmr.CorpusCfg(n_docs_per_row=4, words_per_doc=256, vocab=500, skew=0.7),
           jmr.CorpusCfg(n_docs_per_row=3, words_per_doc=100, vocab=64, skew=0.0, seed=3),
           jmr.CorpusCfg(n_docs_per_row=8, words_per_doc=1024, vocab=2048, skew=0.8)]


@pytest.mark.parametrize("ci", range(len(CORPORA)))
def test_corpus_and_layout_match_jax(ci):
    jcfg = CORPORA[ci]
    tcfg = tmr.CorpusCfg(**dataclasses.asdict(jcfg))
    total = jcfg.n_docs_per_row * 8
    jt, jm = jmr.make_corpus(jcfg, total)
    tt, tm = tmr.make_corpus(tcfg, total)
    assert tt.dtype == np.int32 and tm.dtype == np.float32
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    for work_rows in (8, 6, 5):
        jlt, jlm = jmr.layout_corpus(jt, jm, work_rows, 8)
        tlt, tlm = tmr.layout_corpus(tt, tm, work_rows, 8)
        np.testing.assert_array_equal(tlt, np.asarray(jlt))
        np.testing.assert_array_equal(tlm, np.asarray(jlm))
        for r in range(8):
            rt, rm = tmr.row_docs(tt, tm, r, work_rows, 8)
            np.testing.assert_array_equal(rt, tlt[r])
            np.testing.assert_array_equal(rm, tlm[r])


@pytest.mark.parametrize("granularity", [7, 256, 100_000])
def test_word_elements_and_fold_match_jax(granularity):
    """`_pack_word_elements` (ragged tail included) and the reducer's fold
    over every element, against the reference's; the map's local
    histogram against the reference's and `np.bincount`."""
    cfg = CORPORA[0]
    jt, jm = jmr.make_corpus(cfg, 4)
    tt, tm = tmr.make_corpus(tmr.CorpusCfg(**dataclasses.asdict(cfg)), 4)
    jel, js = jmr._pack_word_elements(jt, jm, granularity)
    tel, ts = tmr._pack_word_elements(torch.from_numpy(tt), torch.from_numpy(tm), granularity)
    assert ts == js
    np.testing.assert_array_equal(tel.numpy(), np.asarray(jel))
    jacc = jnp.zeros((cfg.vocab,), jnp.float32)
    jop = jmr._hist_operator(cfg.vocab, js)
    for k in range(jel.shape[0]):
        jacc = jop(jacc, jel[k], k)
    tacc = _fold(tops.histogram_fold(cfg.vocab, ts), torch.zeros(cfg.vocab), list(tel))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    want = np.bincount(tt[tm > 0], minlength=cfg.vocab)
    np.testing.assert_array_equal(tacc.numpy(), want)
    local = tmr._local_histogram(torch.from_numpy(tt), torch.from_numpy(tm), cfg.vocab)
    np.testing.assert_array_equal(local.numpy(), np.asarray(jmr._local_histogram(jt, jm,
                                                                                   cfg.vocab)))


# -- the accumulating plain histogram ----------------------------------------------

@pytest.mark.parametrize("n_bins", [1, 10, 4096])
def test_keyed_histogram_accumulates_like_index_add(n_bins):
    """``keyed_histogram(..., out=acc)`` on the CPU adds into ``acc`` in
    place, exactly `index_add_` of the kept keys (0 <= key < n_bins)."""
    rng = np.random.default_rng(n_bins)
    keys = torch.from_numpy(rng.integers(-2, n_bins + 3, size=5000).astype(np.int32))
    counts = torch.from_numpy(rng.integers(0, 3, size=5000).astype(np.float32))
    acc = torch.from_numpy(rng.integers(0, 100, size=n_bins).astype(np.float32))
    keep = (keys >= 0) & (keys < n_bins)
    want = acc.clone().index_add_(0, keys[keep].long(), counts[keep])
    got = reduce_ops.keyed_histogram(keys, counts, n_bins, out=acc)
    assert got is acc
    assert torch.equal(acc, want)
    fresh = reduce_ops.keyed_histogram(keys, counts, n_bins)
    assert torch.equal(fresh, torch.zeros(n_bins).index_add_(0, keys[keep].long(),
                                                             counts[keep]))


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride"])
def test_keyed_histogram_refuses_a_bad_accumulator(bad):
    keys = torch.zeros(4, dtype=torch.int32)
    counts = torch.ones(4)
    out = {"dtype": torch.zeros(8, dtype=torch.float64), "shape": torch.zeros(9),
           "stride": torch.zeros(16)[::2]}[bad]
    with pytest.raises(ValueError, match="out must be"):
        reduce_ops.keyed_histogram(keys, counts, 8, out=out)
