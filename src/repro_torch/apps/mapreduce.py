"""MapReduce word histogram: the paper's Sec. IV-B case study (a port of
the reference's `apps/mapreduce.py`).

Reference implementation (the paper's map and reduce coupled on all
processes): every row maps its documents to a local histogram, and one
sum over the world combines them; the reduce's cost grows with P.

Decoupled implementations (the paper's map group, reduce group and
master), on a `ServiceGraph`:

  decoupled   two groups, one edge (compute -> reduce). Map rows stream
              ``[keys | counts]`` elements of S words as they are packed;
              reduce rows fold each arriving element into their histogram
              (`histogram_fold`: the keyed-histogram kernel on the card,
              adding into the accumulator); a sum within the reduce group
              (the "master" step) completes the reduction.
  pipelined   a chain compute -> reduce -> ... -> io (the paper's Fig.
              3c): each intermediate stage forwards its per-wave histogram
              delta while the upstream stage folds the next wave; the sink
              sums them, and its group sum completes the total.

Counts are integer-valued f32, so every summation order gives the same
bits while each bin stays under 2^24, and all modes agree bit for bit.
Keys travel as f32 (exact below 2^24).

Everything but the host entry point `wordcount_world` is this rank's part of
the computation (`launch.mesh`); the corpus is numpy on the host, and
each rank moves only its own rows' documents to its device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.channel import StreamChannel
from repro_torch.core.dataflow import (
    ServiceGraph,
    Stage,
    delta_emitter,
    sink_sum_stage,
    work_vector,
)
from repro_torch.core.decouple import conventional_allreduce, group_psum
from repro_torch.core.groups import COMPUTE, GroupedMesh
from repro_torch.core.imbalance import skewed_partition
from repro_torch.core.operators import histogram_fold
from repro_torch.kernels.stream_reduce import ops as reduce_ops

MODES = ("reference", "decoupled", "pipelined")


@dataclasses.dataclass(frozen=True)
class CorpusCfg:
    n_docs_per_row: int = 8
    words_per_doc: int = 512
    vocab: int = 1024
    skew: float = 0.8  # natural-language irregularity (paper Sec. IV-B)
    seed: int = 0


def make_corpus(cfg: CorpusCfg, total_docs: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens (total_docs, words) int32, mask f32) with Zipf word ids and
    skewed document lengths (the paper's variable-size log files): the
    reference's draws from the same generator, so the same numbers."""
    rng = np.random.default_rng(cfg.seed)
    shape = (total_docs, cfg.words_per_doc)
    tokens = rng.zipf(1.4, size=shape)
    np.remainder(tokens, cfg.vocab, out=tokens)
    tokens = tokens.astype(np.int32)
    lengths = np.clip(skewed_partition(total_docs * cfg.words_per_doc, total_docs, cfg.skew,
                                       rng), 1, cfg.words_per_doc)
    mask = (np.arange(cfg.words_per_doc)[None, :] < lengths[:, None]).astype(np.float32)
    return tokens, mask


def row_docs(tokens: np.ndarray, mask: np.ndarray, row: int, work_rows: int,
             n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Row ``row``'s documents under `layout_corpus` (``layout_corpus(...)[r]``
    without building the whole layout): the corpus in order, ``ceil(docs /
    work_rows)`` documents per row, the tail and the service rows padded
    with zero-masked documents."""
    if not 0 <= row < n_rows:
        raise ValueError(f"row {row} outside [0, {n_rows})")
    total_docs, words = tokens.shape
    per_row = -(-total_docs // work_rows)
    lo, hi = min(row * per_row, total_docs), min((row + 1) * per_row, total_docs)
    t = np.zeros((per_row, words), tokens.dtype)
    m = np.zeros((per_row, words), np.float32)
    t[:hi - lo] = tokens[lo:hi]
    m[:hi - lo] = mask[lo:hi]
    return t, m


def layout_corpus(tokens: np.ndarray, mask: np.ndarray, work_rows: int, n_rows: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The same documents over ``work_rows`` rows (service rows get only
    padding): the paper's identical total workload for both
    implementations (Sec. IV-A). Returns (n_rows, per_row, words) arrays."""
    rows = [row_docs(tokens, mask, r, work_rows, n_rows) for r in range(n_rows)]
    return np.stack([t for t, _ in rows]), np.stack([m for _, m in rows])


@contextlib.contextmanager
def _phase(mesh, phases: dict | None, name: str):
    """Adds the synchronised seconds of the block to ``phases[name]``
    (nothing is synchronised when ``phases`` is None)."""
    if phases is None:
        yield
        return
    mesh.sync()
    t0 = time.perf_counter()
    yield
    mesh.sync()
    phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0


def _local_histogram(tokens: torch.Tensor, mask: torch.Tensor, vocab: int) -> torch.Tensor:
    """The map: word -> (word, 1) pairs folded locally; the mask is the
    count (the keyed-histogram kernel on the card)."""
    return reduce_ops.keyed_histogram(tokens.reshape(-1), mask.reshape(-1), vocab)


def _pack_word_elements(tokens: torch.Tensor, mask: torch.Tensor, granularity_words: int
                        ) -> tuple[torch.Tensor, int]:
    """One row's documents as (n_chunks, 2S) f32 ``[keys | counts]``
    elements of S words; masked words and the padded tail carry key -1."""
    flat = tokens.reshape(-1)
    m = mask.reshape(-1)
    n = flat.shape[0]
    s = min(granularity_words, n)
    n_chunks = -(-n // s)
    keys = torch.where(m > 0, flat, -1).float()
    pad = n_chunks * s - n
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), -1.0)])
        m = torch.cat([m, m.new_zeros((pad,))])
    return torch.cat([keys.reshape(n_chunks, s), m.reshape(n_chunks, s)], dim=1), s


def _zero_hist(vocab: int, device) -> torch.Tensor:
    return torch.zeros((vocab,), dtype=torch.float32, device=device)


# -- reference: all rows map AND reduce (coupled) -------------------------------

def reference_wordcount(tokens, mask, vocab: int, gmesh: GroupedMesh, *,
                        phases: dict | None = None) -> torch.Tensor:
    """Local map, then one sum over the world (the paper's Fig. 3a)."""
    with _phase(gmesh.mesh, phases, "map_s"):
        local = _local_histogram(tokens, mask, vocab)
    with _phase(gmesh.mesh, phases, "group_sum_s"):
        return conventional_allreduce(local, gmesh)


# -- decoupled: the map group streams, the reduce group folds --------------------

def _stream_hist(channel: StreamChannel, tokens, mask, vocab: int, granularity_words: int,
                 phases: dict | None, probe: bool):
    mesh = channel.mesh
    with _phase(mesh, phases, "map_s"):
        elements, s = _pack_word_elements(tokens, mask, granularity_words)
    fold = histogram_fold(vocab, s)
    init = _zero_hist(vocab, mesh.device)
    if probe:
        def op(state, elem, k):
            acc, seen = state
            return fold(acc, elem, k), seen + elem[s:].sum()

        init = (init, torch.zeros((), dtype=torch.float32, device=mesh.device))
    else:
        op = fold
    with _phase(mesh, phases, "stream_s"):
        return channel.stream_fold(elements, op, init)


def decoupled_wordcount(tokens, mask, vocab: int, graph: ServiceGraph,
                        granularity_words: int = 256, *, phases: dict | None = None
                        ) -> torch.Tensor:
    """Map rows stream ``[keys | counts]`` elements of S words; reduce rows
    fold each as it arrives, then the reduce group's sum (the paper's
    master aggregation) completes it; the result goes to every row."""
    channel = graph.channel(COMPUTE, "reduce")
    partial = _stream_hist(channel, tokens, mask, vocab, granularity_words, phases, False)
    with _phase(channel.mesh, phases, "group_sum_s"):
        total = group_psum(partial, graph.gmesh, "reduce")
    with _phase(channel.mesh, phases, "broadcast_s"):
        return channel.broadcast_from_consumer(total)


def decoupled_wordcount_measured(tokens, mask, vocab: int, graph: ServiceGraph,
                                 granularity_words: int = 256, *, phases: dict | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`decoupled_wordcount` plus the adaptive loop's counters: (histogram,
    per-row mapped-word vector, reduce-stage word count). The stage count
    is folded THROUGH the channel beside the histogram, so it counts
    exactly the elements that arrived."""
    channel = graph.channel(COMPUTE, "reduce")
    partial, folded = _stream_hist(channel, tokens, mask, vocab, granularity_words, phases,
                                   True)
    with _phase(channel.mesh, phases, "group_sum_s"):
        total = group_psum(partial, graph.gmesh, "reduce")
        stage_words = group_psum(folded, graph.gmesh, "reduce")
    work = work_vector(graph.gmesh, mask.sum())
    with _phase(channel.mesh, phases, "broadcast_s"):
        return (channel.broadcast_from_consumer(total), work,
                channel.broadcast_from_consumer(stage_words))


# -- pipelined: a chain of service groups (paper Fig. 3c) ------------------------

def pipelined_wordcount(tokens, mask, vocab: int, graph: ServiceGraph, chain: tuple[str, ...],
                        granularity_words: int = 256, *, phases: dict | None = None
                        ) -> torch.Tensor:
    """A chained graph compute -> chain[0] -> ... -> chain[-1]: the head
    stage folds word histograms per wave, each later stage sums the
    previous stage's per-wave delta while the upstream stage folds the
    next wave (`ServiceGraph.run`), and the sink group's sum completes
    the total, returned to every row bit for bit."""
    mesh = graph.gmesh.mesh
    with _phase(mesh, phases, "map_s"):
        elements, s = _pack_word_elements(tokens, mask, granularity_words)
    zero = _zero_hist(vocab, mesh.device)
    stages = [Stage(src=COMPUTE, dst=chain[0], operator=histogram_fold(vocab, s), init=zero,
                    elements=elements, emit=delta_emitter(zero) if len(chain) > 1 else None)]
    for i in range(1, len(chain)):
        relay = sink_sum_stage(chain[i - 1], chain[i], vocab, device=mesh.device)
        if i < len(chain) - 1:
            relay = dataclasses.replace(relay, emit=delta_emitter(relay.init))
        stages.append(relay)
    with _phase(mesh, phases, "stream_s"):
        accs = graph.run_chain(stages)
    with _phase(mesh, phases, "group_sum_s"):
        total = group_psum(accs[-1], graph.gmesh, chain[-1])
    with _phase(mesh, phases, "broadcast_s"):
        return graph.broadcast_from(chain[-1], total)


def wordcount_graph(mesh, mode: str, alpha: float, chain_alphas: dict[str, float] | None = None
                    ) -> tuple[ServiceGraph | None, GroupedMesh, tuple[str, ...]]:
    """(graph, gmesh, chain) of one mode; graph is None for the reference.
    ``chain_alphas`` names the pipelined mode's downstream stages in
    order (default one io sink of alpha / 2). The map -> reduce edge is
    declared identity: keys travel as f32, which a lossy codec would
    corrupt."""
    if mode == "reference":
        return None, GroupedMesh.trivial(mesh), ()
    head_wire = {(COMPUTE, "reduce"): "identity"}
    if mode == "decoupled":
        graph = ServiceGraph.build(mesh, stages={"reduce": alpha}, edges=[(COMPUTE, "reduce")],
                                   wire=head_wire)
        return graph, graph.gmesh, ("reduce",)
    if mode == "pipelined":
        downstream = dict(chain_alphas or {"io": alpha / 2})
        chain = ("reduce", *downstream)
        edges = [(COMPUTE, "reduce")] + [(chain[i - 1], chain[i]) for i in range(1, len(chain))]
        graph = ServiceGraph.build(mesh, stages={"reduce": alpha, **downstream}, edges=edges,
                                   wire=head_wire)
        return graph, graph.gmesh, chain
    raise ValueError(f"mode {mode!r} not in {MODES}")


def run_wordcount(mesh, mode: str, corpus_cfg: CorpusCfg, alpha: float = 0.25,
                  granularity_words: int = 256, chain_alphas: dict[str, float] | None = None,
                  *, corpus: tuple | None = None,
                  phases: dict | None = None) -> tuple[torch.Tensor, tuple]:
    """This rank's part of one histogram pass: build the mode's graph, take
    this row's documents of the corpus (the map work on the compute rows
    only in the decoupled modes: the same total work, paper Sec. IV-A) onto
    the mesh's device, and run. Returns (the histogram, the same on every
    row; this row's (tokens, mask)).

    ``corpus``: the whole (tokens, mask) on the host, e.g. memory-mapped
    from `save_corpus` (default: every rank makes it, `make_corpus`).
    ``phases``: a dict that collects synchronised seconds per phase
    (map_s, stream_s, group_sum_s, broadcast_s)."""
    graph, gmesh, chain = wordcount_graph(mesh, mode, alpha, chain_alphas)
    n_rows = mesh.shape["data"]
    if corpus is None:
        corpus = make_corpus(corpus_cfg, corpus_cfg.n_docs_per_row * n_rows)
    t, m = row_docs(*corpus, mesh.row, gmesh.compute.size, n_rows)
    tokens = torch.from_numpy(t).to(mesh.device)
    mask = torch.from_numpy(m).to(mesh.device)
    vocab = corpus_cfg.vocab
    if mode == "reference":
        hist = reference_wordcount(tokens, mask, vocab, gmesh, phases=phases)
    elif mode == "decoupled":
        hist = decoupled_wordcount(tokens, mask, vocab, graph, granularity_words, phases=phases)
    else:
        hist = pipelined_wordcount(tokens, mask, vocab, graph, chain, granularity_words,
                                   phases=phases)
    return hist, (tokens, mask)


def histogram_launches(mode: str, corpus_cfg: CorpusCfg, n_rows: int, alpha: float = 0.25,
                       granularity_words: int = 256,
                       chain_alphas: dict[str, float] | None = None) -> int:
    """The keyed-histogram calls one `run_wordcount` pass makes, summed
    over the ranks, from the schedule alone: one local histogram per row
    in the reference mode; otherwise one fold per element arriving on the
    head stage's consumer rows (every compute row sends all its
    elements; later stages sum, without the histogram)."""
    from repro_torch.launch.mesh import Mesh

    _, gmesh, _ = wordcount_graph(Mesh(n_rows=n_rows, device="cpu"), mode, alpha, chain_alphas)
    if mode == "reference":
        return n_rows
    per_row = -(-corpus_cfg.n_docs_per_row * n_rows // gmesh.compute.size)
    words = per_row * corpus_cfg.words_per_doc
    return gmesh.compute.size * -(-words // min(granularity_words, words))


# -- the corpus on the host, shared by the ranks -------------------------------

def save_corpus(cfg: CorpusCfg, total_docs: int, directory: str) -> str:
    """Make the corpus once (`make_corpus`) and save it under
    ``directory``; returns the path `load_corpus` takes."""
    tokens, mask = make_corpus(cfg, total_docs)
    path = os.path.join(directory, "corpus")
    np.save(path + ".tokens.npy", tokens)
    np.save(path + ".mask.npy", mask)
    return path


def load_corpus(path: str) -> tuple[np.ndarray, np.ndarray]:
    """The corpus `save_corpus` wrote, memory-mapped (a rank reads only
    its own rows' pages)."""
    return (np.load(path + ".tokens.npy", mmap_mode="r"),
            np.load(path + ".mask.npy", mmap_mode="r"))


def _wordcount_rank(mesh, modes: Sequence[str], cfg: CorpusCfg, corpus_path: str) -> dict:
    corpus = load_corpus(corpus_path)
    out = {}
    for mode in modes:
        hist, _ = run_wordcount(mesh, mode, cfg, corpus=corpus)
        out[mode] = hist.cpu().numpy()
    return out


def wordcount_world(cfg: CorpusCfg, modes: Sequence[str] = MODES, *, n_rows: int = 8,
                    device=None) -> dict[str, np.ndarray]:
    """Host entry point: make the corpus once, start an ``n_rows``-rank world
    (`launch.mesh.spawn`, on the card unless ``device`` names another),
    run each mode in it at `run_wordcount`'s defaults, and return each
    mode's histogram (checked equal on every row)."""
    from repro_torch.launch.mesh import spawn

    with tempfile.TemporaryDirectory(prefix="repro_torch_corpus_") as tmp:
        path = save_corpus(cfg, cfg.n_docs_per_row * n_rows, tmp)
        ranks = spawn(_wordcount_rank, n_rows, device=device, args=(tuple(modes), cfg, path),
                      timeout_s=600.0)
    for mode in modes:
        for r, res in enumerate(ranks):
            if not np.array_equal(res[mode], ranks[0][mode]):
                raise AssertionError(f"{mode}: row {r}'s histogram differs from row 0's")
    return {mode: ranks[0][mode] for mode in modes}


__all__ = ["CorpusCfg", "MODES", "decoupled_wordcount", "decoupled_wordcount_measured",
           "histogram_launches", "layout_corpus", "load_corpus", "make_corpus", "pipelined_wordcount",
           "reference_wordcount", "row_docs", "run_wordcount", "save_corpus",
           "wordcount_graph", "wordcount_world"]
