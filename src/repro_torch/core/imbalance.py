"""Imbalance models: the sources of T_sigma and workload skew (a copy of
the reference's numpy-only `core/imbalance.py`, draw for draw: the same
generator calls in the same order, so a seed gives the same numbers in
both packages; `apps.mapreduce.make_corpus` depends on it).

On the paper's Cray, imbalance came from OS noise, temperature variance
and data-dependent workloads (unstructured meshes, particle skew). The
dominant sources modelled and *injected* here are data-dependent:

  * document-length skew in the LM data pipeline,
  * MoE expert-routing skew (token hot-spots),
  * particle-density skew in the PIC app (GEM reconnection
    concentrates particles in the current sheet).

`sample_process_times` also keeps the paper's Gaussian-noise model so
the perf-model calibration can reproduce Cray-like conditions.

Besides the *generative* models above, this module hosts the *online
estimators* of the adaptive loop: given measured per-row work counters,
`empirical_t_sigma_work` recovers the paper's T_sigma straggler penalty
in work units and `empirical_sigma` inverts the closed form of
`perfmodel.t_sigma` so the measured penalty can be fed back into
Eqs. 2-4 for re-planning.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImbalanceModel:
    kind: str = "gaussian"  # gaussian | lognormal | pareto
    mean: float = 1.0
    sigma: float = 0.05  # relative
    pareto_shape: float = 3.0

    def sample_process_times(self, n_procs: int, rng: np.random.Generator) -> np.ndarray:
        if self.kind == "gaussian":
            t = rng.normal(self.mean, self.sigma * self.mean, n_procs)
        elif self.kind == "lognormal":
            t = rng.lognormal(np.log(self.mean), self.sigma, n_procs)
        elif self.kind == "pareto":
            t = self.mean * (1.0 + rng.pareto(self.pareto_shape, n_procs) * self.sigma)
        else:
            raise ValueError(self.kind)
        return np.maximum(t, 1e-9)

    def sample_lengths(
        self,
        n: int,
        rng: np.random.Generator,
        minimum: int = 1,
        cap: int | None = None,
    ) -> np.ndarray:
        """Integer token counts with this model's skew: the continuous
        per-process time draw reinterpreted as a length draw (``mean``
        in tokens). The lognormal/pareto branches are the serving
        traffic engine's prompt/output-length distributions — real
        prompt traces are heavy-tailed, which is exactly the T_sigma
        source the disaggregated fleet absorbs."""
        t = self.sample_process_times(n, rng)
        lens = np.maximum(int(minimum), np.rint(t).astype(np.int64))
        if cap is not None:
            lens = np.minimum(lens, int(cap))
        return lens

    def expected_t_sigma(self, n_procs: int, n_trials: int = 256, seed: int = 0) -> float:
        """Monte-Carlo E[max_i t_i - mean t] — the measured counterpart of
        perfmodel.t_sigma's closed form."""
        rng = np.random.default_rng(seed)
        tot = 0.0
        for _ in range(n_trials):
            t = self.sample_process_times(n_procs, rng)
            tot += t.max() - t.mean()
        return tot / n_trials


def _counts_from_weights(w: np.ndarray, total_items: int) -> np.ndarray:
    """Integerize normalized weights into counts summing to total_items."""
    w = w / w.sum()
    counts = np.floor(w * total_items).astype(np.int64)
    # distribute the remainder deterministically
    rem = total_items - counts.sum()
    order = np.argsort(-w)
    for i in range(int(rem)):
        counts[order[i % len(w)]] += 1
    assert counts.sum() == total_items
    return counts


def skewed_partition(
    total_items: int, n_parts: int, skew: float, rng: np.random.Generator
) -> np.ndarray:
    """Split ``total_items`` into ``n_parts`` with Zipf-like skew.

    skew=0 -> uniform; skew=1 -> heavy head. Used to build imbalanced
    workloads for MapReduce splits and PIC particle distributions.
    """
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    ranks = np.arange(1, n_parts + 1, dtype=np.float64)
    w = ranks ** (-skew) if skew > 0 else np.ones(n_parts)
    rng.shuffle(w)
    return _counts_from_weights(w, total_items)


def sheet_partition(
    total_items: int,
    n_parts: int,
    skew: float,
    center: float,
    width: float = 0.08,
) -> np.ndarray:
    """Split ``total_items`` with a *current-sheet* concentration.

    The PIC app's GEM-reconnection skew concentrates particles in a
    sheet around ``center`` (fractional position in [0, 1]); ``skew``
    in [0, 1] blends uniform (0) into fully sheet-concentrated (1).
    Unlike `skewed_partition` the placement is deterministic in
    ``center``, so a *drifting* sheet (center moving across supersteps)
    moves the hot rows — the time-varying imbalance the adaptive loop
    (core/adapt.py) is built to chase.
    """
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    if not 0.0 <= skew <= 1.0:
        raise ValueError(f"skew={skew} outside [0, 1]")
    pos = (np.arange(n_parts, dtype=np.float64) + 0.5) / n_parts
    d = np.abs(pos - float(center))
    sheet = np.exp(-0.5 * (d / max(width, 1e-6)) ** 2)
    w = (1.0 - skew) + skew * n_parts * sheet / max(sheet.sum(), 1e-12)
    return _counts_from_weights(w, total_items)


# -- online estimators (the adaptive loop's "measure" leg) ---------------------


def empirical_t_sigma_work(work: np.ndarray) -> float:
    """Measured straggler penalty in WORK units.

    ``work`` is (n_rows,) or (n_samples, n_rows) per-row work counters
    (valid particles, tokens). Returns E[max_i w_i - mean_i w_i] over
    the samples — the measured counterpart of the paper's T_sigma,
    before conversion to seconds by the calibrator (core/adapt.py).
    """
    w = np.asarray(work, np.float64)
    if w.ndim == 1:
        w = w[None, :]
    if w.ndim != 2 or w.shape[1] == 0:
        raise ValueError(f"work must be (rows,) or (samples, rows), got {w.shape}")
    return float((w.max(axis=1) - w.mean(axis=1)).mean())


def empirical_sigma(work: np.ndarray, t_per_item: float = 1.0) -> float:
    """Online sigma estimator: invert `perfmodel.t_sigma`'s closed form
    (penalty = sigma * sqrt(2 ln P)) on the measured penalty, so the
    re-planner can evaluate Eqs. 2-4 with a *measured* imbalance.

    ``t_per_item`` converts work units to seconds (the calibrated cost
    of one work item); with the default 1.0 the result stays in work
    units.
    """
    w = np.asarray(work, np.float64)
    n_rows = w.shape[-1]
    if n_rows <= 1:
        return 0.0
    penalty = empirical_t_sigma_work(w) * t_per_item
    return penalty / math.sqrt(2.0 * math.log(n_rows))
