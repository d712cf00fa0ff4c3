"""The paper's analytical performance model (Sec. II-D, Eqs. 1-4): a
copy of the reference's host-only `core/perfmodel.py` (stdlib only, the
same functions and values), so that the port imports nothing of it.

    T_c = T_W0 + T_sigma + T_W1                                     (Eq. 1)
    T_d = max( T_W0/(1-alpha) + T_sigma , T'_W1/alpha )             (Eq. 2)
    T_d = beta * [ T_W0/(1-alpha) + T_sigma ] + T'_W1/alpha         (Eq. 3)
    T_d = beta(S) * [ T_W0/(1-alpha) + T_sigma + (D/S)*o ]
          + T'_W1/alpha                                             (Eq. 4)

plus the memory bound of Sec. II-D (streamed consumption is O(S),
buffered consumption is O(D)) and the five suitability criteria of
Sec. II-E. The model is used three ways:

  1. unit/property tests pin its limiting behaviour (beta=1 -> sum of
     ops; beta=0 -> decoupled op only, matching the paper's prose);
  2. benchmarks calibrate (o, beta(S), T'_W1 complexity) from measured
     multi-device runs and evaluate the model at P = 32..8192 to compare
     against the paper's Cray XC40 speedups;
  3. the trainer uses `optimal_alpha` to auto-size service groups.

Chained multi-stage graphs (`ServiceGraph`) generalize the single
alpha to a per-stage alpha vector: `t_decoupled_chain` (Eq. 4') models
a pipeline of decoupled stages whose service side is the SLOWEST
stage, and `recommend_allocation` jointly assigns rows to every stage
under a fixed row budget.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Per-process workload of a two-operation application at scale P."""

    t_w0: float  # seconds of the kept-coupled operation per process
    t_w1: float  # seconds of the decoupling candidate per process
    d_bytes: float  # total bytes streamed between the groups (D)
    sigma: float = 0.0  # per-process time stddev (feeds T_sigma)
    # complexity of the decoupled op when run by a group of size P1
    # (default: perfectly divisible work). Receives (t_w1_total, P, P1).
    t_w1_prime: Callable[[float, int, int], float] | None = None


@dataclasses.dataclass(frozen=True)
class StreamCosts:
    """Platform stream parameters."""

    o_seconds: float  # per-element overhead (o): pack + inject cost
    beta: Callable[[float, float], float] | None = None  # beta(S, D)


def t_sigma(sigma: float, n_procs: int) -> float:
    """Expected synchronization penalty E[max_i t_i] - E[t] for P iid
    Gaussian process times (extreme-value approximation sqrt(2 ln P)).

    This is the paper's T_sigma: idle time waiting for the slowest peer
    ([4], [5] in the paper). Grows with P — the reason imbalance bites
    harder at scale.
    """
    if n_procs <= 1 or sigma <= 0.0:
        return 0.0
    return sigma * math.sqrt(2.0 * math.log(n_procs))


def default_beta(s_bytes: float, d_bytes: float, beta_min: float = 0.05) -> float:
    """Default beta(S): finer granularity -> better pipelining.

    beta == non-overlapped fraction of Op0. With one element (S >= D)
    nothing pipelines (beta = 1). With D/S elements the first element
    arrives after ~S/D of Op0, so beta ~= S/D, floored at beta_min
    (startup/drain of the pipeline can never be hidden).
    """
    if d_bytes <= 0:
        return 1.0
    return min(1.0, max(beta_min, s_bytes / d_bytes))


def t_conventional(p: WorkloadProfile, n_procs: int) -> float:
    """Eq. 1."""
    return p.t_w0 + t_sigma(p.sigma, n_procs) + p.t_w1


def _t_w1_decoupled(p: WorkloadProfile, n_procs: int, n_service: int) -> float:
    """T'_W1/alpha: per-process time of the decoupled op on the group."""
    if p.t_w1_prime is not None:
        return p.t_w1_prime(p.t_w1 * n_procs, n_procs, n_service)
    # default: total work T_W1 * P redistributed over the service group
    return p.t_w1 * n_procs / max(n_service, 1)


def t_decoupled(
    p: WorkloadProfile,
    n_procs: int,
    alpha: float,
    s_bytes: float,
    costs: StreamCosts,
    pessimistic_max: bool = False,
) -> float:
    """Eq. 4 (or Eq. 2 when ``pessimistic_max``)."""
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0,1), got {alpha}")
    n_service = max(1, int(round(alpha * n_procs)))
    n_compute = n_procs - n_service
    if n_compute < 1:
        raise ValueError("no compute processes left")
    compute_side = (
        p.t_w0 * n_procs / n_compute  # 1/(1-alpha) * T_W0 (exact integer form)
        + t_sigma(p.sigma, n_compute)
        + (p.d_bytes / max(s_bytes, 1.0)) * costs.o_seconds
    )
    service_side = _t_w1_decoupled(p, n_procs, n_service)
    if pessimistic_max:
        return max(compute_side, service_side)  # Eq. 2
    beta_fn = costs.beta or default_beta
    beta = beta_fn(s_bytes, p.d_bytes)
    return beta * compute_side + service_side  # Eqs. 3-4


def speedup(
    p: WorkloadProfile, n_procs: int, alpha: float, s_bytes: float, costs: StreamCosts
) -> float:
    return t_conventional(p, n_procs) / t_decoupled(p, n_procs, alpha, s_bytes, costs)


def memory_bytes(d_bytes: float, s_bytes: float, buffered: bool) -> float:
    """Sec. II-D memory model: streamed O(S) vs buffered O(D)."""
    return d_bytes if buffered else min(s_bytes, d_bytes)


def optimal_alpha(
    p: WorkloadProfile,
    n_procs: int,
    s_bytes: float,
    costs: StreamCosts,
    candidates: Sequence[float] = (1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2),
) -> tuple[float, float]:
    """Grid-search alpha (the paper tunes alpha empirically, Fig. 5)."""
    best = None
    for a in candidates:
        if round(a * n_procs) < 1 or round(a * n_procs) >= n_procs:
            continue
        t = t_decoupled(p, n_procs, a, s_bytes, costs)
        if best is None or t < best[1]:
            best = (a, t)
    if best is None:
        raise ValueError("no feasible alpha")
    return best


def optimal_granularity(
    p: WorkloadProfile,
    n_procs: int,
    alpha: float,
    costs: StreamCosts,
    candidates: Sequence[float] = tuple(2.0**k for k in range(10, 28)),
) -> tuple[float, float]:
    """Grid-search S: fine S pipelines better, coarse S cuts (D/S)*o."""
    best = None
    for s in candidates:
        t = t_decoupled(p, n_procs, alpha, s, costs)
        if best is None or t < best[1]:
            best = (s, t)
    assert best is not None
    return best


# -- multi-stage generalization: per-stage alpha vector (ServiceGraph) ----------
#
# Eqs. 1-4 model ONE decoupled operation. A `ServiceGraph` chains
# several (compute -> reduce -> io, ...), each with its own alpha; the
# generalization keeps Eq. 4's structure:
#
#   T_c  = T_W0 + T_sigma + sum_i T_Wi                         (Eq. 1')
#   T_d  = beta * [ T_W0/(1-sum_i alpha_i) + T_sigma
#                   + sum_i (D_i/S)*o ]
#          + max_i T'_Wi/alpha_i                               (Eq. 4')
#
# The service side is a MAX, not a sum: chained stages pipeline (stage
# i+1 consumes wave k while stage i produces wave k+1), so the chain's
# steady-state cost is its slowest stage. With one stage Eq. 4' is
# exactly Eq. 4 (pinned by tests/test_perfmodel.py). The compute side
# pays every stage's injection overhead: each (D_i/S)*o term is the
# paper's per-element cost on the producer group of edge i.


@dataclasses.dataclass(frozen=True)
class StageWorkload:
    """One decoupled stage of a chained application.

    ``t_op`` is the stage's per-process time in the coupled baseline
    (its share of Eq. 1); ``d_bytes`` the dataflow streamed into the
    stage; ``t_prime`` its complexity when run by a group of n_i rows
    (receives (t_op_total, P, n_i); default: perfectly divisible).
    """

    name: str
    t_op: float
    d_bytes: float
    t_prime: Callable[[float, int, int], float] | None = None

    def service_time(self, n_procs: int, n_rows: int) -> float:
        if self.t_prime is not None:
            return self.t_prime(self.t_op * n_procs, n_procs, n_rows)
        return self.t_op * n_procs / max(n_rows, 1)


def t_conventional_chain(
    t_w0: float, stages: Sequence[StageWorkload], sigma: float, n_procs: int
) -> float:
    """Eq. 1 generalized: every process performs every operation."""
    return t_w0 + t_sigma(sigma, n_procs) + sum(s.t_op for s in stages)


def t_decoupled_chain(
    t_w0: float,
    stages: Sequence[StageWorkload],
    sigma: float,
    n_procs: int,
    rows: Mapping[str, int],
    s_bytes: float,
    costs: StreamCosts,
    pessimistic_max: bool = False,
) -> float:
    """Eq. 4 generalized to a per-stage row vector ``rows``.

    ``rows[name]`` is the integer row count of each stage's group; the
    compute group keeps the rest. Reduces exactly to `t_decoupled` for
    a single stage."""
    if not stages:
        raise ValueError("no stages")
    for s in stages:
        if rows.get(s.name, 0) < 1:
            raise ValueError(f"stage {s.name!r} needs >= 1 row")
    n_service = sum(rows[s.name] for s in stages)
    n_compute = n_procs - n_service
    if n_compute < 1:
        raise ValueError("no compute processes left")
    compute_side = (
        t_w0 * n_procs / n_compute
        + t_sigma(sigma, n_compute)
        + sum((s.d_bytes / max(s_bytes, 1.0)) * costs.o_seconds for s in stages)
    )
    service_side = max(s.service_time(n_procs, rows[s.name]) for s in stages)
    if pessimistic_max:
        return max(compute_side, service_side)  # Eq. 2'
    beta_fn = costs.beta or default_beta
    d_total = sum(s.d_bytes for s in stages)
    beta = beta_fn(s_bytes, d_total)
    return beta * compute_side + service_side  # Eq. 4'


def chain_speedup(
    t_w0: float,
    stages: Sequence[StageWorkload],
    sigma: float,
    n_procs: int,
    rows: Mapping[str, int],
    s_bytes: float,
    costs: StreamCosts,
) -> float:
    return t_conventional_chain(t_w0, stages, sigma, n_procs) / t_decoupled_chain(
        t_w0, stages, sigma, n_procs, rows, s_bytes, costs
    )


@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    """Output of recommend_allocation: a joint per-stage row assignment."""

    rows: dict[str, int]
    alphas: dict[str, float]
    t: float
    speedup: float


def recommend_allocation(
    t_w0: float,
    stages: Sequence[StageWorkload],
    sigma: float,
    n_procs: int,
    s_bytes: float,
    costs: StreamCosts,
    row_budget: int,
) -> AllocationPlan:
    """Joint alpha assignment under a fixed row budget.

    Exhaustively searches integer row vectors (>= 1 row per stage,
    total <= row_budget < P) minimizing Eq. 4' — the planner behind
    `ServiceGraph` sizing, generalizing `optimal_alpha`'s grid search
    to several cooperating stages."""
    k = len(stages)
    if k == 0:
        raise ValueError("no stages")
    budget = min(row_budget, n_procs - 1)
    if budget < k:
        raise ValueError(f"row budget {row_budget} < {k} stages")
    best: tuple[dict[str, int], float] | None = None
    for combo in itertools.product(range(1, budget - k + 2), repeat=k):
        if sum(combo) > budget:
            continue
        rows = {s.name: r for s, r in zip(stages, combo)}
        t = t_decoupled_chain(t_w0, stages, sigma, n_procs, rows, s_bytes, costs)
        if best is None or t < best[1]:
            best = (rows, t)
    assert best is not None
    rows, t = best
    return AllocationPlan(
        rows=rows,
        alphas={name: r / n_procs for name, r in rows.items()},
        t=t,
        speedup=t_conventional_chain(t_w0, stages, sigma, n_procs) / t,
    )


# -- serving specialization: prefill/decode disaggregation ----------------------
#
# LLM serving is a two-operation application in the paper's sense:
# Op0 = decode (latency-bound, one token per step, bandwidth-limited)
# stays on the compute group; Op1 = prefill (throughput-bound, whole
# prompts, FLOP-limited) is the decoupling candidate, moved to a
# dedicated group of alpha*P rows. The dataflow D between the groups is
# the migrated KV cache of every admitted request, streamed at
# granularity S through the channel (Eq. 4's (D/S)*o term). T_sigma
# comes from prompt-length skew: a colocated engine stalls every decode
# slot behind its slowest in-flight prefill, which is exactly the
# paper's synchronization penalty.


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """Per-request serving traits, normalized to one request.

    ``prompt_cv`` is the coefficient of variation of prompt lengths
    (skewed_partition / real traffic both give >~1); it feeds T_sigma.
    ``slots`` is the decode slot batch of one lockstep engine group —
    the number of admissions a colocated row stalls behind per round.
    """

    prompt_tokens: float  # mean prompt length
    decode_tokens: float  # mean generated tokens per request
    t_prefill_token: float  # seconds per prefill token on one row
    t_decode_token: float  # seconds per decode step of one row's slot batch
    kv_bytes_per_token: float  # KV cache bytes migrated per prompt token
    prompt_cv: float = 0.0  # relative stddev of prompt length
    slots: float = 8.0  # decode slots per lockstep group


def serve_profile(w: ServeWorkload) -> WorkloadProfile:
    """Map serving traits onto the paper's WorkloadProfile (per round
    of ``slots`` requests).

    The key asymmetry: a batch-1 prefill does not data-parallelize, so
    a colocated fleet pays the *serial* prefill of its whole slot batch
    (t_w1 = slots * t_prefill — head-of-line blocking), while the
    disaggregated prefill group runs different requests concurrently:
    ``t_w1_prime`` spreads the same slot batch over the group's rows.
    T_sigma adds the prompt-length-skew spread on top; D is the KV
    migrated per round.
    """
    t_prefill = w.prompt_tokens * w.t_prefill_token
    serial = w.slots * t_prefill

    def redistribute(total_w1: float, n_procs: int, n_service: int) -> float:
        del total_w1, n_procs  # serial stall, not per-process work
        return serial / max(n_service, 1)

    return WorkloadProfile(
        t_w0=w.decode_tokens * w.t_decode_token,
        t_w1=serial,
        d_bytes=w.kv_bytes_per_token * w.prompt_tokens * w.slots,
        sigma=w.prompt_cv * t_prefill,
        t_w1_prime=redistribute,
    )


def t_colocated_serve(w: ServeWorkload, n_rows: int) -> float:
    """Eq. 1 for serving: every row prefills and decodes, and each batch
    of decode slots waits out the slowest in-flight prefill."""
    return t_conventional(serve_profile(w), n_rows)


def t_disagg_serve(
    w: ServeWorkload,
    n_rows: int,
    alpha: float,
    s_bytes: float,
    costs: StreamCosts,
    pessimistic_max: bool = False,
) -> float:
    """Eq. 4 for serving: decode on (1-alpha)P rows, prefill on alpha*P
    rows, KV caches streamed between them at granularity S.

    Note the role flip relative to training: the *decoupled* group does
    prefill, so alpha here sizes the prefill group and the compute side
    is the decode fleet.
    """
    profile = serve_profile(w)
    # decouple.t_decoupled treats t_w1 as the decoupled op — prefill.
    return t_decoupled(profile, n_rows, alpha, s_bytes, costs, pessimistic_max)


def serve_speedup(
    w: ServeWorkload, n_rows: int, alpha: float, s_bytes: float, costs: StreamCosts
) -> float:
    return t_colocated_serve(w, n_rows) / t_disagg_serve(w, n_rows, alpha, s_bytes, costs)


def prefill_traits(w: ServeWorkload) -> "OperationTraits":
    """Sec. II-E suitability of prefill as a decoupling candidate."""
    return OperationTraits(
        orthogonal=True,  # a request's prefill is independent of others' decode
        complexity_grows_with_p=False,
        high_variance=w.prompt_cv > 0.25,  # skewed prompt lengths
        continuous_dataflow=True,  # KV caches stream out as prefills finish
        special_hardware=True,  # FLOP-bound vs bandwidth-bound decode
    )


@dataclasses.dataclass(frozen=True)
class DisaggPlan:
    """Output of recommend_disaggregation."""

    disaggregate: bool
    alpha: float
    speedup: float
    criteria: list[str]


def recommend_disaggregation(
    w: ServeWorkload,
    n_rows: int,
    s_bytes: float,
    costs: StreamCosts,
    candidates: Sequence[float] = (1 / 8, 1 / 4, 3 / 8, 1 / 2, 5 / 8, 3 / 4),
) -> DisaggPlan:
    """When does a prefill/decode split beat the colocated engine?

    Combines the qualitative Sec. II-E screen (`recommend_decoupling`
    over `prefill_traits`) with the quantitative Eq.-4 comparison over
    an alpha grid, mirroring how `optimal_alpha` sizes the training
    service groups.
    """
    traits_ok = recommend_decoupling(prefill_traits(w))
    profile = serve_profile(w)
    alpha, t_best = optimal_alpha(profile, n_rows, s_bytes, costs, candidates)
    gain = t_colocated_serve(w, n_rows) / t_best
    return DisaggPlan(
        disaggregate=traits_ok and gain > 1.0,
        alpha=alpha,
        speedup=gain,
        criteria=decoupling_criteria(prefill_traits(w)),
    )


# -- serving specialization: speculative decoding (draft -> verify) -------------
#
# Speculative decoding is a second two-model instance of Eq. 4': Op0 =
# the draft model's k sequential decode steps (small, latency-bound),
# Op1 = the target model's single batched verify of all k positions
# (large, one forward). Splitting the fleet into a draft group of r_d
# rows and a verify group of N - r_d rows, the two stages pipeline
# (the draft streams block t+1 while the verify scores block t), so the
# steady-state tick cost is Eq. 4's service-side MAX:
#
#   T_tick(k, r_d)  = max( k * C_d / r_d , C_v(k) / (N - r_d) )
#   T_token(k, r_d) = T_tick / E[tokens](a, k)                  (Eq. 4'')
#
# where E[tokens](a, k) = sum_{i=0..k} a^i is the expected emitted
# tokens per verify under i.i.d. per-token acceptance a (1..k accepted
# drafts + 1 corrected-or-bonus token, a geometric truncation). The
# acceptance rate couples the split to the k choice: for a fixed k the
# balanced split r_d* = N * kC_d / (kC_d + C_v) is acceptance-free,
# but k* itself grows with a (high agreement -> long blocks pay off),
# which drags r_d* with it — the monotone draft-shrink-on-low-
# acceptance behaviour the adapt loop (serve/spec.py) relies on and
# tests/test_spec.py pins.


def spec_expected_tokens(acceptance: float, k: int) -> float:
    """E[tokens emitted per verify tick]: 1 + a + a^2 + ... + a^k.

    Every tick emits at least one token (the corrected/bonus sample) —
    the distribution-preserving guarantee — and each of the k draft
    positions survives with probability a^i of an all-accept prefix.
    """
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0,1], got {acceptance}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    return sum(acceptance**i for i in range(k + 1))


def t_spec_serve(
    c_draft: float,
    c_verify: Callable[[int], float],
    acceptance: float,
    k: int,
    draft_rows: int,
    n_rows: int,
    pipelined: bool = True,
) -> float:
    """Eq. 4'' seconds per emitted token.

    ``c_draft`` is one draft decode step on one row; ``c_verify(k)``
    one target forward scoring a k+1-wide chunk on one row (so
    ``c_verify(0)`` is a plain target decode step — the target-only
    baseline's cost). ``pipelined=False`` gives the sequential
    (single-group) form — the sum instead of the max — for engines
    that run draft and verify on the same rows."""
    if not 1 <= draft_rows < n_rows:
        raise ValueError(f"draft_rows must be in [1, {n_rows - 1}], got {draft_rows}")
    draft_side = k * c_draft / draft_rows
    verify_side = c_verify(k) / (n_rows - draft_rows)
    tick = max(draft_side, verify_side) if pipelined else draft_side + verify_side
    return tick / spec_expected_tokens(acceptance, k)


@dataclasses.dataclass(frozen=True)
class SpecPlan:
    """Output of recommend_spec_split: a joint (k, row-split) choice."""

    k: int
    draft_rows: int
    verify_rows: int
    t_per_token: float
    expected_tokens: float  # per verify tick, at the planned k
    speedup: float  # vs target-only decode on all n_rows


def recommend_spec_split(
    c_draft: float,
    c_verify: Callable[[int], float],
    acceptance: float,
    n_rows: int,
    k_max: int = 8,
    pipelined: bool = True,
) -> SpecPlan:
    """Joint argmin of Eq. 4'' over (k, draft_rows).

    The spec analog of `recommend_allocation`: exhaustive over the
    small integer grid (k in 1..k_max, r_d in 1..N-1). Low acceptance
    pushes k* down (long draft blocks mostly get thrown away), and the
    balanced split follows k* down — fewer draft rows, more verify
    rows. ``speedup`` compares against all N rows running target-only
    decode (cost ``c_verify(0)`` per token per row)."""
    if n_rows < 2:
        raise ValueError(f"need >= 2 rows to split, got {n_rows}")
    best: SpecPlan | None = None
    base = c_verify(0) / n_rows  # target-only seconds per token
    for k in range(1, k_max + 1):
        for r_d in range(1, n_rows):
            t = t_spec_serve(c_draft, c_verify, acceptance, k, r_d, n_rows,
                             pipelined=pipelined)
            if best is None or t < best.t_per_token:
                best = SpecPlan(
                    k=k,
                    draft_rows=r_d,
                    verify_rows=n_rows - r_d,
                    t_per_token=t,
                    expected_tokens=spec_expected_tokens(acceptance, k),
                    speedup=base / t,
                )
    assert best is not None
    return best


# -- Sec. II-E suitability criteria ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class OperationTraits:
    orthogonal: bool = False  # little data dependency with other ops
    complexity_grows_with_p: bool = False  # e.g. collectives, all-to-all
    high_variance: bool = False  # irregular execution time
    continuous_dataflow: bool = False  # produces data throughout the stage
    special_hardware: bool = False  # benefits from special-purpose nodes


def decoupling_criteria(traits: OperationTraits) -> list[str]:
    """Which of the paper's five categories (Sec. II-E) an op satisfies."""
    hits = []
    if traits.orthogonal:
        hits.append("orthogonal")
    if traits.complexity_grows_with_p:
        hits.append("complexity-grows-with-P")
    if traits.high_variance:
        hits.append("high-variance")
    if traits.continuous_dataflow:
        hits.append("continuous-dataflow")
    if traits.special_hardware:
        hits.append("special-hardware")
    return hits


def recommend_decoupling(traits: OperationTraits) -> bool:
    return len(decoupling_criteria(traits)) >= 1
