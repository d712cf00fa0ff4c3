"""Speculative decoding of the port: a draft -> verify service chain (the
counterpart of the reference's `serve/spec.py`).

A small draft model runs k cheap sequential decode steps and streams the
k-token block (with its draft probabilities) to the verify side; the
target model scores all k + 1 chunk positions in one batched forward
(`models.transformer.verify_step_lm`), applies the accept rule, and
streams the accept counts and the corrected tokens back on the reverse
edge of the bidirectional `ServiceGraph` edge, with `core/wire.py`
carrying both payloads through the configured codec.

Greedy mode (DESIGN.md §15):

  chunk    = [x, d_1 .. d_k]          x = the pending (last emitted) token
  L_0..L_k = target logits of the chunk positions (one verify forward)
  accept d_i  iff  d_i == argmax L_{i-1}   (leading run, length a)
  emit     = d_1 .. d_a, then argmax L_a  (correction, or bonus on a == k)

Every emitted token is an argmax of target logits over the prefix the
target-only engine would have, so greedy speculative streams equal
target-only greedy streams wherever the verify's logits and the decode
step's agree to within the top-2 margin (the two compute the same
function in another summation order). Sampled mode is the standard
rejection rule (accept with probability min(1, p/q), else draw from the
residual norm(max(0, p - q))) under keys of the port's counter-based
generator (`utils.prng`), so a run replays under a fixed seed.

KV: the draft keeps its own store. The target store absorbs the verified
span (`absorb_span`) and `truncate`s back to the accept point; the draft
store rolls back the same way, with one catch-up decode step on a full
accept (its last drafted token was sampled but never fed back). The
dense store's `view` is the store itself, so the verify writes into it
and `truncate` zeroes what it rejects; the paged store's `view` is a
gather, so `absorb_span` extracts the rows.

The draft's steps, the verify forward, the accept test and the rollback
read their tokens to the host every step, as the reference's do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.perfmodel import recommend_spec_split, t_spec_serve
from repro_torch.core.wire import (
    get_codec,
    make_accept_payload,
    make_draft_payload,
    split_accept_payload,
    split_draft_payload,
)
from repro_torch.kernels.sample import sample_last
from repro_torch.obs import trace as _obs
from repro_torch.serve.engine import Engine, EngineConfig, PrefillRunner
from repro_torch.serve.faults import FaultEvent
from repro_torch.serve.kvstore import make_kvstore
from repro_torch.serve.sched import FleetScheduler
from repro_torch.utils import prng

# the draft and verify groups are the chain's two stage groups: two trace
# processes
_T_DRAFT = ("draft", "rows")
_T_VERIFY = ("verify", "rows")

DRAFT_SEED = 7  # the seed of `_build_draft`'s random weights


@dataclasses.dataclass
class SpecConfig(EngineConfig):
    """Speculative-decoding engine config (continuous mode only: rollback
    needs per-slot cursors).

    ``draft`` names the zoo draft model (built as its smoke variant when
    `make_engine` gets no ``draft=``); ``spec_k`` is the draft block
    length; ``spec_mode`` picks the greedy argmax test or seeded
    rejection sampling. ``n_rows`` / ``draft_rows`` is the virtual split
    the planner prices the two model groups at and the adapt loop
    re-plans; ``cost_ratio`` overrides the planner's target/draft cost
    ratio (default: the active-parameter ratio of the two models)."""

    mode: str = "continuous"
    draft: str = "qwen1.5-0.5b"
    spec_k: int = 4
    spec_mode: str = "greedy"  # greedy | sampled
    seed: int = 0
    n_rows: int = 8
    draft_rows: int = 2
    adapt: bool = False
    report_window: int = 16
    speedup_threshold: float = 1.05
    spec_k_max: int = 8
    verify_width_cost: float = 0.08  # relative verify cost per extra chunk slot
    cost_ratio: float | None = None  # target/draft cost ratio for the planner
    wire_codec: str = "identity"  # draft <-> verify edge codec

    def __post_init__(self):
        super().__post_init__()
        if self.mode != "continuous":
            raise ValueError("spec decoding needs mode='continuous'")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec_mode not in ("greedy", "sampled"):
            raise ValueError(
                f"spec_mode must be 'greedy' or 'sampled', got {self.spec_mode!r}")
        if not 1 <= self.draft_rows < self.n_rows:
            raise ValueError(
                f"draft_rows must be in [1, {self.n_rows - 1}], got {self.draft_rows}")


def _build_draft(name: str, device):
    """The smoke variant of the named zoo draft in f32, random weights from
    `DRAFT_SEED` (the mechanism's correctness never depends on the
    draft's quality; callers that need an acceptance dial pass a draft)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model_zoo import build

    model = build(dataclasses.replace(get_smoke(name), dtype=torch.float32), device=device)
    return model, model.init(DRAFT_SEED)


class SpecEngine(Engine):
    """Continuous-batching engine whose decode tick is the speculative
    draft -> verify -> rollback protocol. Admission, the KV stores, the
    prefix cache, the scheduler, the ledger and retirement are the
    colocated engine's."""

    def __init__(self, model, params, cfg: SpecConfig, sched: FleetScheduler | None = None,
                 *, draft=None, mesh=None, clock=None):
        super().__init__(model, params, cfg, sched=sched)
        if model.verify_step is None:
            raise ValueError("speculative decoding needs a model with verify_step "
                             "(attention-only LMs)")
        if draft is None:
            self.draft_model, self.draft_params = _build_draft(cfg.draft, model.device)
        else:
            self.draft_model, self.draft_params = draft
        if self.draft_model.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary: "
                             f"{self.draft_model.cfg.vocab_size} != {model.cfg.vocab_size}")
        # the draft's own store: the target's geometry at full capacity (the
        # target's page-aware admission cannot see this pool, so it must
        # never be the one to run out) and no prefix cache (draft KV is
        # private to its request)
        draft_spec = dataclasses.replace(cfg.kv, n_blocks=None, prefix_cache=False)
        self.draft_kv = make_kvstore(self.draft_model, cfg.max_batch, cfg.max_len,
                                     draft_spec, ragged=True)
        self._draft_prefill = PrefillRunner(self.draft_model, self.draft_params,
                                            max_len=cfg.max_len)
        self._base_key = prng.key(cfg.seed)
        self._codec = get_codec(cfg.wire_codec)
        self.clock = clock
        # the live plan the adapt loop rewrites
        self.spec_k = cfg.spec_k
        self.n_rows = cfg.n_rows
        self.draft_rows = cfg.draft_rows
        self.replans: list[dict] = []
        self.stats.update(accepted=0, drafted=0, verify_calls=0, draft_steps=0)
        self._regrow: tuple[int, int] | None = None  # (tick, slots)
        self._slow_until = 0
        self._slow_factor = 1.0
        # the ServiceGraph: draft rows are the compute group, verify rows
        # the service group, joined by the bidirectional edge (draft blocks
        # out, verdicts back)
        self.graph = None
        if mesh is not None:
            from repro_torch.core.dataflow import COMPUTE, ServiceGraph

            verify_rows = self.n_rows - self.draft_rows
            self.graph = ServiceGraph.build(
                mesh, stages={"verify": verify_rows / self.n_rows},
                bidirectional=[(COMPUTE, "verify")],
                wire={(COMPUTE, "verify"): cfg.wire_codec,
                      ("verify", COMPUTE): cfg.wire_codec})

    # -- admission: the draft mirrors every target admission ----------------
    def _admit_continuous(self) -> None:
        before = {i for i, s in enumerate(self.slots) if s is not None}
        super()._admit_continuous()
        for i, req in enumerate(self.slots):
            if req is None or i in before:
                continue
            # the draft prefills the same prompt into its own store, so the
            # draft's length equals the target's at every tick head; a
            # target prefix-cache hit does not skip it
            _, cache1 = self._draft_prefill(req.prompt)
            self.draft_kv.admit(i, cache1, int(req.prompt.shape[0]))

    # -- one speculative tick ------------------------------------------------
    def _step_continuous(self) -> None:
        self.last_tick = {
            "prefill_lens": [], "prefill_calls": [], "decode_batch": 0,
            "prefix_hit_tokens": 0, "draft_batches": [], "verify": None,
            "accepted": 0, "drafted": 0, "emitted": 0,
            "spec_k": self.spec_k, "draft_rows": self.draft_rows,
        }
        if self._regrow is not None and self.tick >= self._regrow[0]:
            _, slots = self._regrow
            self._regrow = None
            self.resize(slots=slots)
        self._admit_continuous()
        self.tick += 1
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if active:
            self._spec_tick(active)
        self._admit_continuous()
        self.last_tick["kv"] = self.kv.stats
        self.last_tick["draft_kv"] = self.draft_kv.stats
        self.stats["steps"] += 1
        self._record_tick()
        if self.cfg.adapt and self.tick % self.cfg.report_window == 0:
            self._replan()

    def _spec_tick(self, active: list[int]) -> None:
        k = self.spec_k
        cfg = self.cfg
        dev = self.model.device
        n0 = {i: int(self.kv.lens[i]) for i in active}
        # per-row draft budget: a tick's last emitted token is always the
        # target's, so a row r tokens from its cap drafts at most r - 1,
        # and the cache leaves room for the pending token's row
        n_draft = {}
        for i in active:
            req = self.slots[i]
            rem = req.max_new_tokens - len(req.out_tokens)
            n_draft[i] = max(0, min(k, rem - 1, cfg.max_len - 1 - n0[i]))

        # -- draft: k cheap sequential steps ----------------------------------
        b = cfg.max_batch
        cur = self.tokens  # (B, 1) pending token per slot
        d_np = np.zeros((b, k), np.int64)  # drafted ids
        q_of_d = np.zeros((b, k), np.float64)  # the draft's probability of each
        q_rows: list[np.ndarray | None] = [None] * k  # whole draft dists (B, V)
        _obs.begin("draft", _T_DRAFT, tick=self.tick, k=k, batch=len(active))
        for j in range(k):
            active_j = [i for i in active if n_draft[i] > j]
            if not active_j:
                break
            logits, dcache = self.draft_model.decode_step(
                self.draft_params, self.draft_kv.view(active_j), cur)
            self.draft_kv.absorb(dcache, active_j)
            key = (None if cfg.spec_mode == "greedy"
                   else prng.fold_in(self._base_key, self.tick * (k + 1) + j))
            d = sample_last(logits, key=key)
            d_host = d.cpu().numpy()
            if key is not None:
                probs = torch.softmax(logits[:, -1].float(), dim=-1).cpu().numpy()
                q_rows[j] = probs
                q_of_d[:, j] = probs[np.arange(b), d_host]
            d_np[:, j] = d_host
            cur = d[:, None]
            self.last_tick["draft_batches"].append(len(active_j))
            self.stats["draft_steps"] += 1
        _obs.end(_T_DRAFT)

        # -- forward wire: the draft block crosses the draft -> verify edge --
        payload = make_draft_payload(torch.from_numpy(d_np), torch.from_numpy(q_of_d))
        payload = self._codec.decode_tree(self._codec.encode_tree(payload))
        d_wire, _ = split_draft_payload(payload)
        d_np = d_wire.numpy().astype(np.int64)  # integer leaves pass every codec exactly

        # -- verify: one batched target forward over the chunk ----------------
        s_chunk = k + 1
        chunk = np.zeros((b, s_chunk), np.int64)
        n_new = np.zeros((b,), np.int64)
        tok_np = self.tokens[:, 0].cpu().numpy()
        for i in active:
            chunk[i, 0] = tok_np[i]
            chunk[i, 1 : 1 + n_draft[i]] = d_np[i, : n_draft[i]]
            n_new[i] = n_draft[i] + 1
        with _obs.span("verify", _T_VERIFY, tick=self.tick, chunk=s_chunk,
                       batch=len(active)):
            logits, vcache = self.model.verify_step(
                self.params, self.kv.view(active),
                torch.as_tensor(chunk, dtype=torch.int32, device=dev),
                torch.as_tensor(n_new, dtype=torch.int32, device=dev))
        self.last_logits = logits
        self.stats["verify_calls"] += 1
        self.last_tick["verify"] = (s_chunk, len(active))
        self.last_tick["decode_batch"] = len(active)

        # -- accept / correct -------------------------------------------------
        if cfg.spec_mode == "greedy":
            targets = sample_last(logits.reshape(b * s_chunk, 1, -1)).reshape(b, s_chunk)
            accepts, corrected = self._greedy_verdict(active, chunk, n_draft,
                                                      targets.cpu().numpy())
        else:
            accepts, corrected = self._sampled_verdict(active, chunk, n_draft, logits, q_rows)

        # -- reverse wire: the verdict crosses the verify -> draft edge -------
        back = make_accept_payload(
            torch.tensor([accepts.get(i, 0) for i in range(b)], dtype=torch.int32),
            torch.tensor([corrected.get(i, 0) for i in range(b)], dtype=torch.int32))
        back = self._codec.decode_tree(self._codec.encode_tree(back))
        acc_wire, corr_wire = split_accept_payload(back)
        acc_np, corr_np = acc_wire.numpy(), corr_wire.numpy()

        # -- commit + rollback ------------------------------------------------
        self.kv.absorb_span(vcache, active, [int(n_new[i]) for i in active])
        full_accept = []
        for i in active:
            a = int(acc_np[i])
            self.kv.truncate(i, n0[i] + a + 1)
            if a == n_draft[i]:
                full_accept.append(i)  # the draft is one row short (below)
            else:
                self.draft_kv.truncate(i, n0[i] + a + 1)
        if full_accept:
            # catch-up: on a full accept the last drafted token was sampled
            # but never fed back, so the draft cache is one row short of the
            # target's accept point; one decode step over those rows closes
            # it (the other rows get the view length as their cursor, so
            # their lane write touches nothing)
            feed = np.zeros((b, 1), np.int64)
            for i in full_accept:
                feed[i, 0] = chunk[i, n_draft[i]]
            _, dcache = self.draft_model.decode_step(
                self.draft_params, self.draft_kv.view(full_accept),
                torch.as_tensor(feed, dtype=torch.int32, device=dev))
            self.draft_kv.absorb(dcache, full_accept)

        # -- emit + retire ----------------------------------------------------
        emitted = {}
        for i in active:
            a = int(acc_np[i])
            emitted[i] = [int(t) for t in chunk[i, 1 : 1 + a]] + [int(corr_np[i])]
            self.last_tick["accepted"] += a
            self.last_tick["drafted"] += n_draft[i]
        self.stats["accepted"] += self.last_tick["accepted"]
        self.stats["drafted"] += self.last_tick["drafted"]
        if _obs.enabled():
            _obs.instant("verdict", _T_VERIFY, tick=self.tick,
                         accepted=self.last_tick["accepted"],
                         drafted=self.last_tick["drafted"])
        self.last_tick["emitted"] = sum(len(v) for v in emitted.values())
        next_np = np.array([emitted[i][-1] if i in emitted else 0 for i in range(b)])
        for slot in self._retire_many(emitted):
            self.kv.free(slot)
            self.draft_kv.free(slot)
        self.tokens = torch.as_tensor(next_np[:, None], dtype=torch.int32, device=dev)

    def _greedy_verdict(self, active, chunk, n_draft, targets):
        """Leading-run argmax test: accept d_i while it equals the target's
        argmax at the position before it; the first mismatch (or the bonus
        position after a full match) supplies the emitted target token."""
        accepts, corrected = {}, {}
        for i in active:
            a = 0
            while a < n_draft[i] and chunk[i, a + 1] == targets[i, a]:
                a += 1
            accepts[i] = a
            corrected[i] = int(targets[i, a])
        return accepts, corrected

    def _sampled_verdict(self, active, chunk, n_draft, logits, q_rows):
        """Distribution-preserving rejection sampling (seeded): accept d_i
        with probability min(1, p(d_i) / q(d_i)); on a reject draw from the
        residual norm(max(0, p - q)); on a full accept draw the bonus from
        p. Every draw folds (tick, row, position) into the base key, so the
        run replays under a fixed seed."""
        b, s_chunk = chunk.shape
        p_full = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        # slot k of the tick's key stream: the draft draws used 0..k-1
        key = prng.fold_in(self._base_key, self.tick * s_chunk + s_chunk - 1)
        u = prng.uniform(key, (b, max(1, s_chunk - 1))).numpy()
        accepts, corrected = {}, {}
        for i in active:
            a = 0
            while a < n_draft[i]:
                d = chunk[i, a + 1]
                p = p_full[i, a, d]
                q = q_rows[a][i, d]
                if q <= 0.0 or u[i, a] < min(1.0, p / q):
                    a += 1
                else:
                    break
            accepts[i] = a
            if a < n_draft[i]:
                residual = np.maximum(p_full[i, a] - q_rows[a][i], 0.0)
                z = residual.sum()
                dist = residual / z if z > 0 else p_full[i, a]
            else:
                dist = p_full[i, a]
            rk = prng.fold_in(key, i * s_chunk + a + 1)
            corrected[i] = int(prng.categorical(rk, torch.log(torch.from_numpy(dist) + 1e-30)))
        return accepts, corrected

    def _retire_many(self, emitted: dict[int, list[int]]) -> list[int]:
        """Multi-token retire: record each slot's emitted tokens in stream
        order, finishing at EOS or length exactly as `_retire` would over
        as many ticks (tokens past EOS are dropped)."""
        freed = []
        for i, toks in emitted.items():
            req = self.slots[i]
            if req is None:
                continue
            for tok in toks:
                if req.done:
                    break
                if req.first_token_tick < 0:
                    req.first_token_tick = self.tick
                req.out_tokens.append(tok)
                self.stats["tokens_out"] += 1
                if tok == self.cfg.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    req.done_tick = self.tick
                    self.finished.append(req)
                    if _obs.enabled():
                        _obs.request_mark(req.uid, "retire", _T_VERIFY, slot=i)
                    self.ledger.record_done(req, self.sched.slo(req.tenant), self.tick)
                    self.slots[i] = None
                    freed.append(i)
        return freed

    # -- ledger / adapt bridge -----------------------------------------------
    def _record_tick(self) -> None:
        wall = self.clock(self.last_tick) if self.clock is not None else 1.0
        if self.tick < self._slow_until:
            wall *= self._slow_factor
        self.ledger.record_tick(
            wall_s=wall,
            prefill_work_rows=[float(sum(self.last_tick["prefill_lens"]))],
            decode_work_rows=[float(self.last_tick["decode_batch"])],
            queue_depth=self.sched.pending(),
            accepted=self.last_tick["accepted"],
            drafted=self.last_tick["drafted"],
            accepted_by_tenant=self._tenant_counts("accepted"),
            drafted_by_tenant=self._tenant_counts("drafted"),
        )

    def _tenant_counts(self, which: str) -> dict[str, int]:
        """This tick's total attributed to tenants by live-slot share: exact
        when one tenant holds the slots, proportional otherwise."""
        tenants = [req.tenant for req in self.slots if req is not None]
        total = self.last_tick[which]
        if not tenants or not total:
            return {}
        share, rem = divmod(total, len(tenants))
        out: dict[str, int] = {}
        for n, t in enumerate(tenants):
            out[t] = out.get(t, 0) + share + (1 if n < rem else 0)
        return out

    def _planner_costs(self):
        if self.cfg.cost_ratio is not None:
            ratio = self.cfg.cost_ratio
        else:
            ratio = (self.model.cfg.active_param_count()
                     / self.draft_model.cfg.active_param_count())
        w = self.cfg.verify_width_cost
        return 1.0, lambda kk: ratio * (1.0 + w * kk)

    def _replan(self) -> None:
        """The adapt loop: the windowed acceptance rate through Eq. 4''
        re-splits the virtual draft/verify rows. A plan applies only when
        its predicted win over the current (k, split) clears
        ``speedup_threshold``."""
        acceptance = self.ledger.acceptance_rate()
        if acceptance == self.ledger.NO_SAMPLE:
            return  # nothing drafted in the window: nothing to plan on
        c_draft, c_verify = self._planner_costs()
        plan = recommend_spec_split(c_draft, c_verify, acceptance, self.n_rows,
                                    k_max=self.cfg.spec_k_max)
        t_now = t_spec_serve(c_draft, c_verify, acceptance, self.spec_k, self.draft_rows,
                             self.n_rows)
        if (plan.k, plan.draft_rows) == (self.spec_k, self.draft_rows):
            return
        if t_now / plan.t_per_token < self.cfg.speedup_threshold:
            return
        self.replans.append({
            "tick": self.tick, "acceptance": acceptance,
            "from": (self.spec_k, self.draft_rows), "to": (plan.k, plan.draft_rows),
            "predicted_speedup": t_now / plan.t_per_token,
        })
        if _obs.enabled():
            _obs.instant("replan", _T_DRAFT, tick=self.tick, acceptance=float(acceptance),
                         k=int(plan.k), draft_rows=int(plan.draft_rows))
        self.spec_k = plan.k
        self.resize(draft_rows=plan.draft_rows)

    # -- elasticity -----------------------------------------------------------
    def resize(self, *, slots: int | None = None, draft_rows: int | None = None) -> None:
        """Re-size the engine without losing requests. ``draft_rows``
        rewrites the virtual draft/verify split (and regroups the
        ServiceGraph when a mesh is attached). ``slots`` re-sizes the slot
        pool through the stores' `resize`; live requests past the new
        capacity are re-queued at their original arrival (recomputed,
        never lost)."""
        if draft_rows is not None:
            if not 1 <= draft_rows < self.n_rows:
                raise ValueError(f"draft_rows must be in [1, {self.n_rows - 1}], "
                                 f"got {draft_rows}")
            self.draft_rows = draft_rows
            if self.graph is not None:
                self.graph = self.graph.regroup({"verify": self.n_rows - draft_rows})
        if slots is None:
            return
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        live = [i for i, s in enumerate(self.slots) if s is not None]
        keep, requeue = live[:slots], live[slots:]
        for i in requeue:
            req = self.slots[i]
            req.out_tokens = []
            req.first_token_tick = -1
            req.done = False
            self.sched.submit(req, now=req.submitted_tick)
        moves = list(enumerate(keep))
        self.kv = self.kv.resize(slots, moves)
        self.draft_kv = self.draft_kv.resize(slots, moves)
        new_tok = torch.zeros((slots, 1), dtype=torch.int32, device=self.tokens.device)
        new_slots: list = [None] * slots
        if moves:
            dst = torch.tensor([m[0] for m in moves], device=self.tokens.device)
            src = torch.tensor([m[1] for m in moves], device=self.tokens.device)
            new_tok[dst] = self.tokens[src]
        for d, s in moves:
            new_slots[d] = self.slots[s]
        self.slots = new_slots
        self.tokens = new_tok
        self.cfg.max_batch = slots

    def inject_fault(self, event: FaultEvent) -> None:
        """Fleet faults on the single-process engine: ``device_loss`` and
        ``preempt`` shrink the slot pool (the overflow re-queued, none
        lost), preempted capacity returns after ``duration`` ticks, and
        ``slow_node`` scales the recorded wall clock."""
        if event.kind == "slow_node":
            self._slow_until = self.tick + event.duration
            self._slow_factor = event.factor
            return
        old = self.cfg.max_batch
        new = max(1, old - event.rows)
        if event.kind == "preempt" and event.duration > 0:
            self._regrow = (self.tick + event.duration, old)
        self.resize(slots=new)

    def workload_sample(self) -> dict:
        out = super().workload_sample()
        out.update(acceptance_rate=self.ledger.acceptance_rate(), spec_k=self.spec_k,
                   draft_rows=self.draft_rows, verify_rows=self.n_rows - self.draft_rows)
        return out


__all__ = ["SpecConfig", "SpecEngine"]
