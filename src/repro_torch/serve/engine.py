"""Colocated serving engine of the port, in the reference's two
disciplines.

``mode="aligned"`` (the default): admission only at the tick head, each
admitted prompt prefilled alone (`PrefillRunner.__call__`: the exact
prompt for families that cannot mask padding, such as the SSM, the
power-of-two bucket with the length-masked prefill otherwise) and
migrated into its slot of the dense store; one shared decode cursor, and
`model.decode_step` over every slot's cache each tick. It is the only
mode an SSM model serves in.

``mode="continuous"``: slot-level continuous batching. A finished
prefill takes a decode slot the same tick the slot frees (admission runs
again after retirement), admitted prompts prefill as one packed
multi-prompt call (`PrefillRunner.run_batch`), each slot decodes on its
own cursor, and KV lives in a `KVStore` (dense, or paged with the prefix
cache). Page-aware admission reserves every in-flight request's
remaining block growth before taking new work, so a decode append can
always allocate its tail block. Each tick the decode step attends
straight into the pool through the block tables (the paged decode kernel
on the GPU) and returns its new K/V rows for the store to scatter.

In both, the argmax kernel picks every admission's first token and
every tick's next tokens.

Tracing (`obs.trace`) emits what the reference's engine emits, where it
does: a lifecycle span per accepted submit, the ``prefill`` /
``prefill_packed`` spans and ``admit`` marks on ``("engine",
"prefill")``, the decode span, ``retire`` marks and the ``kv`` counter on
``("engine", "decode")``. It is host-side only: no span adds, reorders or
waits for device work. A span closes when the host returns from the call
it wraps, so the prefill and aligned decode spans time the dispatch; the
continuous decode span ends after the tick's token copy to the host,
the engine's one wait for the device each tick.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.sample import sample_last
from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.serve.api import ServeConfig
from repro_torch.serve.kvstore import make_kvstore
from repro_torch.serve.sched import FleetLedger, FleetScheduler

# colocated-engine tracks (obs.trace): process "engine", one thread per
# phase; requests flow-link through these via request_mark
_T_PREFILL = ("engine", "prefill")
_T_DECODE = ("engine", "decode")


def prefill_bucket(n: int, minimum: int = 8, max_len: int | None = None) -> int:
    """Round a prompt length up to a power-of-two bucket, clamped at
    ``max_len``; a prompt longer than ``max_len`` raises."""
    if max_len is not None and n > max_len:
        raise ValueError(f"prompt length {n} exceeds max_len {max_len}")
    b = minimum
    while b < n:
        b *= 2
    if max_len is not None:
        b = min(b, max_len)
    return b


def supports_length_masked_prefill(cfg) -> bool:
    """Attention-only LMs can prefill right-padded prompts exactly."""
    return not (getattr(cfg, "ssm_state", 0) or getattr(cfg, "hybrid", False)
                or getattr(cfg, "family", "") == "encdec")


class PrefillRunner:
    """Prefill shared by both modes. Attention-only LMs go through the
    power-of-two padded bucket with the length-masked prefill; other
    families (the SSM) prefill the exact prompt."""

    def __init__(self, model, params, max_len: int | None = None):
        self.model = model
        self.params = params
        self.max_len = max_len  # bucket cap: migrated KV must fit the slot cache
        self._bucketed = supports_length_masked_prefill(model.cfg)

    def __call__(self, prompt: np.ndarray) -> tuple:
        """prompt (n,) int -> (last-token logits (1, 1, V), batch-1 cache)."""
        dev = self.model.device
        if not self._bucketed:
            return self.model.prefill(self.params, torch.as_tensor(prompt[None, :], device=dev))
        n = int(prompt.shape[0])
        padded = np.zeros((1, prefill_bucket(n, max_len=self.max_len)), np.int64)
        padded[0, :n] = prompt
        return self.model.prefill(self.params, torch.as_tensor(padded, device=dev), length=n)

    def run_batch(self, prompts: list) -> tuple:
        """Packed multi-prompt prefill: prompts right-padded to one shared
        bucket with per-row true lengths -> (per-row last-position logits
        (n, 1, V), batched cache with per-row ``pos``). Needs the
        length-masked prefill."""
        if not self._bucketed:
            raise ValueError("packed prefill needs a length-maskable model")
        lens = [int(p.shape[0]) for p in prompts]
        padded = np.zeros((len(prompts), prefill_bucket(max(lens), max_len=self.max_len)),
                          np.int64)
        for i, p in enumerate(prompts):
            padded[i, : lens[i]] = p
        dev = self.model.device
        return self.model.prefill(self.params, torch.as_tensor(padded, device=dev),
                                  length=torch.as_tensor(lens, dtype=torch.int32, device=dev))


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 32
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # tick-clock bookkeeping (time-to-first-token / drain analytics)
    submitted_tick: int = -1
    first_token_tick: int = -1
    done_tick: int = -1
    tenant: str = "default"


def request_block_tokens(kv, req: Request, max_len: int) -> int:
    """Block tokens ``req`` occupies through completion, net of its
    prefix-cache discount — the page-aware admission price."""
    bs = kv.block_size
    n = min(int(req.prompt.shape[0]) + req.max_new_tokens, max_len)
    covered = kv.covered_tokens(req.prompt, int(req.prompt.shape[0]))
    return (-(-n // bs)) * bs - covered


def page_admission_budget(kv, slots, max_len: int, *, extra_need_tokens: int = 0):
    """(free_tokens, cost_fn) for `FleetScheduler.take`, or (None, None)
    when the store is not page-limited: the pool's free (plus
    prefix-evictable) block tokens minus the growth every in-flight
    request may still need to finish."""
    if kv.block_size is None:
        return None, None
    bs = kv.block_size
    reserve = 0
    for i, req in enumerate(slots):
        if req is None:
            continue
        n = int(kv.lens[i])
        target = min(n + req.max_new_tokens - len(req.out_tokens), max_len)
        reserve += (-(-target // bs) - (-(-n // bs))) * bs
    free = max(0, kv.free_tokens() - reserve - extra_need_tokens)
    return free, lambda req: request_block_tokens(kv, req, max_len)


@dataclasses.dataclass
class EngineConfig(ServeConfig):
    max_batch: int = 8


class Engine:
    def __init__(self, model, params, cfg: EngineConfig, sched: FleetScheduler | None = None):
        if cfg.mode == "continuous" and not supports_length_masked_prefill(model.cfg):
            raise ValueError(
                "continuous batching needs an attention-only LM "
                "(ragged per-slot decode cursors)"
            )
        self.model = model
        self.params = params
        self.cfg = cfg
        self.sched = sched if sched is not None else FleetScheduler.fifo()
        self.ledger = FleetLedger()
        self.slots: list[Request | None] = [None] * cfg.max_batch
        self.finished: list[Request] = []
        self._prefill = PrefillRunner(model, params, max_len=cfg.max_len)
        self.kv = make_kvstore(model, cfg.max_batch, cfg.max_len, cfg.kv,
                               ragged=cfg.mode == "continuous")
        self.tokens = torch.zeros((cfg.max_batch, 1), dtype=torch.int32, device=model.device)
        self.last_logits = None  # (B, 1, V) of the latest decode step
        self.tick = 0
        self.stats = {"steps": 0, "tokens_out": 0, "prefills": 0,
                      "prefix_hit_tokens": 0, "prefill_skips": 0}
        self.last_tick: dict = {"prefill_lens": [], "decode_batch": 0}

    @property
    def cache(self) -> dict:
        """The slot KV as a dense cache dict (a read view; the paged
        store gathers its block tables)."""
        if self.kv.kind == "dense":
            return self.kv.cache
        return self.kv.view([i for i, s in enumerate(self.slots) if s is not None])

    def submit(self, req: Request) -> bool:
        req.submitted_tick = self.tick
        ok = self.sched.submit(req, now=self.tick)
        # the lifecycle span opens here and only here: a re-queue goes
        # straight to sched.submit, so the one span closes in record_done
        if ok and _obs.enabled():
            _obs.request_begin(req.uid, tenant=req.tenant, tick=self.tick,
                               prompt_tokens=int(req.prompt.shape[0]))
        return ok

    def idle(self) -> bool:
        return self.sched.pending() == 0 and all(s is None for s in self.slots)

    def _page_budget(self):
        budget, cost_fn = page_admission_budget(self.kv, self.slots, self.cfg.max_len)
        if budget is None:
            # dense stores gate on free slots x max_len with a uniform
            # max_len price: the same set as a bare max_n gate
            return self.kv.free_tokens(), lambda req: self.cfg.max_len
        return budget, cost_fn

    def _admit(self) -> None:
        """Aligned admission at the tick head: batch-1 prefill of each
        taken request, migrated into its free slot."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        for req in self.sched.take(self.tick, max_n=len(free)):
            slot = free.pop(0)
            self.slots[slot] = req
            with _obs.span("prefill", _T_PREFILL, uid=req.uid,
                           tokens=int(req.prompt.shape[0])):
                logits, cache1 = self._prefill(req.prompt)
            if _obs.enabled():
                _obs.request_mark(req.uid, "admit", _T_PREFILL, slot=slot)
            self.kv.admit(slot, cache1, int(req.prompt.shape[0]))
            first = sample_last(logits)[0]
            self.tokens[slot, 0] = first
            self.stats["prefills"] += 1
            self.last_tick["prefill_lens"].append(int(req.prompt.shape[0]))

    def _admit_continuous(self) -> None:
        """Admit into whatever slots are free right now. Admitted prompts
        prefill packed (one call), except whole-prompt prefix-cache hits,
        which skip prefill."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return
        budget, cost_fn = self._page_budget()
        taken = self.sched.take(self.tick, max_n=len(free), free_tokens=budget,
                                cost_fn=cost_fn)
        cold: list[tuple[int, Request]] = []
        for req in taken:
            slot = free.pop(0)
            self.slots[slot] = req
            entry = self.kv.full_hit(req.prompt)
            if entry is not None:
                info = self.kv.admit_from_full(slot, entry)
                self.tokens[slot, 0] = entry.first
                if _obs.enabled():
                    _obs.request_mark(req.uid, "admit:prefix_hit", _T_PREFILL, slot=slot)
                self.stats["prefill_skips"] += 1
                self.stats["prefix_hit_tokens"] += info["prefix_tokens"]
                self.last_tick["prefix_hit_tokens"] += info["prefix_tokens"]
            else:
                cold.append((slot, req))
        if not cold:
            return
        with _obs.span("prefill_packed", _T_PREFILL, batch=len(cold)):
            logits, batch = self._prefill.run_batch([r.prompt for _, r in cold])
        if _obs.enabled():
            for slot, req in cold:
                _obs.request_mark(req.uid, "admit", _T_PREFILL, slot=slot)
        call_nets = []
        for i, (slot, req) in enumerate(cold):
            n = int(req.prompt.shape[0])
            cache1 = {"k": batch["k"][:, i : i + 1], "v": batch["v"][:, i : i + 1]}
            first = sample_last(logits[i : i + 1])[0]
            info = self.kv.admit(slot, cache1, n, tokens=req.prompt,
                                 logits=logits[i, -1], first=int(first))
            self.tokens[slot, 0] = first
            self.stats["prefills"] += 1
            self.stats["prefix_hit_tokens"] += info["prefix_tokens"]
            self.last_tick["prefix_hit_tokens"] += info["prefix_tokens"]
            self.last_tick["prefill_lens"].append(n - info["prefix_tokens"])
            call_nets.append(n - info["prefix_tokens"])
        if max(call_nets) > 0:
            self.last_tick["prefill_calls"].append(
                (prefill_bucket(max(call_nets), max_len=self.cfg.max_len), len(cold)))

    def step(self) -> None:
        """One engine tick: admit, decode one token for every slot, retire
        (continuous mode admits again into the slots just freed)."""
        if self.cfg.mode == "continuous":
            return self._step_continuous()
        self.last_tick = {"prefill_lens": [], "decode_batch": 0}
        self._admit()
        self.tick += 1
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        with _obs.span("decode", _T_DECODE, tick=self.tick, batch=len(active)):
            logits, cache = self.model.decode_step(self.params, self.kv.view(), self.tokens)
        self.kv.absorb(cache, active)
        self.last_logits = logits
        next_tok = sample_last(logits)
        self.last_tick["decode_batch"] = len(active)
        self._retire(next_tok.cpu().numpy())
        self.tokens = next_tok[:, None]
        self.stats["steps"] += 1

    def _step_continuous(self) -> None:
        self.last_tick = {"prefill_lens": [], "prefill_calls": [],
                          "decode_batch": 0, "prefix_hit_tokens": 0}
        self._admit_continuous()
        self.tick += 1
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if active:
            _obs.begin("decode", _T_DECODE, tick=self.tick, batch=len(active))
            logits, rows_k, rows_v = self.model.decode_step_paged(
                self.params, self.kv.kernel_view(active), self.tokens)
            self.kv.absorb_rows(rows_k, rows_v, active)
            self.last_logits = logits
            next_tok = sample_last(logits)
            # the tick's one wait for the device, inside the span, so the
            # span covers the device work and not only its dispatch
            next_np = next_tok.cpu().numpy()
            _obs.end(_T_DECODE)
            self.last_tick["decode_batch"] = len(active)
            for slot in self._retire(next_np):
                self.kv.free(slot)
            self.tokens = next_tok[:, None]
        self._admit_continuous()
        self.last_tick["kv"] = self.kv.stats
        _metrics.publish_kv_stats(self.last_tick["kv"])
        if _obs.enabled():
            kv = self.last_tick["kv"]
            _obs.counter("kv", {k: kv[k] for k in ("blocks_in_use", "live_tokens")
                                if k in kv}, _T_DECODE)
        self.stats["steps"] += 1

    def _retire(self, next_np: np.ndarray) -> list[int]:
        """Record this tick's token per active slot; finish requests at
        EOS / length. Returns the freed slot indices."""
        freed = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(next_np[i])
            if req.first_token_tick < 0:
                req.first_token_tick = self.tick
            req.out_tokens.append(tok)
            self.stats["tokens_out"] += 1
            if tok == self.cfg.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                req.done_tick = self.tick
                self.finished.append(req)
                if _obs.enabled():
                    _obs.request_mark(req.uid, "retire", _T_DECODE, slot=i)
                self.ledger.record_done(req, self.sched.slo(req.tenant), self.tick)
                self.slots[i] = None
                freed.append(i)
        return freed

    def drain(self, max_steps: int = 10_000) -> int:
        """Step until idle; returns the steps taken. Raises if work is
        still queued after ``max_steps``."""
        for n in range(max_steps):
            if self.idle():
                return n
            self.step()
        if not self.idle():
            raise RuntimeError(
                f"engine stalled after {max_steps} steps: queue={self.sched.pending()} "
                f"slots={sum(s is not None for s in self.slots)}"
            )
        return max_steps

    # the reference's earlier name, kept as an alias
    run_until_drained = drain

    def workload_sample(self) -> dict:
        """Per-tick analytics payload for the decoupled analytics group."""
        return {
            "active_slots": sum(s is not None for s in self.slots),
            "queue_depth": self.sched.pending(),
            "tokens_out": self.stats["tokens_out"],
        }
