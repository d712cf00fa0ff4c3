"""The serving-engine API of the port: `KVSpec`, `ServeConfig` and the
`make_engine` front door.

The port has the colocated `Engine` in aligned and continuous mode. The
disaggregated, fleet and speculative engines are later slices:
`make_engine` raises for their configs, naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """KV-cache implementation selector (see `serve/kvstore.py`).

    ``dense``: one (L, slots, max_len, d) reservation. ``paged``: a pool
    of ``n_blocks`` blocks of ``block_size`` tokens with per-slot block
    tables (default capacity: the dense equivalent). ``prefix_cache``
    shares the full blocks of earlier prompts with any request whose
    prompt starts with the same tokens. ``kv_dtype="int8"`` stores pool
    rows as int8 with a per-row scale (paged only), so the same byte
    budget holds twice the pages of a bf16 cache.
    """

    kind: str = "dense"  # dense | paged
    block_size: int = 16
    n_blocks: int | None = None  # None: dense-equivalent capacity
    prefix_cache: bool = False
    prefix_capacity: int = 256  # LRU entries before eviction
    kv_dtype: str = "cache"  # cache | int8

    def __post_init__(self):
        if self.kind not in ("dense", "paged"):
            raise ValueError(f"kv kind must be 'dense' or 'paged', got {self.kind!r}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.kv_dtype not in ("cache", "int8"):
            raise ValueError(f"kv_dtype must be 'cache' or 'int8', got {self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.kind != "paged":
            raise ValueError("kv_dtype='int8' requires kind='paged'")


@dataclasses.dataclass
class ServeConfig:
    """Fields shared by every serving engine. ``mode``: ``aligned`` (the
    phase-aligned tick with a shared cursor; the default, as in the
    reference) or ``continuous`` (slot-level continuous batching with
    ragged cursors). Paged KV needs continuous."""

    max_len: int = 512
    eos_id: int = -1  # -1: never stop early
    mode: str = "aligned"  # aligned | continuous
    kv: KVSpec = dataclasses.field(default_factory=KVSpec)

    def __post_init__(self):
        if self.mode not in ("aligned", "continuous"):
            raise ValueError(f"mode must be 'aligned' or 'continuous', got {self.mode!r}")
        if self.kv.kind == "paged" and self.mode != "continuous":
            raise ValueError("paged KV needs mode='continuous' (per-slot cursors)")


def make_engine(model, params, cfg: ServeConfig, sched=None):
    """Build the engine a config describes: `EngineConfig` (or a bare
    `ServeConfig`) gives the colocated `Engine`. Any other serving config
    names an engine that is not ported yet and raises."""
    from repro_torch.serve.engine import Engine, EngineConfig

    if isinstance(cfg, EngineConfig):
        return Engine(model, params, cfg, sched=sched)
    if type(cfg) is ServeConfig:
        shared = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        return Engine(model, params, EngineConfig(**shared), sched=sched)
    raise NotImplementedError(
        f"{type(cfg).__name__}: only the colocated engine is ported; the disaggregated "
        "and fleet engines wait for ROADMAP A9, the speculative one for A6"
    )


__all__ = ["KVSpec", "ServeConfig", "make_engine"]
