"""Deterministic, resumable, shardable data pipeline (a port of the
reference's `data/pipeline.py`).

The batch of a step is a pure function of ``(seed, step)``, drawn with
numpy exactly as the reference draws it, so both packages see the same
tokens from the same seed. Batches are dicts of CPU tensors (tokens and
labels int32, mask f32; for an architecture with an audio or vision
frontend also its f32 ``frames`` / ``patches`` (B, n_frontend_tokens,
d_model), N(0, 0.02^2), drawn after the tokens); `row_shard` cuts one
mesh row's rows out of a global batch and moves them to that row's
device. In decoupled mode `padded_for_groups` lays the global batch over
the compute rows and gives the service rows zero-masked shards (the same
total workload, Sec. IV-A).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"  # synthetic | zipf
    skew: float = 0.0  # >0: variable document lengths (mask tails)
    frontend: str = ""  # "" | audio | vision
    n_frontend_tokens: int = 0
    d_model: int = 0


class Pipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.cfg.seed, step]))

    def global_batch(self, step: int) -> dict:
        """The full global batch of ``step``."""
        cfg = self.cfg
        rng = self._rng(step)
        b, s = cfg.global_batch, cfg.seq_len
        if cfg.kind == "zipf":
            toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64) % cfg.vocab_size
        else:
            toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1))
        mask = np.ones((b, s), np.float32)
        if cfg.skew > 0:
            # Zipf-skewed document lengths: some rows are mostly padding
            ranks = np.arange(1, b + 1, dtype=np.float64)
            w = ranks ** (-cfg.skew)
            rng.shuffle(w)
            lengths = np.maximum((w / w.max() * s).astype(np.int64), 8)
            for i, length in enumerate(lengths):
                mask[i, length:] = 0.0
        out = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
               "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
               "mask": torch.from_numpy(mask)}
        if cfg.frontend:
            key = {"audio": "frames", "vision": "patches"}[cfg.frontend]
            emb = rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
            out[key] = torch.from_numpy(emb.astype(np.float32) * 0.02)
        return out

    def padded_for_groups(self, step: int, compute_rows: int, total_rows: int) -> dict:
        """The global batch laid out for a grouped mesh: it fills the
        compute rows' shards, and every later row (all service rows) gets
        zero-masked padding, so per-row shapes stay uniform."""
        base = self.global_batch(step)
        b = self.cfg.global_batch
        padded_b = -(-b // compute_rows) * total_rows
        out = {}
        for k, v in base.items():
            out[k] = torch.cat([v, v.new_zeros((padded_b - b,) + tuple(v.shape[1:]))])
        return out


def build_for_arch(arch_cfg, shape_cfg, seed: int = 0, skew: float = 0.0) -> Pipeline:
    """The synthetic pipeline of one (architecture, shape) cell."""
    return Pipeline(DataConfig(vocab_size=arch_cfg.vocab_size, seq_len=shape_cfg.seq_len,
                               global_batch=shape_cfg.global_batch, seed=seed, skew=skew,
                               frontend=arch_cfg.frontend,
                               n_frontend_tokens=arch_cfg.n_frontend_tokens,
                               d_model=arch_cfg.d_model))


def row_shard(batch: dict, row: int, n_rows: int, device=None) -> dict:
    """Row ``row`` of ``n_rows`` equal shards of a global batch (the
    reference's ``P("data")`` layout of the leading axis), on ``device``.
    The batch must divide into the rows, as that layout requires."""
    b = next(iter(batch.values())).shape[0]
    if b % n_rows:
        raise ValueError(f"a global batch of {b} does not divide over {n_rows} rows")
    per_row = b // n_rows
    sl = slice(row * per_row, (row + 1) * per_row)
    return {k: v[sl].to(device) for k, v in batch.items()}


__all__ = ["DataConfig", "Pipeline", "build_for_arch", "row_shard"]
