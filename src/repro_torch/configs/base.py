"""ArchConfig for the port: the reference dataclass with ``dtype`` as a
``torch.dtype``, plus the reference's input-shape grid (`ShapeCfg`,
`SHAPES`) and its cells.

Only the configs the port can run are registered (dense decoder LMs and
the Mamba-2 SSM). `get(name)` returns the full config, `get_smoke(name)` the reduced
variant the CPU tests use; the reference's other architectures (the MoE,
hybrid, encoder-decoder and VLM families) raise naming ROADMAP A12.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The reference's LM shape grid (identical for every architecture).
SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""
    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention flavour
    attn_kind: str = "full"  # full | swa | chunked_local
    window: int = 0  # sliding-window size (swa)
    chunk_window: int = 0  # chunked-local chunk (llama4)
    global_layers: tuple[int, ...] = ()  # layer indices with full attention
    global_every: int = 0  # every k-th layer full attention (llama4 iRoPE)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_kind: str = "rope"  # rope | sinusoidal | none
    norm_kind: str = "rms"  # rms | ln
    mlp_kind: str = "swiglu"  # swiglu | gelu
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE / hybrid / enc-dec / frontends (not ported: model_zoo raises)
    n_experts: int = 0
    experts_per_token: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    hybrid: bool = False
    encoder_layers: int = 0
    frontend: str = ""
    n_frontend_tokens: int = 0
    # numerics
    dtype: torch.dtype = torch.bfloat16
    supports_long_context: bool = False
    supports_decode: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_q(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_windows(self) -> list[int]:
        """Per-layer attention window (0 = full causal)."""
        out = []
        for i in range(self.n_layers):
            full = (
                self.attn_kind == "full"
                or i in self.global_layers
                or (self.global_every and (i + 1) % self.global_every == 0)
            )
            if full:
                out.append(0)
            elif self.attn_kind == "swa":
                out.append(self.window)
            elif self.attn_kind == "chunked_local":
                out.append(self.chunk_window)
            else:
                out.append(0)
        return out

    def param_count(self) -> int:
        """Analytical parameter count (embedding + layers), for 6ND: the
        reference's formula for the families the port registers (dense and
        SSM; the others return with ROADMAP A12)."""
        d = self.d_model
        if self.family == "ssm":
            din, g_n = self.d_inner, self.ssm_state  # a single B/C group
            per_layer = (d * (2 * din + 2 * g_n + self.ssm_heads)  # in_proj [z, x, B, C, dt]
                         + self.ssm_conv * (din + 2 * g_n)  # conv
                         + din * d  # out_proj
                         + 3 * self.ssm_heads)  # A, D, dt_bias
        else:
            attn = d * self.d_q + 2 * d * self.d_kv + self.d_q * d
            per_layer = attn + (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        total = self.n_layers * (per_layer + 2 * d)  # + norms
        return int(total + self.vocab_size * d * (1 if self.tie_embeddings else 2))

    def active_param_count(self) -> int:
        """Active parameters per token: every parameter, in a dense or SSM model."""
        return self.param_count()


# in the reference registry's order
REGISTRY: dict[str, str] = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}


ARCH_NAMES = tuple(REGISTRY)

# the reference's architectures whose family the port cannot build yet
NOT_PORTED: dict[str, str] = {
    "hymba-1.5b": "hybrid",
    "whisper-small": "encdec",
    "mixtral-8x7b": "moe",
    "llama4-scout-17b-a16e": "moe",
    "pixtral-12b": "vlm",
}


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(f"{name}: the {NOT_PORTED[name]!r} family is not ported "
                                  f"yet; see ROADMAP A12")
    return importlib.import_module(REGISTRY[name])


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def cells(include_skips: bool = False) -> list[tuple[str, str, str]]:
    """Every (arch, shape, skip reason) of the port's registry over the
    shape grid, with the reference's skip reasons; skipped cells only
    when asked."""
    out = []
    for a in ARCH_NAMES:
        cfg = get(a)
        for s in SHAPES.values():
            skip = ""
            if s.name == "long_500k" and not cfg.supports_long_context:
                skip = "full-attention arch: long_500k needs sub-quadratic attention"
            if s.kind == "decode" and not cfg.supports_decode:
                skip = "no decode step for this arch"
            if skip and not include_skips:
                continue
            out.append((a, s.name, skip))
    return out
