"""ArchConfig for the port: the reference dataclass with ``dtype`` as a
``torch.dtype``, plus the reference's input-shape grid (`ShapeCfg`,
`SHAPES`) and its cells.

Every architecture of the reference is registered, in its registry's
order: the dense, MoE and Mamba-2 SSM decoder LMs, the hybrid
(attention beside Mamba-2), the VLM (patch embeddings before the text)
and the encoder-decoder. `get(name)` returns the full config,
`get_smoke(name)` the reduced variant the CPU tests use.
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
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert: bool = False
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (hymba): parallel attention and SSM heads in every layer
    hybrid: bool = False
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stubs
    frontend: str = ""  # "" | "audio" | "vision"
    n_frontend_tokens: int = 0  # precomputed frame/patch embeddings
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
                # chunked-local as a sliding window of the chunk size, as
                # the reference masks it (`layers.chunked_local_mask` is
                # ported, and, as there, nothing calls it)
                out.append(self.chunk_window)
            else:
                out.append(0)
        return out

    def param_count(self) -> int:
        """Analytical parameter count (embedding + layers), for 6ND: the
        reference's formula."""
        d = self.d_model
        attn = d * self.d_q + 2 * d * self.d_kv + self.d_q * d
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        if self.n_experts:  # every expert, the router, the shared expert
            mlp = self.n_experts * mlp + d * self.n_experts + (mlp if self.shared_expert else 0)
        ssm = 0
        if self.ssm_state:
            din, g_n = self.d_inner, self.ssm_state  # a single B/C group
            ssm = (d * (2 * din + 2 * g_n + self.ssm_heads)  # in_proj [z, x, B, C, dt]
                   + self.ssm_conv * (din + 2 * g_n)  # conv
                   + din * d  # out_proj
                   + 3 * self.ssm_heads)  # A, D, dt_bias
        if self.hybrid:
            per_layer = attn + ssm + mlp
        elif self.family == "ssm":
            per_layer = ssm
        else:
            per_layer = attn + mlp
        total = self.n_layers * (per_layer + 2 * d)  # + norms
        if self.encoder_layers:  # encoder layers, and each decoder layer's cross-attention
            total += self.encoder_layers * (attn + mlp + 2 * d) + self.n_layers * (attn + d)
        return int(total + self.vocab_size * d * (1 if self.tie_embeddings else 2))

    def active_param_count(self) -> int:
        """Active parameters per token: every parameter, except the routed
        experts a token does not use in an MoE model."""
        if not self.n_experts:
            return self.param_count()
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * self.d_model * self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * mlp
        return int(self.param_count() - self.n_layers * inactive)


# in the reference registry's order
REGISTRY: dict[str, str] = {
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}


ARCH_NAMES = tuple(REGISTRY)

def _module(name: str):
    return importlib.import_module(REGISTRY[name])


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def cells(include_skips: bool = False) -> list[tuple[str, str, str]]:
    """Every (arch, shape, skip reason) of the registry over the shape
    grid, with the reference's skip reasons; skipped cells only
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
