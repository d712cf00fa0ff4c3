"""mixtral-8x7b — sparse MoE LM, 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
Sliding-window attention (4096) => long_500k runnable.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088; hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attn_kind="swa",
    window=4096,
    rope_theta=1_000_000.0,
    n_experts=8,
    experts_per_token=2,
    supports_long_context=True,
)

SMOKE = ArchConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attn_kind="swa",
    window=16,
    n_experts=4,
    experts_per_token=2,
    supports_long_context=True,
)
