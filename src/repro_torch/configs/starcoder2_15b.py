"""starcoder2-15b — dense code LM, GQA + RoPE [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. LayerNorm +
GELU MLP with biases.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173; hf",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    norm_kind="ln",
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    rope_theta=100_000.0,
    supports_long_context=False,
)

SMOKE = ArchConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    norm_kind="ln",
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
)
