"""qwen1.5-0.5b — dense LM with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (MHA kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    supports_long_context=False,
)

SMOKE = ArchConfig(
    name="qwen1.5-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=6,
    d_ff=192,
    vocab_size=512,
    qkv_bias=True,
    tie_embeddings=True,
)
