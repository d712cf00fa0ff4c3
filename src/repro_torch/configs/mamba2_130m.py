"""mamba2-130m — attention-free SSM with SSD [arXiv:2405.21060; unverified].

24L d_model=768, no MLP (the Mamba-2 block is the whole layer),
vocab=50280, ssm_state=128, head_dim=64, expand=2 -> d_inner=1536,
24 SSD heads, chunk 256, conv 4, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    supports_long_context=True,
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=32,
    tie_embeddings=True,
    supports_long_context=True,
)
