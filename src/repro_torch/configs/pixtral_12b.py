"""pixtral-12b — VLM: pixtral-ViT frontend + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The ViT
frontend is a STUB: callers pass precomputed patch embeddings (B, 256,
d_model) as ``patches=``, prepended to the text sequence. Full
attention => long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend="vision",
    n_frontend_tokens=256,
    supports_long_context=False,
)

SMOKE = ArchConfig(
    name="pixtral-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    frontend="vision",
    n_frontend_tokens=16,
)
