"""whisper-small — encoder-decoder audio LM [arXiv:2212.04356; unverified].

12L encoder + 12L decoder, d_model=768 12H (kv=12) d_ff=3072
vocab=51865. Conv frontend is a STUB: callers pass the precomputed
(B, 1500, d_model) mel-frame embeddings as ``frames=``. LayerNorm + GELU
+ sinusoidal positions. The shape grid's decode_32k/prefill_32k cells
run the decoder backbone past whisper's 448-token horizon, as the
reference's do. long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    source="arXiv:2212.04356; unverified",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm_kind="ln",
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    pos_kind="sinusoidal",
    encoder_layers=12,
    cross_attention=True,
    frontend="audio",
    n_frontend_tokens=1500,
    supports_long_context=False,
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    norm_kind="ln",
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    pos_kind="sinusoidal",
    encoder_layers=2,
    cross_attention=True,
    frontend="audio",
    n_frontend_tokens=32,
)
