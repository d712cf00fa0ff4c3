"""llama4-scout-17b-a16e — MoE 16e top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 with a shared expert on every layer. Chunked-local attention
(8192 chunks) with a global-attention layer every 4th layer (iRoPE) =>
sub-quadratic enough for long_500k decode. Early-fusion multimodal
frontend out of scope (text backbone).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    attn_kind="chunked_local",
    chunk_window=8192,
    global_every=4,
    rope_theta=500_000.0,
    n_experts=16,
    experts_per_token=1,
    shared_expert=True,
    supports_long_context=True,
)

SMOKE = ArchConfig(
    name="llama4-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    attn_kind="chunked_local",
    chunk_window=32,
    global_every=2,
    n_experts=4,
    experts_per_token=1,
    shared_expert=True,
    supports_long_context=True,
)
