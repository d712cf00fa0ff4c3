"""hymba-1.5b — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16. Attention is SWA with three full-attention layers
(first / middle / last, per the paper); the SSM path runs in parallel
within every layer on the same norm1 output, and the two outputs are
averaged as they come, (attn + ssm) / 2, as the reference model computes
them (the reference's docstring says "after per-path norms"; its code
has none). Meta tokens are omitted, as in the reference. Sub-quadratic
(SWA + SSM) => long_500k runnable.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676; hf",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    attn_kind="swa",
    window=1024,
    global_layers=(0, 15, 31),
    rope_theta=10000.0,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid=True,
    supports_long_context=True,
)

SMOKE = ArchConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    attn_kind="swa",
    window=16,
    global_layers=(0,),
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    hybrid=True,
    supports_long_context=True,
)
