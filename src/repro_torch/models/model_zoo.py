"""Model zoo: one interface over the architectures the port can run.

    model = build(cfg)                        # device: cuda unless device="cpu"
    params = model.init(seed)                 # or a torch.Generator
    logits, cache = model.prefill(params, tokens, length=...)   # impl="ref": plain attention
    logits, rows_k, rows_v = model.decode_step_paged(params, kernel_view, token)

Only the dense decoder family is ported. Other families raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer

Params = dict

_NOT_PORTED = {
    "moe": "ROADMAP A12 (models/moe.py)",
    "ssm": "ROADMAP A12 (models/ssm.py)",
    "hybrid": "ROADMAP A12 (models/ssm.py hybrid layers)",
    "encdec": "ROADMAP A12 (models/encdec.py)",
    "vlm": "ROADMAP A12 (frontend-extended sequences)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    device: torch.device
    init: Callable[..., Params]
    # (params, tokens, cache=None, length=None, *, impl=None) -> (logits, cache)
    prefill: Callable[..., tuple]
    init_cache: Callable[..., dict]
    # (params, kernel_view, token, *, impl=None) -> (logits, rows_k, rows_v)
    decode_step_paged: Callable[..., tuple]


def build(cfg, device=None) -> Model:
    if cfg.family != "dense" or cfg.n_experts or cfg.ssm_state or cfg.hybrid \
            or cfg.encoder_layers or cfg.frontend:
        where = _NOT_PORTED.get(cfg.family, "ROADMAP A12")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; see {where}"
        )
    dev = resolve_device(device)

    def init(seed: int | torch.Generator = 0) -> Params:
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return transformer.init_lm(cfg, gen, dev)

    def init_cache(batch_size: int, max_len: int) -> dict:
        return transformer.init_cache(cfg, batch_size, max_len, device=dev)

    def prefill(params, tokens, cache=None, length=None, *, impl=None):
        if cache is None:
            cache = init_cache(tokens.shape[0], tokens.shape[1])
        return transformer.prefill_lm(cfg, params, tokens, cache, length=length, impl=impl)

    def decode_step_paged(params, pview, token, *, impl=None):
        return transformer.decode_step_paged_lm(cfg, params, pview, token, impl=impl)

    return Model(cfg, dev, init, prefill, init_cache, decode_step_paged)
