"""Model zoo: one interface over the architectures the port can run.

    model = build(cfg)                        # device: cuda unless device="cpu"
    params = model.init(seed)                 # or a torch.Generator
    loss, metrics = model.loss(params, batch)  # training (params from
                                              # model.init(seed, param_dtype=torch.float32))
    logits, cache = model.prefill(params, tokens, length=...)   # impl="ref": plain route
    logits, cache = model.decode_step(params, cache, token)      # aligned mode
    logits, rows_k, rows_v = model.decode_step_paged(params, kernel_view, token)

The dense decoder family and the Mamba-2 SSM family are ported. An SSM
model has no paged decode (``decode_step_paged`` is None): it serves in
aligned mode only. Other families raise `NotImplementedError` naming the
ROADMAP item that ports them.
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
    # (params, cache, token) -> (logits, cache): the shared-cursor decode
    decode_step: Callable[..., tuple]
    # (params, kernel_view, token, *, impl=None) -> (logits, rows_k, rows_v);
    # None for the ssm family
    decode_step_paged: Callable[..., tuple] | None
    # (params, batch) -> (mean masked cross-entropy, {"ce": ...}); batch
    # holds tokens/labels (B, S) int and mask (B, S) f32
    loss: Callable[..., tuple]


def build(cfg, device=None) -> Model:
    if cfg.family not in ("dense", "ssm") or (cfg.family == "ssm") != bool(cfg.ssm_state) \
            or cfg.n_experts or cfg.hybrid or cfg.encoder_layers or cfg.frontend:
        where = _NOT_PORTED.get(cfg.family, "ROADMAP A12")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; see {where}"
        )
    dev = resolve_device(device)

    def init(seed: int | torch.Generator = 0, *, param_dtype=None) -> Params:
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return transformer.init_lm(cfg, gen, dev, param_dtype=param_dtype)

    def loss(params, batch):
        # the reference's own attention route: the flash kernel has no
        # backward in either package
        hidden, _, _ = transformer.forward_lm(cfg, params, batch["tokens"], impl="ref")
        ce = transformer.chunked_softmax_xent(cfg, params, hidden, batch["labels"],
                                              batch["mask"])
        return ce, {"ce": ce}

    def init_cache(batch_size: int, max_len: int) -> dict:
        return transformer.init_cache(cfg, batch_size, max_len, device=dev)

    def prefill(params, tokens, cache=None, length=None, *, impl=None):
        if cache is None:
            cache = init_cache(tokens.shape[0], tokens.shape[1])
        return transformer.prefill_lm(cfg, params, tokens, cache, length=length, impl=impl)

    def decode_step(params, cache, token):
        return transformer.decode_step_lm(cfg, params, cache, token)

    decode_step_paged = None
    if cfg.family == "dense":
        def decode_step_paged(params, pview, token, *, impl=None):
            return transformer.decode_step_paged_lm(cfg, params, pview, token, impl=impl)

    return Model(cfg, dev, init, prefill, init_cache, decode_step, decode_step_paged, loss)


def synthetic_batch(cfg, batch: int, seq: int, seed: int = 0, device=None) -> dict:
    """Random batch with the right structure (smoke tests, examples):
    uniform token ids and labels, an all-ones mask. The draws differ from
    the reference's `jax.random` ones."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (2, batch, seq), generator=gen, dtype=torch.int32)
    return {"tokens": ids[0].to(dev), "labels": ids[1].to(dev),
            "mask": torch.ones((batch, seq), dtype=torch.float32, device=dev)}
