"""Model zoo: one interface over every architecture of the reference.

    model = build(cfg)                        # device: cuda unless device="cpu"
    params = model.init(seed)                 # or a torch.Generator
    unit = model.init_unit(seed, "layers.0")  # one unit of model.units, drawn alone
    loss, metrics = model.loss(params, batch)  # training (params from
                                              # model.init(seed, param_dtype=torch.float32))
    logits, cache = model.prefill(params, tokens, length=...)   # impl="ref": plain route
    logits, cache = model.prefill(params, tokens, patches=p)     # VLM: image prompts
    logits, cache = model.prefill(params, tokens, frames=f)      # encoder-decoder
    logits, cache = model.decode_step(params, cache, token)      # aligned mode
    logits, rows_k, rows_v = model.decode_step_paged(params, kernel_view, token)
    logits, cache = model.verify_step(params, cache, tokens, n_new)  # speculative verify

``batch`` holds tokens/labels (B, S) int and mask (B, S) f32, plus
``frames`` / ``patches`` (B, n_frontend_tokens, d) for the stubbed
audio / vision frontends.

Family gates, as in the reference: the paged decode and the verify step
exist for the attention-only decoder LMs (dense, MoE, VLM); the SSM and
hybrid families (recurrent state) and the encoder-decoder (cross caches)
have neither, so they serve in aligned mode only and not speculatively.
An MoE model's loss adds the router's load-balancing term, ``ce + 0.01 *
aux_loss``; a VLM's loss drops the frontend positions before the
cross-entropy. Every family trains on the rank world
(`train.train_step.make_step`); an MoE model's data-parallel steps pass
``route_world`` so that its shard routes as part of the global batch.

The model axis: ``build(cfg, tp=mesh)`` on a rank of a (data, model)
world with more than one column gives the model of this rank's column
(``model.tp``, that mesh): ``init`` and ``init_unit`` draw the
whole parameters (or unit) from the seed, as one process does, and keep
this column's slices (`train.sharding.param_specs`), and ``loss`` runs the
tensor-parallel forward on them. Every family has it: attention and MLPs
split as the reference's rule splits them (an MoE layer's experts over E,
or over each expert's ``ff``; a Mamba block's projections,
`ssm.mamba_block`; an encoder-decoder's three attentions,
`encdec.encdec_loss`). ``build(cfg, tp=mesh, replicate_ssm=True)`` keeps a
Mamba block's ``in_proj``, ``conv_w``, ``conv_b``, ``A_log`` and
``dt_bias`` whole (the reference's ``REPRO_REPLICATE_SSM=1``);
``Model.specs`` and ``Model.unit_specs`` give the specs with it, for the
step, the trainer and its checkpoints alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import encdec, moe, transformer
from repro_torch.train import sharding

Params = dict


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    device: torch.device
    init: Callable[..., Params]
    # (params, tokens, cache=None, length=None, *, impl=None, [patches= | frames=])
    # -> (logits, cache)
    prefill: Callable[..., tuple]
    init_cache: Callable[..., dict]
    # (params, cache, token) -> (logits, cache): the shared-cursor decode
    decode_step: Callable[..., tuple]
    # (params, kernel_view, token, *, impl=None) -> (logits, rows_k, rows_v);
    # None for the ssm, hybrid and encdec families
    decode_step_paged: Callable[..., tuple] | None
    # (params, batch) -> (mean masked cross-entropy, {"ce": ...}); MoE: (ce +
    # 0.01 * aux_loss, {"ce", "aux_loss", "router_entropy"}); an LM's also
    # takes route_world= (`moe.RouteWorld`): `world_metrics` are then the
    # world's, and "aux_share" carries this row's gradient
    loss: Callable[..., tuple]
    # (params, cache, tokens (B, S), n_new (B,)) -> (logits (B, S, V), cache):
    # one batched forward scoring a speculative chunk (serve/spec.py);
    # None where decode_step_paged is
    verify_step: Callable[..., tuple] | None = None
    # the names of the metrics `loss` returns, sorted
    metrics: tuple[str, ...] = ("ce",)
    # those that `loss(..., route_world=)` computes for the world's global
    # batch; empty where the loss has nothing to route over a world
    world_metrics: tuple[str, ...] = ()
    # the units of the parameters, in order (`train.sharding.units_of`)
    units: tuple[str, ...] = ()
    # (seed, unit, *, param_dtype=None, device=None) -> the unit's parameters,
    # drawn from the unit's own generator (`_unit_seed`): one process and every
    # row of a world draw the same values, a unit at a time
    init_unit: Callable[..., Params] | None = None
    # the rank's `launch.mesh.Mesh` whose column of the model this is, on a
    # model axis of more than one column; None without one
    tp: Any = None
    # the reference's REPRO_REPLICATE_SSM: a Mamba block's in_proj, conv and
    # A_log / dt_bias whole on every column (`train.sharding.spec_for_leaf`)
    replicate_ssm: bool = False

    def specs(self, tree) -> list[tuple]:
        """`train.sharding.spec_list` of a whole tree of this model's
        structure over its model axis (``tp``), with its ``replicate_ssm``."""
        return sharding.spec_list(tree, self.tp.model_size, replicate_ssm=self.replicate_ssm)

    def unit_specs(self, name: str, unit) -> list[tuple]:
        """`train.sharding.unit_specs` of one whole unit, as `specs`."""
        return sharding.unit_specs(name, unit, self.tp.model_size,
                                   replicate_ssm=self.replicate_ssm)


def frontend_key(cfg) -> str | None:
    """The batch and prefill key of a config's frontend input."""
    return {"audio": "frames", "vision": "patches"}.get(cfg.frontend) if cfg.frontend else None


def _frontend_input(cfg, inputs: dict):
    """The frontend embeddings among a prefill's keyword ``inputs`` (None
    when absent); a key the config does not take is a TypeError."""
    key = frontend_key(cfg)
    extra = set(inputs) - {key}
    if extra:
        raise TypeError(f"{cfg.name}: prefill takes no {sorted(extra)} "
                        f"(its frontend input is {key!r})")
    return inputs.get(key)


def _seeded_init(fn, cfg, dev, tp=None, replicate_ssm: bool = False):
    def init(seed: int | torch.Generator = 0, *, param_dtype=None) -> Params:
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        whole = fn(cfg, gen, dev, param_dtype=param_dtype)
        if tp is None:
            return whole
        specs = sharding.spec_list(whole, tp.model_size, replicate_ssm=replicate_ssm)
        return sharding.shard_model(whole, specs, tp.model_size, tp.col)

    return init


def _unit_seed(seed: int, index: int) -> int:
    """The seed of the generator that draws unit ``index`` of a model
    initialised from ``seed`` unit by unit."""
    return int(seed) * 1_000_003 + index


def _unit_init(fn, cfg, dev, units: tuple[str, ...], tp=None,
               replicate_ssm: bool = False):
    def init_unit(seed: int, unit: str, *, param_dtype=None, device=None) -> Params:
        d = dev if device is None else torch.device(device)
        # a meta tree (shapes alone) draws nothing, from a CPU generator
        gen = torch.Generator(device="cpu" if d.type == "meta" else d)
        gen.manual_seed(_unit_seed(seed, units.index(unit)))
        whole = fn(cfg, unit, gen, d, param_dtype=param_dtype)
        if tp is None:
            return whole
        specs = sharding.unit_specs(unit, whole, tp.model_size, replicate_ssm=replicate_ssm)
        return sharding.shard_model(whole, specs, tp.model_size, tp.col)

    return init_unit


def model_axis(cfg, tp):
    """``tp`` (a rank's `launch.mesh.Mesh`, or None) where its model axis
    has more than one column, else None."""
    if tp is None or tp.model_size == 1:
        return None
    return tp


def build(cfg, device=None, *, tp=None, replicate_ssm: bool = False) -> Model:
    """The model of ``cfg`` on ``device``; ``tp``: the rank's
    `launch.mesh.Mesh`, on a world of more than one column (this rank's
    column of the model); ``replicate_ssm``: the reference's
    ``REPRO_REPLICATE_SSM=1`` layout of a Mamba block on that axis."""
    dev = resolve_device(device)
    axis = model_axis(cfg, tp)
    if cfg.family == "encdec":
        return _build_encdec(cfg, dev, axis, replicate_ssm)
    return _build_lm(cfg, dev, axis, replicate_ssm)


def _build_lm(cfg, dev, tp=None, replicate_ssm: bool = False) -> Model:
    def loss(params, batch, *, route_world=None):
        # the reference's own attention route: the flash kernel has no
        # backward in either package
        extra = batch.get(frontend_key(cfg))
        hidden, aux, _, _ = transformer.forward_lm(cfg, params, batch["tokens"],
                                                   extra_embeds=extra, impl="ref",
                                                   route_world=route_world, tp=tp)
        if extra is not None:  # frontend positions carry no next-token loss
            hidden = hidden[:, extra.shape[1]:]
        ce = transformer.chunked_softmax_xent(cfg, params, hidden, batch["labels"],
                                              batch["mask"], tp=tp)
        if aux:
            return ce + 0.01 * aux["aux_loss"], {"ce": ce, **aux}
        return ce, {"ce": ce}

    def init_cache(batch_size: int, max_len: int) -> dict:
        return transformer.init_cache(cfg, batch_size, max_len, device=dev)

    def prefill(params, tokens, cache=None, length=None, *, impl=None, **inputs):
        extra = _frontend_input(cfg, inputs)
        if cache is None:  # frontend tokens occupy cache slots too
            n_extra = extra.shape[1] if extra is not None else 0
            cache = init_cache(tokens.shape[0], tokens.shape[1] + n_extra)
        return transformer.prefill_lm(cfg, params, tokens, cache, extra_embeds=extra,
                                      length=length, impl=impl)

    def decode_step(params, cache, token):
        return transformer.decode_step_lm(cfg, params, cache, token)

    decode_step_paged = verify_step = None
    if cfg.family != "ssm" and not cfg.hybrid:
        def decode_step_paged(params, pview, token, *, impl=None):
            return transformer.decode_step_paged_lm(cfg, params, pview, token, impl=impl)

        def verify_step(params, cache, tokens, n_new):
            return transformer.verify_step_lm(cfg, params, cache, tokens, n_new)

    world_metrics = moe.AUX_METRICS if cfg.n_experts else ()
    units = transformer.lm_units(cfg)
    return Model(cfg, dev, _seeded_init(transformer.init_lm, cfg, dev, tp, replicate_ssm),
                 prefill, init_cache, decode_step, decode_step_paged, loss, verify_step,
                 metrics=tuple(sorted(("ce",) + world_metrics)), world_metrics=world_metrics,
                 units=units, tp=tp, replicate_ssm=replicate_ssm,
                 init_unit=_unit_init(transformer.init_lm_unit, cfg, dev, units, tp,
                                      replicate_ssm))


def _build_encdec(cfg, dev, tp=None, replicate_ssm: bool = False) -> Model:
    def loss(params, batch):
        ce = encdec.encdec_loss(cfg, params, batch.get("frames"), batch["tokens"],
                                batch["labels"], batch["mask"], impl="ref", tp=tp)
        return ce, {"ce": ce}

    def init_cache(batch_size: int, max_len: int, n_frames: int | None = None) -> dict:
        return encdec.init_encdec_cache(cfg, batch_size, max_len,
                                        n_frames or cfg.n_frontend_tokens, device=dev)

    def prefill(params, tokens, cache=None, length=None, *, impl=None, frames=None):
        """Encode ``frames``, prime the cross-attention cache, and run the
        teacher-forced decoder over ``tokens`` into the self-attention
        cache (64 positions of room past the prompt when the cache is
        made here, as in the reference)."""
        if length is not None:
            raise ValueError("length-masked prefill needs a decoder-only attention model")
        if cache is None:
            cache = init_cache(tokens.shape[0], tokens.shape[1] + 64)
        memory = encdec.encode(cfg, params, frames, impl=impl)
        cache = encdec.prime_cross_cache(cfg, params, memory, cache)
        hidden, kv = encdec.decode_train(cfg, params, tokens, memory, want_kv=True, impl=impl)
        s = tokens.shape[1]
        for li, (kf, vf) in enumerate(kv):
            cache["k"][li, :, :s] = kf.to(cache["k"].dtype)
            cache["v"][li, :, :s] = vf.to(cache["v"].dtype)
        cache["pos"] = torch.full((), s, dtype=torch.int32, device=hidden.device)
        return transformer.lm_logits(cfg, params, hidden[:, -1:]), cache

    def decode_step(params, cache, token):
        return encdec.decode_step_encdec(cfg, params, cache, token)

    units = encdec.encdec_units(cfg)
    return Model(cfg, dev, _seeded_init(encdec.init_encdec, cfg, dev, tp, replicate_ssm),
                 prefill, init_cache, decode_step, None, loss, units=units, tp=tp,
                 replicate_ssm=replicate_ssm,
                 init_unit=_unit_init(encdec.init_encdec_unit, cfg, dev, units, tp,
                                      replicate_ssm))


def synthetic_batch(cfg, batch: int, seq: int, seed: int = 0, device=None) -> dict:
    """Random batch with the right structure (smoke tests, examples):
    uniform token ids and labels, an all-ones mask, and for a frontend
    config its embeddings, N(0, 0.02^2). The draws differ from the
    reference's `jax.random` ones."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (2, batch, seq), generator=gen, dtype=torch.int32)
    out = {"tokens": ids[0].to(dev), "labels": ids[1].to(dev),
           "mask": torch.ones((batch, seq), dtype=torch.float32, device=dev)}
    key = frontend_key(cfg)
    if key:
        out[key] = (torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
                    * 0.02).to(dev)
    return out
