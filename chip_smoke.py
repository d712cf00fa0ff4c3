#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failure exits non-zero and
prints no result:

1. device   — the card's name and power limit (nvidia-smi); TF32 off.
2. build    — nvcc builds every kernel of the main path from
               ``src/repro_torch/kernels/csrc`` into ``build/repro_torch``.
3. kernels  — each kernel against its plain PyTorch version on the card,
               at the main path's full-width shapes (paged decode also
               with f32 q and pools, at f32 precision, at
               starcoder2-15b's group of 12 heads of 128, and at the long
               arm's decode shape, 2 slots of 15,000 and 9,500 positions
               over qwen2.5-3b's 16/2 heads of 128); flash attention
               in f32 at S=1000 and in bf16 at the prefill shapes of both
               serve arms and of starcoder2-15b; the SSD scan in f32
               at S=1000, in bf16 at S=2048, 8192 and 16,000), with CUDA-event
               times of the kernel, the plain version, the bound and (where
               one exists) the one PyTorch call computing the same function,
               and the profiler's device time of each (``*_device_ms``; the
               SSD scan's also split by launch).
4. serve    — tinyllama-1.1b at full width, random weights from --seed,
               through `make_engine` with continuous batching over the
               paged KV store and prefix cache: 16 requests drained, launch
               counts checked against the prefill calls and decode ticks,
               the first prefill call's and the first decode tick's logits
               held against the plain path; then a short int8-pool arm.
5. profile  — 16 decode-only ticks of a fresh engine on the host clock,
               16 more under `torch.profiler`: wall and device time per
               tick, the device's idle share, device time by kernel class
               (not part of the counts).
6. long     — qwen2.5-3b at full width and depth, random bf16 weights
               from --seed, the same engine with 2 slots and max_len
               16384: four prompts of 9,500-15,000 tokens (two share a
               12,000-token document), prefill through the flash kernel,
               the same checks, prefill time per call, prefill tokens/s
               and time to first token; then 8 decode ticks of 2 slots
               at 15,000 and 9,500 tokens profiled as in phase 5.
7. mamba    — mamba2-130m at full width and depth, random bf16 weights
               from --seed, through `make_engine` in aligned mode over
               the dense store (8 slots, max_len 16384): 16 prompts of
               1,000-16,000 tokens, 64 new tokens each, every prefill
               through the SSD-scan kernel; launch counts, the first
               prefill call's and the first decode tick's logits against
               the plain route, the same times; then one 8192-token
               prefill call under `torch.profiler` (device time by
               kernel class: the SSD kernel's share of a call) and the
               profile phase's decode window on an aligned mamba engine.
   The kernels phase also holds chunk_accumulate against its plain
   version (bit for bit at the train phase's (2, 465,567,744) f32 fold
   and at a ragged S; 1e-6 at n = 7 and at 16 rows of bf16); the argmax
   at each serve arm's decode shape ((8, 32,000), (2, 151,936), (8,
   50,280)) and at two admission rows (the last position of (1, 1024, V),
   V = 32,000 and 151,936), maxima planted at its split's edges, exact,
   with host microseconds per call beside `torch.argmax`'s; and the keyed
   histogram (2^26 Zipf keys into 151,936 bins, the same keys with the
   bins permuted, 2^26 uniform keys with f32 and bf16 counts, 4,096 bins,
   and 2^24 keys at 58,112 / 58,113 bins, the plan's path boundary),
   exact at counts of 1.
8. train    — qwen1.5-0.5b at full width and depth, random f32 weights
               from --seed, through `Trainer` in a four-row gloo world on
               this card (`launch.mesh.spawn`; the wire is host loopback),
               3 AdamW steps of 2,048-token sequences in each run:
               decoupled mode (three compute rows and one reducer, 6
               sequences, the reducer folding each wave of 16 MiB gradient
               chunks with chunk_accumulate: launches checked, waves x
               steps), checkpointing at steps 2 and 3 into a temporary
               directory (row 0 reads step 3 back, bit for bit against the
               live state); a fresh trainer in overlap mode resuming from
               step 2 and taking step 3 (its loss against the decoupled
               run's step 3); then the data-parallel conventional step and
               the ZeRO-1 overlap step on 8 sequences (chunk_accumulate
               launched 0 times). Per run and step the loss and the
               slowest rank's time; per rank the phases, wire and staging
               bytes and seconds, peak device and host memory, moment bytes
               held, checkpoint bytes and seconds. Then one SGD step (lr 1)
               of each mode in the world held against the conventional
               step in one process in f32 (1e-4 of the largest gradient),
               and reported in bf16.
9. mapreduce — the paper's word-count MapReduce (Sec. IV-B) in an
               eight-row gloo world on this card (`launch.mesh.spawn`;
               the wire is host loopback): 16,384 documents of 4,096 word
               slots (Zipf ids, skewed lengths, from --seed) over qwen's
               151,936-word vocabulary, 8,192-word (64 KiB) elements, run
               through `apps.mapreduce.run_wordcount` in the reference
               (8 map rows and one sum), decoupled (6 map rows, 2 reduce
               rows, 3 waves) and pipelined (5 map, 2 reduce, 1 io) modes,
               and decoupled again at 32,000 words (the histogram's block
               path); every reduce-side fold and every local map is the
               keyed-histogram kernel. Each run's histogram equals
               `np.bincount` of the valid words bit for bit on every row,
               the modes agree, and the kernel's launches, summed over
               ranks, equal the schedule's (`histogram_launches`); per run
               the slowest rank's wall time, per-rank phases (map/pack,
               stream+fold, group sum, broadcast), wire bytes, words per
               second and peak memory. Then the measured variant's
               counters against the host's per-row counts, the fold at
               its own shape on a reduce row (`fold_case`: the kernel
               against its plain version bit for bit, both timed beside
               `torch.bincount` and the bound), and the quickstart's
               workload statistics.
10. cg      — the paper's CG Poisson solver (Sec. IV-C) in an eight-row
               gloo world on this card: the paper's 120^3 grid per process
               and its 300 iterations (a 1,008 x 120 x 120 global grid,
               x-slabs of 126 over 8 rows, or of 144 over 7 compute rows
               and a halo row), through `apps.cg.run_cg`'s set-up and
               solve (the clock around the solve alone) in the blocking,
               nonblocking and decoupled halo modes: blocking and
               nonblocking bit for bit, decoupled within `CG_FIRST_REL`
               and `CG_ALL_REL` of blocking, every mode converging, and
               each reported residual against ||b - A u|| recomputed in
               float64 on the host; per mode the slowest rank's wall time
               and seconds per iteration, wire statistics and peak memory
               per rank; the stencil of one slab timed alone.
11. pic     — the paper's particle-in-cell mini-app (Sec. IV-D) in an
               eight-row gloo world on this card: 2^21 particles (skew
               0.8, from --seed) in 2^20-slot rows, 8 steps, through
               `apps.pic.run_pic` with neighbour forwarding (8 rows), the
               decoupled comm row (7 + 1), and the comm row beside the io
               row buffering every step's trace (6 + 1 + 1); particles
               conserved at every step and on the rows owning them, the
               valid (x, v) over all rows equal to a numpy replay of the
               push from the run's initial particles, 144 trace chunks on
               the io row; then the io run's final state streamed to a
               `HostSink` (`io.iogroup.stream_to_io_group`, 18 chunks of
               4 MiB) and the drained file held against the packed state
               bit for bit; per run wall time, seconds per step, movers
               per step, wire bytes, peak memory, the drain's bytes and
               seconds.
12. summary — a ``{"kernels": [...]}`` line (the histogram's times are
               the fold's, the path's shape), then the last line
               ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository beside it, the script
exits non-zero before printing any result. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
# tolerances, stated before the run
# paged decode, bf16 and int8 pools: per slot, max |kernel - plain| over the
# rms of the plain output. The kernel keeps scores, probabilities and
# dequantised rows in f32; the plain version rounds each of them to bf16,
# which at these shapes moves a slot's largest element by up to ~0.05 of
# the slot's rms (int8 worst). Dropping the heaviest live position of a
# slot moves it by ~0.3, so 1/8 leaves room for rounding and not for that;
# the f32 cases below pin the masks and the walk exactly.
PAGED_REL = 2.0 ** -3
# paged decode, f32 q and pools (f32 and int8): absolute, as the GPU tests
# hold it. Dropping or adding one live position moves a slot's output by
# ~1/len(slot) (>= 5e-4 here), so this pins the masks and the table walk.
PAGED_F32_ATOL = 2e-5
# first decode tick, kernel path vs plain path, bf16 logits (~4-5 at most,
# one bf16 ulp 0.03): the plain path rounds its probabilities to bf16, the
# kernel does not; more layers drift further
LOGIT_BUDGET = {"tinyllama-1.1b": 0.125, "qwen2.5-3b": 0.25}
# flash attention, f32 cases: absolute, the reference's own f32 kernel
# budget (tests/test_kernels.py). At S=1000 dropping or adding one live
# key moves a late row by ~1e-3, so this pins the masks and the tile range.
FLASH_F32_ATOL = 2e-5
# flash attention, bf16 cases: per output row (one query position and
# head), max |kernel - plain| over the rms of the plain row. Both take
# f32 scores from the same bf16 inputs and round the output once; the
# kernel also rounds P to bf16 before P.V on the tensor cores (2^-9 of
# each probability, ~0.002 of a row's rms), the plain version does not.
# One output ulp is 2^-8 to 2^-7 of an element and a row's largest
# elements reach ~4x its rms: up to ~0.03 with the P rounding. A wrong
# head or tile moves a row by about its rms; the f32 cases pin the masks
# exactly.
FLASH_REL = 2.0 ** -4
# first prefill call, kernel path vs the plain route (`impl="ref"`), bf16
# last-position logits. Logits reach ~4-5, where one bf16 ulp is 0.03. The
# plain route rounds scores and probabilities to bf16 while the kernel
# keeps f32, so a few ulps of drift are expected over 22 layers
# (tinyllama, plain attention) and more over 36 (qwen2.5-3b, blockwise
# attention past 8192 tokens, which also rounds each block's P to bf16).
PREFILL_BUDGET = {"tinyllama-1.1b": 0.125, "qwen2.5-3b": 0.25}
# The greedy tokens of those rows are reported, not checked. With random
# weights a row's top-2 margin can be under one bf16 ulp, where rounding
# alone may flip the token; and any check limited to rows with a wider
# margin follows from the logit budget already checked.
# SSD scan, f32 cases: absolute, for y and the final state. Inputs are the
# model's A (-linspace(1, 16)) and dt (softplus of N(0, 1)), or the
# reference test's dt (U(0.01, 0.2), tests/test_kernels.py), or A = -16
# with dt ~ 1; B and C at unit-variance C.B, so y is O(1). Both sides'
# f32 error (the prefix sums of dt * A) is ~3e-5 against f64 at the
# model's inputs. A wrong chunk, head or mask moves y by O(1); padded
# tail positions that shift the last chunk's prefix sums by an ulp of
# |cum| move the final state by ~3e-4 at A = -16.
SSD_F32_ATOL = 1e-4
# SSD scan, bf16 cases: per output row (one position and head), max
# |kernel - plain| over the rms of the plain row. Both take the same bf16
# inputs and round y once: at most one bf16 ulp of an element apart (2^-7
# of it, and an element reaches ~4x its row's rms): the kernel's
# tensor-core body takes every f32 operand as two bf16 terms (2^-17 of
# it). The f32 final state keeps SSD_F32_ATOL.
SSD_REL = 2.0 ** -4
# mamba arm: the first prefill call's last-position logits and the first
# decode tick's logits (slot 0), kernel path vs the plain route, bf16.
# The two routes differ only in the scan's summation order (the kernel's
# f32 operands enter its tensor cores as two bf16 terms), so the logits
# should agree to a few bf16 ulps (logits of random weights reach ~2-4,
# where an ulp is 0.0156-0.031); a wrong chunk or head moves them by O(1).
MAMBA_LOGIT_BUDGET = 0.125
# chunk_accumulate: at n = 2 (the stream channel's call: accumulator and
# the wave's staging) one rounding of a + b on either side, so bit for bit,
# ragged S included. At n > 2 and for bf16 input: |kernel - plain| <= 1e-6
# x max_j sum_k |x[k, j]|; another summation order moves a column by at
# most (n - 1) ulps of that sum (n = 16: ~1e-6), a missed or doubled row
# by about one |x[k, j]|.
ACC_REL = 1e-6
# histogram: with counts of 1 (word counts) every bin is an exact integer
# while it stays under 2^24, which this run checks, so the kernel must
# equal its plain version bit for bit: any error is a dropped or misplaced
# key. Otherwise max |kernel - plain| over the largest bin of the plain
# version: atomics add in a varying order.
HIST_REL = 1e-5
# train phase, f32 parity step (SGD, lr 1: new params = params - gradient):
# the decoupled world against the conventional step in one process on the
# same global batch, max |difference| over the largest gradient element.
# Both compute in f32 with TF32 off; the three compute rows' partial
# gradients are summed in another order than one batch's backward, a few
# f32 ulps of the largest gradient (the reference's own budget is 1e-5
# absolute on the f32 smoke config, tests/test_multidevice.py).
TRAIN_PARITY_REL = 1e-4

PAGED_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
PAGED_TPU = "src/repro/kernels/paged_attention/paged_attention.py:135"
ARGMAX_SRC = "src/repro_torch/kernels/csrc/argmax_last.cu"
ARGMAX_TPU = "src/repro/kernels/sample/sample.py:50"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:80"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_TPU = "src/repro/kernels/ssd_scan/ssd_scan.py:83"
REDUCE_SRC = "src/repro_torch/kernels/csrc/stream_reduce.cu"
ACC_TPU = "src/repro/kernels/stream_reduce/stream_reduce.py:104"
HIST_TPU = "src/repro/kernels/stream_reduce/stream_reduce.py:51"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fns, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call over ``iters`` calls, cycling through ``fns``
    (several copies of the inputs, so a call can find its data out of L2)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(ev) -> float:
    """A profiler event's own device time in microseconds."""
    us = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if us is None else us


def device_ms_by_kernel(torch, fns, iters: int = 20) -> dict[str, float]:
    """Mean device ms per call of each kernel (by name) from one
    `torch.profiler` window: the kernels' own time, without the gaps where
    the device waits for the host to issue the next launch (which
    `cuda_ms` includes). Empty when the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns[:2]:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    return {ev.key: device_us(ev) / 1e3 / iters for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and device_us(ev)}


def device_ms(torch, fns, iters: int = 20) -> float | None:
    """Mean device time per call of all kernels in the window; None when
    the profiler sees no device activity."""
    by_kernel = device_ms_by_kernel(torch, fns, iters)
    return sum(by_kernel.values()) if by_kernel else None


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: kernels against their plain versions ----------------------------


def paged_case(torch, np, *, quantized: bool, window: int, seed: int, dtype,
               h: int = 32, n_kv: int = 4, hd: int = 64, mb: int = 128, cursors=None):
    """Full-width decode shapes: 8 slots, 32 query heads over 4 KV heads of
    64 (tinyllama-1.1b) unless given, 16-token blocks, 128 blocks per
    table. Slot 0 has pos 0, slot 1 is an inactive slot (pos = mb*bs,
    all -1 table), the rest hold 256..1900 tokens in randomly placed
    blocks, unmapped tail -1; or, given ``cursors``, one slot per cursor.
    q, the new rows and a float pool are in ``dtype``."""
    from repro_torch.core.operators import kv_quantize

    bs = 16
    rng = np.random.default_rng(seed)
    if cursors is None:
        pos = np.concatenate([[0, mb * bs], rng.integers(256, 1900, 6)]).astype(np.int32)
    else:
        pos = np.asarray(cursors, np.int32)
    b = len(pos)
    d_kv = n_kv * hd
    nb = b * mb + 1
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    table = np.full((b, mb), -1, np.int32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    used = 0
    for i, p in enumerate(pos):
        if p >= mb * bs:
            continue
        n = -(-int(p) // bs)
        table[i, :n] = perm[used : used + n]
        used += n
    k_pool, v_pool = randn(nb, bs, d_kv), randn(nb, bs, d_kv)
    k_pool[0] = 0  # the store's permanent zero block
    v_pool[0] = 0
    scales = {}
    if quantized:
        k_pool, ks = kv_quantize(k_pool)
        v_pool, vs = kv_quantize(v_pool)
        scales = {"k_scale": ks, "v_scale": vs}
    args = dict(q=randn(b, 1, h, hd), k_new=randn(b, d_kv), v_new=randn(b, d_kv),
                k_blocks=k_pool, v_blocks=v_pool,
                table=torch.as_tensor(table, device="cuda"),
                pos=torch.as_tensor(pos, device="cuda"))
    kw = dict(n_kv=n_kv, window=window, scale=1.0 / math.sqrt(hd), **scales)

    # bound: every distinct live pool row once, plus q, the new rows, the
    # table, the cursors and the output
    rows = set()
    live_total = 0
    for i, p in enumerate(pos):
        lo = max(0, int(p) + 1 - window) if window > 0 else 0
        hi = min(int(p), mb * bs)
        live_total += max(0, hi - lo) + (1 if p < mb * bs else 0)
        for t in range(lo, hi):
            rows.add((max(int(table[i, t // bs]), 0), t % bs))
    row_bytes = 2 * d_kv * k_pool.element_size() + (8 if quantized else 0)
    io_bytes = (2 * b * h * hd + 2 * b * d_kv) * args["q"].element_size() \
        + table.nbytes + pos.nbytes
    flops = 4.0 * h * hd * live_total
    return args, kw, len(rows) * row_bytes + io_bytes, flops


def slot_rel_err(out, ref) -> float:
    """Max over slots of max |out - ref| / rms(ref) within the slot (an
    all-zero reference slot, the inactive one, must come out exactly)."""
    d = (out.float() - ref.float()).flatten(1).abs().amax(1)
    rms = ref.float().flatten(1).square().mean(1).sqrt().clamp_min(1e-6)
    return (d / rms).max().item()


def check_paged_f32(torch, np, seed: int) -> None:
    """The kernel's logic at f32 precision (f32 and int8 pools, full and
    windowed layers), where a single misplaced position shows."""
    from repro_torch.kernels.paged_attention import ops

    for quantized in (False, True):
        for window in (0, 256):
            args, kw, _, _ = paged_case(torch, np, quantized=quantized, window=window,
                                        seed=seed, dtype=torch.float32)
            kw["dequant_dtype"] = torch.float32  # the kernel always dequantises in f32
            out = ops.paged_decode_attention(**args, **kw)
            ref = ops.paged_decode_attention(**args, **kw, impl="ref")
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            case = {"phase": "kernels", "kernel": "paged_decode_attention", "q": "f32",
                    "pool": "int8" if quantized else "f32", "window": window,
                    "max_abs_err": err, "atol": PAGED_F32_ATOL,
                    "finite": bool(torch.isfinite(out).all().item())}
            emit(case)
            if not case["finite"] or not err <= PAGED_F32_ATOL:
                raise AssertionError(f"paged decode kernel disagrees with its plain version: {case}")


def check_paged_group12(torch, np, seed: int) -> None:
    """starcoder2-15b's KV group, 48 query heads over 4 KV heads of 128
    (12 x 128 outputs per block): f32 at PAGED_F32_ATOL, bf16 at
    PAGED_REL."""
    from repro_torch.kernels.paged_attention import ops

    for dtype in (torch.float32, torch.bfloat16):
        args, kw, _, _ = paged_case(torch, np, quantized=False, window=0, seed=seed,
                                    dtype=dtype, h=48, n_kv=4, hd=128)
        out = ops.paged_decode_attention(**args, **kw)
        ref = ops.paged_decode_attention(**args, **kw, impl="ref", dequant_dtype=dtype)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = slot_rel_err(out, ref)
        f32 = dtype == torch.float32
        case = {"phase": "kernels", "kernel": "paged_decode_attention", "heads": [48, 4, 128],
                "q": "f32" if f32 else "bf16", "pool": "f32" if f32 else "bf16", "window": 0,
                "max_abs_err": err, "max_slot_rel_err": rel,
                "atol" if f32 else "rel_budget": PAGED_F32_ATOL if f32 else PAGED_REL,
                "finite": bool(torch.isfinite(out).all().item())}
        emit(case)
        if not case["finite"] or not (err <= PAGED_F32_ATOL if f32 else rel <= PAGED_REL):
            raise AssertionError(f"paged decode kernel disagrees at a 12 x 128 group: {case}")


# the long arm's decode shape: qwen2.5-3b's 16 query heads over 2 KV heads
# of 128, 16-token blocks, 1,024 blocks per table (max_len 16,384), two
# slots at the cursors of the arm's 15,000- and 9,500-token prompts
LONG_PAGED = dict(h=16, n_kv=2, hd=128, mb=1024, cursors=(15_000, 9_500))


def check_paged_long(torch, np, seed: int) -> dict:
    """The long decode shape: f32 at PAGED_F32_ATOL, then bf16 at
    PAGED_REL with kernel, plain and bound times."""
    from repro_torch.kernels.paged_attention import ops

    args, kw, _, _ = paged_case(torch, np, quantized=False, window=0, seed=seed,
                                dtype=torch.float32, **LONG_PAGED)
    out = ops.paged_decode_attention(**args, **kw)
    ref = ops.paged_decode_attention(**args, **kw, impl="ref", dequant_dtype=torch.float32)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    case = {"phase": "kernels", "kernel": "paged_decode_attention", "case": "long arm",
            "heads": [16, 2, 128], "cursors": list(LONG_PAGED["cursors"]), "q": "f32",
            "pool": "f32", "window": 0, "max_abs_err": err, "atol": PAGED_F32_ATOL,
            "finite": bool(torch.isfinite(out).all().item())}
    emit(case)
    if not case["finite"] or not err <= PAGED_F32_ATOL:
        raise AssertionError(f"paged decode kernel disagrees at the long shape: {case}")
    del args, out, ref
    args, kw, nbytes, flops = paged_case(torch, np, quantized=False, window=0, seed=seed,
                                         dtype=torch.bfloat16, **LONG_PAGED)
    out = ops.paged_decode_attention(**args, **kw)
    ref = ops.paged_decode_attention(**args, **kw, impl="ref", dequant_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rel = slot_rel_err(out, ref)
    finite = bool(torch.isfinite(out).all().item())
    # cold L2: 4 pool copies (4 x 2 x 16.8 MB)
    copies = [dict(args, k_blocks=args["k_blocks"].clone(), v_blocks=args["v_blocks"].clone())
              for _ in range(4)]
    kern = [lambda a=a: ops.paged_decode_attention(**a, **kw) for a in copies]
    plain = [lambda a=a: ops.paged_decode_attention(
        **a, **kw, impl="ref", dequant_dtype=torch.bfloat16) for a in copies]
    b_ms, b_by = bound_ms(nbytes, flops)
    case = {"phase": "kernels", "kernel": "paged_decode_attention", "case": "long arm",
            "heads": [16, 2, 128], "cursors": list(LONG_PAGED["cursors"]), "q": "bf16",
            "pool": "bf16", "window": 0,
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "max_slot_rel_err": rel, "rel_budget": PAGED_REL, "finite": finite,
            "kernel_ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain, 20),
            "kernel_device_ms": device_ms(torch, kern),
            "plain_device_ms": device_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    emit(case)
    if not finite or not rel <= PAGED_REL:
        raise AssertionError(f"paged decode kernel disagrees at the long shape: {case}")
    del copies, kern, plain
    torch.cuda.empty_cache()
    return case


def check_paged(torch, np, seed: int) -> dict:
    from repro_torch.kernels.paged_attention import ops

    check_paged_f32(torch, np, seed)
    check_paged_group12(torch, np, seed)
    cases = []
    for quantized in (False, True):
        for window in (0, 256):
            args, kw, nbytes, flops = paged_case(torch, np, quantized=quantized, window=window,
                                                 seed=seed, dtype=torch.bfloat16)
            out = ops.paged_decode_attention(**args, **kw)
            ref = ops.paged_decode_attention(**args, **kw, impl="ref",
                                             dequant_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = slot_rel_err(out, ref)
            finite = bool(torch.isfinite(out).all().item())
            # time against cold L2: cycle 8 pool copies (> 50 MB in all)
            copies = [dict(args, k_blocks=args["k_blocks"].clone(),
                           v_blocks=args["v_blocks"].clone()) for _ in range(8)]
            kern = [lambda a=a: ops.paged_decode_attention(**a, **kw) for a in copies]
            plain = [lambda a=a: ops.paged_decode_attention(
                **a, **kw, impl="ref", dequant_dtype=torch.bfloat16) for a in copies]
            b_ms, b_by = bound_ms(nbytes, flops)
            case = {"phase": "kernels", "kernel": "paged_decode_attention", "q": "bf16",
                    "pool": "int8" if quantized else "bf16", "window": window,
                    "max_abs_err": err, "max_slot_rel_err": rel, "rel_budget": PAGED_REL,
                    "finite": finite,
                    "kernel_ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain, 20),
                    "kernel_device_ms": device_ms(torch, kern),
                    "plain_device_ms": device_ms(torch, plain),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            emit(case)
            if not finite or not rel <= PAGED_REL:
                raise AssertionError(f"paged decode kernel disagrees with its plain version: {case}")
            cases.append(case)
    cases.append(check_paged_long(torch, np, seed))
    main = cases[0]  # bf16 pool, full layers: the main path's case
    return {"name": "paged_decode_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": PAGED_TPU, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["kernel_device_ms"], "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "library_device_ms": None}


# argmax at the shapes the serve arms launch, on the last position of
# (B, S, V) bf16 logits: each arm's decode tick (S = 1) and an admission's
# prefill row (S = 1024, rows strided by S x V). (case, B, S, V)
ARGMAX_CASES = [("tinyllama-1.1b decode", 8, 1, 32_000),
                ("qwen2.5-3b long-arm decode", 2, 1, 151_936),
                ("mamba2-130m decode", 8, 1, 50_280),
                ("tinyllama-1.1b admission", 1, 1024, 32_000),
                ("qwen2.5-3b admission", 1, 1024, 151_936)]


def host_us(torch, fn, calls: int = 1000) -> float:
    """Mean host microseconds per call over ``calls`` back-to-back calls,
    no synchronisation between them (what a host-bound tick pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def plant_argmax_ties(torch, last, span: int, splits: int) -> dict:
    """Plant maxima in the (B, V) rows ``last`` where the kernel's split
    meets them; returns row -> the index that must win (the first maximal
    one, NaN above all)."""
    b, vocab = last.shape
    starts = [span * j for j in range(1, splits)]
    want = {}
    # row 0: a tie at the first element of every span but the first
    last[0, starts or [0]] = 30.0
    want[0] = starts[0] if starts else 0
    if b > 1:  # row 1: ties at the last element of every span and of the row
        last[1, [s - 1 for s in starts] + [vocab - 1]] = 30.0
        want[1] = starts[0] - 1 if starts else vocab - 1
    if b > 2:  # row 2: all equal
        last[2] = 0.0
        want[2] = 0
    if b > 3:  # row 3: a NaN in the last span beats a +inf in the first
        last[3, 1] = float("inf")
        last[3, vocab - 2] = float("nan")
        want[3] = vocab - 2
    if b > 4:  # row 4: the maximum at the row's last element
        last[4, vocab - 1] = 30.0
        want[4] = vocab - 1
    return want


def check_argmax(torch, np, seed: int) -> dict:
    from repro_torch.kernels.sample import ops
    from repro_torch.kernels.sample.sample import argmax_split

    # planted ties at (8, 32,000), untimed: two far apart, two adjacent
    # (one 16-byte vector), an all-equal row, three within one span, and
    # the maximum at the row's end
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    logits = torch.randn((8, 1, 32_000), generator=gen, device="cuda").to(torch.bfloat16)
    logits[0, 0, [5, 31_000]] = 10.0
    logits[1, 0, [0, 1]] = 10.0
    logits[2, 0] = 0.0
    logits[3, 0, [100, 612, 20_000]] = 10.0
    logits[4, 0, [31_999]] = 10.0
    out = ops.sample_last(logits)
    ref = ops.sample_last(logits, impl="ref")
    err = (out.long() - ref.long()).abs().max().item()
    emit({"phase": "kernels", "kernel": "argmax_last", "case": "planted ties",
          "shape": [8, 1, 32_000], "dtype": "bf16", "max_abs_err": err})
    if err != 0 or out[:5].tolist() != [5, 0, 0, 100, 31_999]:
        raise AssertionError(f"argmax kernel {out.tolist()} != plain {ref.tolist()} "
                             "(planted ties at (8, 32,000))")
    cases = []
    for i, (name, b, s, vocab) in enumerate(ARGMAX_CASES):
        gen = torch.Generator(device="cuda").manual_seed(seed + 1 + i)
        logits = torch.randn((b, s, vocab), generator=gen, device="cuda").to(torch.bfloat16)
        span, splits = argmax_split(b, vocab, 2)
        want = plant_argmax_ties(torch, logits[:, -1], span, splits)
        out = ops.sample_last(logits)
        ref = ops.sample_last(logits, impl="ref")
        torch.cuda.synchronize()
        err = (out.long() - ref.long()).abs().max().item()
        got = {r: out[r].item() for r in want}
        if err != 0 or got != want:
            raise AssertionError(f"argmax kernel {out.tolist()} != plain {ref.tolist()} "
                                 f"(planted {want}) at {name}")
        last = logits[:, -1]
        kern = [lambda: ops.sample_last(logits)]
        plain = [lambda: ops.sample_last(logits, impl="ref")]
        lib = [lambda: torch.argmax(last, dim=-1)]
        b_ms, b_by = bound_ms(b * vocab * 2 + b * 4, float(b * vocab))
        case = {"phase": "kernels", "kernel": "argmax_last", "case": name,
                "shape": [b, s, vocab], "dtype": "bf16", "span": span, "splits": splits,
                "max_abs_err": err, "planted": want,
                "kernel_ms": cuda_ms(torch, kern, 200), "plain_ms": cuda_ms(torch, plain, 200),
                "library_ms": cuda_ms(torch, lib, 200),
                "kernel_device_ms": device_ms(torch, kern),
                "plain_device_ms": device_ms(torch, plain),
                "library_device_ms": device_ms(torch, lib),
                "library_call": "torch.argmax(logits[:, -1], dim=-1)",
                "kernel_host_us": host_us(torch, kern[0]),
                "library_host_us": host_us(
                    torch, lambda: torch.argmax(logits[:, -1], dim=-1).to(torch.int32)),
                "bound_ms": b_ms, "bound_by": b_by}
        emit(case)
        cases.append(case)
    main = cases[0]  # the tinyllama arm's decode tick: the main path's shape
    return {"name": "argmax_last", "route": "cuda", "source": ARGMAX_SRC,
            "replaces": ARGMAX_TPU, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["kernel_device_ms"], "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library_device_ms": main["library_device_ms"]}


# flash attention at the prefill shapes the serve arms launch: name, batch,
# length, query heads, KV heads, head dim, window, whether the plain
# version runs one batch row and KV group at a time (all heads' S x S f32
# scores and probabilities would take 2 x 34 GB at B=2, S=16384), timing
# iterations
FLASH_CASES = [
    ("tinyllama-1.1b packed prefill", 8, 1024, 32, 4, 64, 0, False, 20),
    ("qwen2.5-3b", 2, 16384, 16, 2, 128, 0, True, 3),
    ("qwen2.5-3b window 4096", 2, 16384, 16, 2, 128, 4096, True, 3),
    ("starcoder2-15b group", 1, 4096, 48, 4, 128, 0, False, 10),
]


def flash_inputs(torch, *, b, s, h, n_kv, hd, dtype, seed):
    """Model-layout (B, S, H, d) q and (B, S, Kv, d) k, v, N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return randn(b, s, h, hd), randn(b, s, n_kv, hd), randn(b, s, n_kv, hd)


def flash_plain(torch, ops, q, k, v, window: int, by_group: bool):
    """The plain version (`impl="ref"`), whole or one batch row and KV
    group at a time."""
    if not by_group:
        return ops.mha(q, k, v, window=window, impl="ref")
    n_kv = k.shape[2]
    rep = q.shape[2] // n_kv
    return torch.cat([torch.cat([ops.mha(q[i:i + 1, :, g * rep:(g + 1) * rep],
                                         k[i:i + 1, :, g:g + 1], v[i:i + 1, :, g:g + 1],
                                         window=window, impl="ref")
                                 for g in range(n_kv)], dim=2)
                      for i in range(q.shape[0])])


def live_pairs(np, sq: int, sk: int, window: int) -> int:
    """Causal (and windowed) live (query, key) pairs, start-aligned."""
    qp = np.arange(sq)
    hi = np.minimum(qp, sk - 1)
    lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros_like(qp)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def row_rel_err(out, ref) -> float:
    """Max over output rows (one query position and head) of
    max |out - ref| / rms(ref)."""
    d = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().square().mean(-1).sqrt().clamp_min(1e-6)
    return (d / rms).max().item()


def check_flash_f32(torch, np, seed: int) -> None:
    """The kernel's logic at f32 precision: S=1000 (not a multiple of the
    64-row and 64-key tiles), windows 0 and 256, groups of 8 (hd 64) and
    12 (hd 128)."""
    from repro_torch.kernels.flash_attention import ops

    for h, n_kv, hd in ((32, 4, 64), (48, 4, 128)):
        for window in (0, 256):
            q, k, v = flash_inputs(torch, b=2, s=1000, h=h, n_kv=n_kv, hd=hd,
                                   dtype=torch.float32, seed=seed)
            out = ops.mha(q, k, v, window=window)
            ref = ops.mha(q, k, v, window=window, impl="ref")
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            case = {"phase": "kernels", "kernel": "flash_attention", "dtype": "f32",
                    "shape": [2, 1000, h, n_kv, hd], "window": window, "max_abs_err": err,
                    "atol": FLASH_F32_ATOL, "finite": bool(torch.isfinite(out).all().item())}
            emit(case)
            if not case["finite"] or not err <= FLASH_F32_ATOL:
                raise AssertionError(f"flash kernel disagrees with its plain version: {case}")


def check_flash(torch, np, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    check_flash_f32(torch, np, seed)
    cases = []
    for name, b, s, h, n_kv, hd, window, by_group, iters in FLASH_CASES:
        q, k, v = flash_inputs(torch, b=b, s=s, h=h, n_kv=n_kv, hd=hd, dtype=torch.bfloat16,
                               seed=seed)
        out = ops.mha(q, k, v, window=window)
        ref = flash_plain(torch, ops, q, k, v, window, by_group)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        finite = bool(torch.isfinite(out).all().item())
        del out, ref
        torch.cuda.empty_cache()
        pairs = live_pairs(np, s, s, window)
        flops = 4.0 * b * h * hd * pairs
        b_ms, b_by = bound_ms((2 * b * s * h * hd + 2 * b * s * n_kv * hd) * 2, flops)
        kern = [lambda: ops.mha(q, k, v, window=window)]
        case = {"phase": "kernels", "kernel": "flash_attention", "case": name, "dtype": "bf16",
                "shape": [b, s, h, n_kv, hd], "window": window, "live_pairs": pairs,
                "max_abs_err": err, "max_row_rel_err": rel, "rel_budget": FLASH_REL,
                "finite": finite, "kernel_ms": cuda_ms(torch, kern, iters, warmup=1),
                "kernel_device_ms": device_ms(torch, kern, iters),
                "bound_ms": b_ms, "bound_by": b_by}
        case["kernel_tflops"] = flops / case["kernel_ms"] / 1e9
        if by_group:
            case.update(plain_ms=None, plain_device_ms=None,
                        plain_null_reason="all heads' S x S f32 scores do not fit one call; "
                                          "the check ran it one batch row and KV group "
                                          "at a time")
        else:
            plain = [lambda: ops.mha(q, k, v, window=window, impl="ref")]
            case.update(plain_ms=cuda_ms(torch, plain, iters, warmup=1),
                        plain_device_ms=device_ms(torch, plain, iters))
        if window == 0:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = [lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)]
            case.update(library_ms=cuda_ms(torch, lib, iters, warmup=1),
                        library_device_ms=device_ms(torch, lib, iters))
        else:
            case.update(library_ms=None, library_device_ms=None,
                        library_null_reason="no single library call takes a sliding window "
                                            "without an S x S mask")
        emit(case)
        if not finite or not rel <= FLASH_REL:
            raise AssertionError(f"flash kernel disagrees with its plain version: {case}")
        cases.append(case)
        del q, k, v, kern
        torch.cuda.empty_cache()
    main = cases[0]  # the tinyllama serve arm's packed prefill: the launches' shape
    return {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
            "replaces": FLASH_TPU, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["kernel_device_ms"], "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library_device_ms": main["library_device_ms"]}


def ssd_inputs(torch, *, b, s, h, p, n, dtype, seed, a=None, dt_range=None):
    """The scan's inputs in the model's layout: x, Bm and Cm are column
    slices of one (B, S, H*P + 2N) conv-output buffer; dt (B, S, H) and
    A (H,) f32. The model's A (-linspace(1, 16)) unless ``a`` gives -a;
    dt uniform in ``dt_range``, or the model's softplus(N(0, 1)) when it
    is None; B and C at unit-variance C.B."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    conv_out = torch.cat([randn(b, s, h * p), randn(b, s, 2 * n) / n ** 0.5], dim=-1).to(dtype)
    x, bm, cm = torch.split(conv_out, [h * p, n, n], dim=-1)
    if dt_range is None:
        dt = F.softplus(randn(b, s, h))
    else:
        dt = torch.empty((b, s, h), device="cuda").uniform_(*dt_range, generator=gen)
    A = (-torch.linspace(1.0, 16.0, h, device="cuda") if a is None
         else torch.full((h,), -float(a), device="cuda"))
    return x.reshape(b, s, h, p), dt, A, bm, cm


def ssd_work(*, b, s, h, p, n, q, elem) -> tuple[float, float]:
    """(bytes, flops) of one scan: x, B, C, dt and A read once, y and the
    final state written once; the chunked form's operations, C B^T once
    per (batch row, chunk) and 2 Q^2 P + 4 Q P N per head and chunk."""
    nc = -(-s // q)
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * elem + (b * s * h + h + b * h * p * n) * 4
    flops = b * nc * (2.0 * q * q * n + h * (2.0 * q * q * p + 4.0 * q * p * n))
    return nbytes, flops


# the scan at mamba2-130m's widths: (case, sequence length, timing iterations)
SSD_CASES = [("the mamba arm's shortest prompts", 2048, 40),
             ("mamba2-130m prefill, 8192 tokens", 8192, 20),
             ("the mamba arm's largest prompt", 16000, 10)]
# the scan's CUDA launches, by the stage their kernel's name carries
SSD_STAGES = ("chunk_state", "state_pass", "chunk_out")


def ssd_stage(kernel_name: str) -> str | None:
    return next((st for st in SSD_STAGES if st in kernel_name), None)


def ssd_device_split(by_kernel: dict) -> dict:
    """Device ms per call of each SSD stage (and of anything else the
    wrapper launches, such as the zero fill of the final state)."""
    split = dict.fromkeys((*SSD_STAGES, "other"), 0.0)
    for name, ms in by_kernel.items():
        split[ssd_stage(name) or "other"] += ms
    return split


def check_ssd(torch, np, seed: int) -> dict:
    from repro_torch.kernels.ssd_scan import ops

    h, p, n, q = 24, 64, 128, 256
    # f32: the kernel's logic at S=1000 (three whole chunks and a ragged
    # tail): the reference test's dt, the model's dt, and A = -16, dt ~ 1,
    # where the masked exponent differences reach +4,000 (exp overflows)
    s_f32 = 1000
    for name, kw in (("model's dt", {}), ("reference test's dt", dict(dt_range=(0.01, 0.2))),
                     ("A=-16, dt~1", dict(a=16.0, dt_range=(0.9, 1.1)))):
        args = ssd_inputs(torch, b=1, s=s_f32, h=h, p=p, n=n, dtype=torch.float32, seed=seed,
                          **kw)
        y, fin = ops.ssd(*args, chunk=q)
        ry, rfin = ops.ssd(*args, chunk=q, impl="ref")
        torch.cuda.synchronize()
        err, state_err = (y - ry).abs().max().item(), (fin - rfin).abs().max().item()
        y_max, state_max = ry.abs().max().item(), rfin.abs().max().item()
        case = {"phase": "kernels", "kernel": "ssd_scan", "dtype": "f32", "inputs": name,
                "shape": [1, s_f32, h, p, n, q], "max_abs_err": err,
                "state_max_abs_err": state_err, "y_max_abs": y_max, "state_max_abs": state_max,
                "atol": SSD_F32_ATOL,
                "finite": bool(torch.isfinite(y).all() and torch.isfinite(fin).all())}
        emit(case)
        if not case["finite"] or not max(err, state_err) <= SSD_F32_ATOL:
            raise AssertionError(f"SSD kernel disagrees with its plain version: {case}")
    cases = []
    for name, s_len, iters in SSD_CASES:
        args = ssd_inputs(torch, b=1, s=s_len, h=h, p=p, n=n, dtype=torch.bfloat16, seed=seed)
        y, fin = ops.ssd(*args, chunk=q)
        ry, rfin = ops.ssd(*args, chunk=q, impl="ref")
        torch.cuda.synchronize()
        err = (y.float() - ry.float()).abs().max().item()
        rel = row_rel_err(y, ry)
        state_err = (fin - rfin).abs().max().item()
        state_max = rfin.abs().max().item()
        finite = bool(torch.isfinite(y).all() and torch.isfinite(fin).all())
        del y, fin, ry, rfin
        nbytes, flops = ssd_work(b=1, s=s_len, h=h, p=p, n=n, q=q, elem=2)
        b_ms, b_by = bound_ms(nbytes, flops)
        kern = [lambda: ops.ssd(*args, chunk=q)]
        plain = [lambda: ops.ssd(*args, chunk=q, impl="ref")]
        by_launch = ssd_device_split(device_ms_by_kernel(torch, kern, iters))
        case = {"phase": "kernels", "kernel": "ssd_scan", "case": name, "dtype": "bf16",
                "shape": [1, s_len, h, p, n, q], "max_abs_err": err, "max_row_rel_err": rel,
                "rel_budget": SSD_REL, "state_max_abs_err": state_err,
                "state_max_abs": state_max, "state_atol": SSD_F32_ATOL, "finite": finite,
                "kernel_ms": cuda_ms(torch, kern, iters, warmup=2),
                "kernel_device_ms": sum(by_launch.values()) or None,
                "kernel_device_ms_by_launch": by_launch,
                "plain_ms": cuda_ms(torch, plain, 3, warmup=1),
                "plain_device_ms": device_ms(torch, plain, 3),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
                "library_ms": None, "library_device_ms": None,
                "library_null_reason": "no PyTorch call computes the SSD scan"}
        case["kernel_tflops"] = flops / case["kernel_ms"] / 1e9
        emit(case)
        if not finite or not rel <= SSD_REL or not state_err <= SSD_F32_ATOL:
            raise AssertionError(f"SSD kernel disagrees with its plain version: {case}")
        cases.append(case)
        del args, kern, plain
        torch.cuda.empty_cache()
    main = next(c for c in cases if c["shape"][1] == 8192)
    return {"name": "ssd_scan", "route": "cuda", "source": SSD_SRC, "replaces": SSD_TPU,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["kernel_device_ms"], "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "library_device_ms": None}


# the stream channel's call at the train phase's widths: the reducer folds
# qwen1.5-0.5b's 463,987,712 f32 gradients, packed into 111 wire chunks of
# 16 MiB (465,567,744 values), stacked on its accumulator; then a ragged S,
# and n > 2 in f32 and bf16. (case, n, S, dtype, timing iterations)
ACC_CASES = [("train fold: accumulator + one wave", 2, 465_567_744, "f32", 10),
             ("ragged S", 2, 1_000_003, "f32", 20),
             ("7 rows", 7, 2_500_000, "f32", 20),
             ("16 rows, bf16 input", 16, 4_194_304, "bf16", 20)]


def check_accumulate(torch, np, seed: int) -> dict:
    from repro_torch.kernels.stream_reduce import ops

    cases = []
    for name, n, s, dt, iters in ACC_CASES:
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(seed + n)
        x = torch.randn((n, s), generator=gen, device="cuda").to(dtype)
        out = ops.accumulate(x)
        ref = ops.accumulate(x, impl="ref")
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = x.float().abs().sum(0).max().item()
        exact = bool(torch.equal(out, ref))
        if n == 2 and dt == "f32":
            exact = exact and bool(torch.equal(out, x[0] + x[1]))
        nbytes = n * s * x.element_size() + s * 4
        b_ms, b_by = bound_ms(nbytes, float((n - 1) * s), F32_FLOPS)
        kern, plain = [lambda: ops.accumulate(x)], [lambda: ops.accumulate(x, impl="ref")]
        lib = [lambda: torch.sum(x, 0, dtype=torch.float32)]
        case = {"phase": "kernels", "kernel": "chunk_accumulate", "case": name,
                "shape": [n, s], "dtype": dt, "max_abs_err": err, "bit_identical": exact,
                "col_abs_sum_max": scale, "rel_budget": ACC_REL,
                "finite": bool(torch.isfinite(out).all()),
                "kernel_ms": cuda_ms(torch, kern, iters, warmup=2),
                "kernel_device_ms": device_ms(torch, kern, iters),
                "plain_ms": cuda_ms(torch, plain, iters, warmup=2),
                "plain_device_ms": device_ms(torch, plain, iters),
                "library_ms": cuda_ms(torch, lib, iters, warmup=2),
                "library_device_ms": device_ms(torch, lib, iters),
                "library_call": "torch.sum(x, 0, dtype=torch.float32)",
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        case["kernel_gb_per_s"] = nbytes / case["kernel_ms"] / 1e6
        emit(case)
        ok = exact if n == 2 else err <= ACC_REL * scale
        if not ok or not case["finite"]:
            raise AssertionError(f"chunk_accumulate disagrees with its plain version: {case}")
        cases.append(case)
        del x, out, ref, kern, plain, lib
        torch.cuda.empty_cache()
    main = cases[0]
    return {"name": "chunk_accumulate", "route": "cuda", "source": REDUCE_SRC,
            "replaces": ACC_TPU, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["kernel_device_ms"], "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library_device_ms": main["library_device_ms"]}


def histogram_case(torch, ops, name: str, keys, counts, bins: int, *, exact: bool,
                   iters: int = 10) -> dict:
    """One histogram case: the kernel against its plain version (bit for
    bit where ``exact``: counts of 1, every bin an integer under 2^24;
    else HIST_REL of the largest bin), then CUDA-event and profiler times
    of the kernel, the plain version and `torch.bincount`."""
    from repro_torch.kernels.stream_reduce.stream_reduce import histogram_plan

    out = ops.keyed_histogram(keys, counts, bins)
    ref = ops.keyed_histogram(keys, counts, bins, impl="ref")
    torch.cuda.synchronize()
    top = ref.max().item()
    if exact and top >= 2 ** 24:
        raise AssertionError(f"the hottest bin ({top}) is past f32's exact integers")

    err = (out - ref).abs().max().item()
    ok = bool(torch.equal(out, ref)) if exact else err / top <= HIST_REL
    valid = (keys >= 0) & (keys < bins)
    lib_keys, lib_w = keys[valid].long(), counts[valid].float()
    n = keys.shape[0]
    nbytes = n * (4 + counts.element_size()) + bins * 4
    b_ms, b_by = bound_ms(nbytes, float(n), F32_FLOPS)
    kern = [lambda: ops.keyed_histogram(keys, counts, bins)]
    plain = [lambda: ops.keyed_histogram(keys, counts, bins, impl="ref")]
    lib = [lambda: torch.bincount(lib_keys, lib_w, minlength=bins)]
    plan = histogram_plan(bins)
    case = {"phase": "kernels", "kernel": "histogram", "case": name, "n": n, "bins": bins,
            "counts": str(counts.dtype).replace("torch.", ""),
            "plan": {"path": plan[0], "block_bins": plan[1]},
            "dropped": float((~valid).float().mean()), "hottest_bin": top,
            "max_abs_err": err, "rel_err": err / top, "exact": exact,
            "bit_identical": bool(torch.equal(out, ref)), "rel_budget": HIST_REL,
            "kernel_ms": cuda_ms(torch, kern, iters, warmup=2),
            "kernel_device_ms": device_ms(torch, kern, iters),
            "plain_ms": cuda_ms(torch, plain, iters, warmup=2),
            "plain_device_ms": device_ms(torch, plain, iters),
            "library_ms": cuda_ms(torch, lib, iters, warmup=2),
            "library_device_ms": device_ms(torch, lib, iters),
            "library_call": "torch.bincount(keys[valid], weights.float(), minlength)",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    emit(case)
    if not ok:
        raise AssertionError(f"histogram kernel disagrees with its plain version: {case}")
    return case


def histogram_inputs(torch, np, seed: int, edges=None):
    """The histogram cases, one at a time, as (name, keys, counts, bins,
    exact, timing iterations) on the card: 2^26 keys into qwen's 151,936
    bins, Zipf(1.3) word ids (5 % padding) with counts of 1, the same keys
    through a seeded permutation of the bins (hot keys no longer small
    ids), uniform keys with counts of 1 and with bf16 counts; 4,096 bins;
    then 2^24 uniform keys (some past the last bin) at each of ``edges``
    bins (default: one on each side of the plan's path boundary, what one
    block's shared memory holds). Each case's tensors are freed once the
    next is asked for."""
    from repro_torch.kernels.stream_reduce.stream_reduce import CTA_BINS

    n, bins = 1 << 26, 151_936
    rng = np.random.default_rng(seed + 7)
    zipf = (rng.zipf(1.3, n) % bins).astype(np.int32)
    pad = rng.random(n) < 0.05
    zipf[pad] = -1
    perm = rng.permutation(bins).astype(np.int32)
    permuted = np.where(pad, -1, perm[np.maximum(zipf, 0)]).astype(np.int32)
    del pad
    ones = torch.ones(n, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    uniform = torch.randint(-1, bins, (n,), generator=gen, device="cuda", dtype=torch.int32)
    yield "2^26 zipf keys", torch.from_numpy(zipf).to("cuda"), ones, bins, True, 10
    del zipf
    yield ("2^26 zipf keys, permuted bins", torch.from_numpy(permuted).to("cuda"), ones, bins,
           True, 10)
    del permuted
    yield "2^26 uniform keys", uniform, ones, bins, True, 10
    bf16 = torch.rand(n, generator=gen, device="cuda").to(torch.bfloat16)
    yield "2^26 uniform keys, bf16 counts", uniform, bf16, bins, False, 10
    del ones, uniform, bf16
    torch.cuda.empty_cache()
    small_keys = torch.randint(-1, 4096, (1 << 20,), generator=gen, device="cuda",
                               dtype=torch.int32)
    yield ("4096 bins", small_keys, torch.rand(1 << 20, generator=gen, device="cuda"), 4096,
           False, 50)
    m = 1 << 24
    for e in (CTA_BINS, CTA_BINS + 1) if edges is None else edges:
        keys = torch.randint(-1, e + e // 64, (m,), generator=gen, device="cuda",
                             dtype=torch.int32)
        yield (f"2^24 uniform keys, {e} bins", keys,
               torch.rand(m, generator=gen, device="cuda"), e, False, 20)


def check_histogram(torch, np, seed: int) -> dict:
    """Every case of `histogram_inputs` through `histogram_case`."""
    from repro_torch.kernels.stream_reduce import ops
    from repro_torch.kernels.stream_reduce.stream_reduce import CTA_BINS, histogram_plan

    if histogram_plan(CTA_BINS)[0] == histogram_plan(CTA_BINS + 1)[0]:
        raise AssertionError(f"the plan's path boundary moved from {CTA_BINS} bins")
    cases = [histogram_case(torch, ops, name, keys, counts, bins, exact=exact, iters=iters)
             for name, keys, counts, bins, exact, iters in histogram_inputs(torch, np, seed)]
    main = cases[0]
    return {"name": "histogram", "route": "cuda", "source": REDUCE_SRC, "replaces": HIST_TPU,
            "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "device_ms": main["kernel_device_ms"],
            "plain_device_ms": main["plain_device_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library_device_ms": main["library_device_ms"]}


# -- phase 4: full-width serve -------------------------------------------------


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by the summary line's names."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_decode_attention_kernel
    from repro_torch.kernels.sample import argmax_last_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    from repro_torch.kernels.stream_reduce import chunk_accumulate_kernel, histogram_kernel

    return {"paged_decode_attention": paged_decode_attention_kernel,
            "argmax_last": argmax_last_kernel, "flash_attention": flash_attention_kernel,
            "ssd_scan": ssd_scan_kernel, "chunk_accumulate": chunk_accumulate_kernel,
            "histogram": histogram_kernel}


def short_requests(np, cfg, *, n_req: int, seed: int) -> list:
    """The tinyllama arm's traffic: prompts of 64..1024 tokens, half behind
    a shared 256-token prefix, 64 new tokens each."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, 256)
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(64, 1025))
        if i % 2 == 0:  # half share a 256-token prefix
            n = max(n, 256 + 16)
            prompt = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n - 256)])
        else:
            prompt = rng.integers(0, cfg.vocab_size, n)
        reqs.append(Request(uid=i, prompt=prompt.astype(np.int32), max_new_tokens=64))
    return reqs


def long_requests(np, cfg, *, seed: int) -> list:
    """The long-prompt arm's traffic, in submission order: question 1 over
    a 12,000-token document (+300-token tail), an unrelated 15,000-token
    prompt, question 2 over the same document (+700), an unrelated
    9,500-token prompt; 16 new tokens each. Every prompt is past 8192
    tokens and buckets to 16,384."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    doc = rng.integers(0, cfg.vocab_size, 12_000)
    prompts = [np.concatenate([doc, rng.integers(0, cfg.vocab_size, 300)]),
               rng.integers(0, cfg.vocab_size, 15_000),
               np.concatenate([doc, rng.integers(0, cfg.vocab_size, 700)]),
               rng.integers(0, cfg.vocab_size, 9_500)]
    return [Request(uid=i, prompt=p.astype(np.int32), max_new_tokens=16)
            for i, p in enumerate(prompts)]


def serve_arm(torch, np, model, params, *, kv, reqs: list, arm: str, max_batch: int = 8,
              max_len: int = 2048) -> dict:
    """Drain ``reqs`` through `make_engine` (continuous batching over
    ``kv``) with every kernel count set to 0 just before and read just
    after. Times each prefill call and each tick on the host clock, ended
    by `torch.cuda.synchronize()`, and each request's first token. Holds
    the first decode tick's logits against the plain path (inside the
    run; its time is taken out of the run's times) and, after the run,
    the first prefill call's last-position logits against the plain
    route."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel as fk
    from repro_torch.kernels.paged_attention import paged_decode_attention_kernel as pk
    from repro_torch.serve import EngineConfig, make_engine

    cfg = model.cfg
    first, first_prefill, prefill_ms, prefill_rows = {}, {}, [], []
    check_s = 0.0  # host time of the check inside the run, left out of its times

    def decode_and_check(params_, pview, token, *, impl=None):
        nonlocal check_s
        out = model.decode_step_paged(params_, pview, token, impl=impl)
        if not first:  # hold the first decode tick against the plain path
            torch.cuda.synchronize()
            ts = time.perf_counter()
            launches = pk.launches
            ref = model.decode_step_paged(params_, pview, token, impl="ref")
            if pk.launches != launches:
                raise AssertionError("the plain decode path launched the paged kernel")
            live = pview["pos"] < pview["tables"].shape[1] * kv.block_size
            got, want = out[0][live].float(), ref[0][live].float()
            first.update(
                logit_max_abs_err=(got - want).abs().max().item(),
                logit_ref_max_abs=want.abs().max().item(),
                rows_k_max_abs_err=(out[1].float() - ref[1].float()).abs().max().item(),
                greedy_agree=int((got.argmax(-1) == want.argmax(-1)).sum().item()),
                live_rows=int(live.sum().item()),
            )
            torch.cuda.synchronize()
            check_s += time.perf_counter() - ts
        return out

    def timed_prefill(params_, tokens, cache=None, length=None, *, impl=None):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = model.prefill(params_, tokens, cache, length, impl=impl)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - ts) * 1e3)
        prefill_rows.append(list(tokens.shape))
        if not first_prefill:  # kept for the check after the run
            first_prefill.update(tokens=tokens, length=length, logits=out[0][:, -1].clone())
        return out

    engine = make_engine(dataclasses.replace(model, decode_step_paged=decode_and_check,
                                             prefill=timed_prefill),
                         params, EngineConfig(mode="continuous", max_batch=max_batch,
                                              max_len=max_len, kv=kv))

    # time every tick: drain() steps until idle, through this wrapper
    decode_ticks, decode_only_ms, ttft_s = 0, [], {}
    step = engine.step

    def timed_step():
        nonlocal decode_ticks
        ts = time.perf_counter()
        step()
        torch.cuda.synchronize()
        now = time.perf_counter() - check_s
        lt = engine.last_tick
        if lt["decode_batch"]:
            decode_ticks += 1
            if not lt["prefill_lens"] and not lt["prefix_hit_tokens"]:
                decode_only_ms.append((now + check_s - ts) * 1e3)
        for r in reqs:
            if r.out_tokens and r.uid not in ttft_s:
                ttft_s[r.uid] = now - t0

    engine.step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.drain()
    wall = time.perf_counter() - t0 - check_s
    launches = {name: k.launches for name, k in counters.items()}
    paged_n, argmax_n, flash_n = (launches[k] for k in (
        "paged_decode_attention", "argmax_last", "flash_attention"))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the first prefill call against the plain route, outside the timed run
    budget = PREFILL_BUDGET[cfg.name]
    torch.cuda.synchronize()
    ts = time.perf_counter()
    ref, _ = model.prefill(params, first_prefill["tokens"], None, first_prefill["length"],
                           impl="ref")
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - ts) * 1e3
    if fk.launches != flash_n:
        raise AssertionError("the plain prefill route launched the flash kernel")
    got, want = first_prefill["logits"].float(), ref[:, -1].float()
    best = want.max(-1).values
    picked = want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
    prefill_check = {
        "prefill_logit_max_abs_err": (got - want).abs().max().item(),
        "prefill_logit_ref_max_abs": want.abs().max().item(),
        "prefill_logit_budget": budget,
        "first_prefill_plain_route_ms": ref_ms,
        "prefill_greedy_agree": int((got.argmax(-1) == want.argmax(-1)).sum().item()),
        "prefill_greedy_rows": int(got.shape[0]),
        "prefill_greedy_worst_gap": (best - picked).max().item(),
        "prefill_ref_top2_margin_min": (lambda t: (t[:, 0] - t[:, 1]).min().item())(
            want.topk(2, dim=-1).values),
    }
    del ref, first_prefill["tokens"]

    done = {r.uid: len(r.out_tokens) for r in engine.finished}
    prompt_tokens = int(sum(r.prompt.shape[0] for r in reqs))
    out = {"phase": "serve", "arm": arm, "model": cfg.name, "kv_dtype": kv.kv_dtype,
           "requests": len(reqs), "prompt_tokens": prompt_tokens,
           "tokens_out": engine.stats["tokens_out"], "ticks": engine.tick,
           "decode_ticks": decode_ticks, "cold_admissions": engine.stats["prefills"],
           "prefill_skips": engine.stats["prefill_skips"],
           "prefix_hit_tokens": engine.stats["prefix_hit_tokens"],
           "prefill_calls": len(prefill_ms), "prefill_shapes": prefill_rows,
           "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": prompt_tokens / (sum(prefill_ms) / 1e3),
           "ttft_s": [ttft_s.get(r.uid) for r in reqs],
           "flash_launches": flash_n, "paged_launches": paged_n, "argmax_launches": argmax_n,
           "launches": launches, "wall_s": wall, "decode_check_s": check_s,
           "tokens_per_s": engine.stats["tokens_out"] / wall,
           "median_decode_tick_ms": float(np.median(decode_only_ms)) if decode_only_ms
           else None, "decode_only_ticks": len(decode_only_ms),
           "peak_mem_gib": peak_gib, "logit_budget": LOGIT_BUDGET[cfg.name], **first,
           **prefill_check,
           "peak_blocks": engine.kv.stats["peak_blocks"]}
    emit(out)
    if len(done) != len(reqs) or any(done[r.uid] != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{arm}: not every request finished with its tokens: {done}")
    if flash_n != cfg.n_layers * len(prefill_ms) or not prefill_ms:
        raise AssertionError(f"{arm}: flash kernel ran {flash_n} times, want "
                             f"{cfg.n_layers} x {len(prefill_ms)} prefill calls")
    if paged_n != cfg.n_layers * decode_ticks:
        raise AssertionError(f"{arm}: paged kernel ran {paged_n} times, want "
                             f"{cfg.n_layers} x {decode_ticks} decode ticks")
    if argmax_n < decode_ticks + engine.stats["prefills"]:
        raise AssertionError(f"{arm}: argmax kernel ran {argmax_n} times, want >= "
                             f"{decode_ticks} ticks + {engine.stats['prefills']} admissions")
    if not first.get("logit_max_abs_err", math.inf) <= LOGIT_BUDGET[cfg.name]:
        raise AssertionError(f"{arm}: first decode tick off the plain path: {first}")
    if not prefill_check["prefill_logit_max_abs_err"] <= budget:
        raise AssertionError(f"{arm}: first prefill call off the plain route: {prefill_check}")
    if engine.last_logits is None or not bool(torch.isfinite(engine.last_logits).all()) \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{arm}: non-finite logits")
    return out


def profile_decode(torch, np, model, params, *, seed: int, ticks: int = 16,
                   mode: str = "continuous", prompt_lens=(512,) * 8,
                   max_len: int = 2048) -> dict:
    """Where a decode tick's time goes, on a fresh engine (one slot per
    prompt length, 8 slots of 512-token prompts unless given; continuous
    mode over the paged store, or aligned mode over the dense store) after
    its admission tick: ``ticks`` decode-only
    ticks timed on the host clock, then ``ticks`` more under
    `torch.profiler`. Reports the wall time per tick without and with the
    profiler, the device time per tick, the device's idle share of the
    unprofiled tick, device time by kernel class and the top kernels. Not
    part of the counted run; a profiler that sees no device activity
    leaves the device numbers as None ("not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import EngineConfig, KVSpec, Request, make_engine

    kv = KVSpec(kind="paged", block_size=16) if mode == "continuous" else KVSpec()
    engine = make_engine(model, params, EngineConfig(mode=mode, max_batch=len(prompt_lens),
                                                     max_len=max_len, kv=kv))
    rng = np.random.default_rng(seed)
    for i, n in enumerate(prompt_lens):
        prompt = rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=2 * ticks + 2))
    engine.step()  # the packed prefill and the first decode tick stay outside

    def run_ticks() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / ticks

    wall_ms = run_ticks()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = run_ticks()
    classes = {"paged_decode_attention": 0.0, "argmax_last": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = device_us(ev) / 1e3 / ticks
        name = ev.key
        if "paged_split_kernel" in name or "paged_combine_kernel" in name:
            cls = "paged_decode_attention"
        elif "argmax_last" in name:
            cls = "argmax_last"
        elif any(w in name.lower() for w in ("gemm", "gemv", "nvjet", "sm90")):
            cls = "gemm"  # cuBLAS names its Hopper kernels nvjet_*
        else:
            cls = "other"
        classes[cls] += ms
        kernels.append((ms, ev.count // ticks, name[:90]))
    dev_ms = sum(classes.values()) if kernels else None
    kernels.sort(reverse=True)
    out = {"phase": "profile", "model": model.cfg.name, "mode": mode, "ticks": ticks,
           "batch": len(prompt_lens), "context_tokens": list(prompt_lens),
           "wall_ms_per_tick": wall_ms, "profiled_wall_ms_per_tick": profiled_wall_ms,
           "device_ms_per_tick": dev_ms,
           "idle_share": None if dev_ms is None else 1.0 - dev_ms / wall_ms,
           "device_launches_per_tick": sum(n for _, n, _ in kernels),
           "device_ms_per_tick_by_class": classes if kernels else None,
           "top_kernels": [{"ms_per_tick": ms, "launches_per_tick": n, "name": name}
                           for ms, n, name in kernels[:10]]}
    emit(out)
    return out


# -- phase 7: mamba2-130m in aligned mode ------------------------------------


def mamba_requests(np, cfg, *, n_req: int, seed: int) -> list:
    """The mamba arm's traffic: prompts of 1,000-16,000 tokens (uniform,
    from the seed), 64 new tokens each."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(1000, 16001))).astype(np.int32),
                    max_new_tokens=64) for i in range(n_req)]


def mamba_arm(torch, np, model, params, *, reqs: list, max_batch: int = 8,
              max_len: int = 16384) -> dict:
    """Drain ``reqs`` through `make_engine` in aligned mode over the dense
    store, with every kernel count set to 0 just before and read just
    after. Times each prefill call and each tick on the host clock, ended
    by `torch.cuda.synchronize()`, and each request's first token. After
    the run, holds the first prefill call's last-position logits, and the
    first decode tick's logits of slot 0 (whose cache that prefill made),
    against the plain route: request 0 prefilled with ``impl="ref"``,
    then one decode step on that cache with the run's token."""
    from repro_torch.serve import EngineConfig, make_engine

    cfg = model.cfg
    first_prefill, first_decode, prefill_ms, prefill_rows = {}, {}, [], []

    def timed_prefill(params_, tokens, cache=None, length=None, *, impl=None):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = model.prefill(params_, tokens, cache, length, impl=impl)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - ts) * 1e3)
        prefill_rows.append(list(tokens.shape))
        if not first_prefill:  # kept for the check after the run
            first_prefill.update(tokens=tokens, logits=out[0][:, -1].clone())
        return out

    def decode(params_, cache, token):
        out = model.decode_step(params_, cache, token)
        if not first_decode:
            first_decode.update(token=token[:1].clone(), logits=out[0][:1, -1].clone())
        return out

    engine = make_engine(dataclasses.replace(model, prefill=timed_prefill, decode_step=decode),
                         params, EngineConfig(mode="aligned", max_batch=max_batch,
                                              max_len=max_len))
    decode_ticks, decode_only_ms, ttft_s = 0, [], {}
    step = engine.step

    def timed_step():
        nonlocal decode_ticks
        ts = time.perf_counter()
        step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        lt = engine.last_tick
        if lt["decode_batch"]:
            decode_ticks += 1
            if not lt["prefill_lens"]:
                decode_only_ms.append((now - ts) * 1e3)
        for r in reqs:
            if r.out_tokens and r.uid not in ttft_s:
                ttft_s[r.uid] = now - t0

    engine.step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2**30  # weights and the slot cache
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.drain()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the plain route for request 0: prefill, then slot 0's first decode step
    torch.cuda.synchronize()
    ts = time.perf_counter()
    ref_logits, ref_cache = model.prefill(params, first_prefill["tokens"], impl="ref")
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - ts) * 1e3
    ref_dec, _ = model.decode_step(params, ref_cache, first_decode["token"])
    torch.cuda.synchronize()
    if counters["ssd_scan"].launches != launches["ssd_scan"]:
        raise AssertionError("the plain prefill route launched the SSD kernel")
    got_p, want_p = first_prefill["logits"].float(), ref_logits[:, -1].float()
    got_d, want_d = first_decode["logits"].float(), ref_dec[:, -1].float()
    check = {
        "prefill_logit_max_abs_err": (got_p - want_p).abs().max().item(),
        "prefill_logit_ref_max_abs": want_p.abs().max().item(),
        "decode_logit_max_abs_err": (got_d - want_d).abs().max().item(),
        "decode_logit_ref_max_abs": want_d.abs().max().item(),
        "logit_budget": MAMBA_LOGIT_BUDGET,
        "first_prefill_plain_route_ms": ref_ms,
        "greedy_agree": [bool(got_p.argmax(-1).eq(want_p.argmax(-1)).all()),
                         bool(got_d.argmax(-1).eq(want_d.argmax(-1)).all())],
    }
    del ref_cache, first_prefill["tokens"]

    done = {r.uid: len(r.out_tokens) for r in engine.finished}
    prompt_tokens = int(sum(r.prompt.shape[0] for r in reqs))
    out = {"phase": "serve", "arm": "mamba", "model": cfg.name, "mode": "aligned",
           "requests": len(reqs), "prompt_tokens": prompt_tokens,
           "prompt_lens": [int(r.prompt.shape[0]) for r in reqs],
           "prompts_multiple_of_chunk": sum(int(r.prompt.shape[0]) % cfg.ssm_chunk == 0
                                            for r in reqs),
           "tokens_out": engine.stats["tokens_out"], "ticks": engine.tick,
           "decode_ticks": decode_ticks, "admissions": engine.stats["prefills"],
           "prefill_calls": len(prefill_ms), "prefill_shapes": prefill_rows,
           "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": prompt_tokens / (sum(prefill_ms) / 1e3),
           "ttft_s": [ttft_s.get(r.uid) for r in reqs],
           "ssd_launches": launches["ssd_scan"], "argmax_launches": launches["argmax_last"],
           "launches": launches, "wall_s": wall,
           "tokens_per_s": engine.stats["tokens_out"] / wall,
           "median_decode_tick_ms": float(np.median(decode_only_ms)) if decode_only_ms
           else None, "decode_only_ticks": len(decode_only_ms),
           "peak_mem_gib": peak_gib, "mem_at_start_gib": start_gib, **check}
    emit(out)
    if len(done) != len(reqs) or any(done[r.uid] != r.max_new_tokens for r in reqs):
        raise AssertionError(f"mamba: not every request finished with its tokens: {done}")
    if launches["ssd_scan"] != cfg.n_layers * len(prefill_ms) or not prefill_ms:
        raise AssertionError(f"mamba: SSD kernel ran {launches['ssd_scan']} times, want "
                             f"{cfg.n_layers} x {len(prefill_ms)} prefill calls")
    if launches["argmax_last"] < decode_ticks + engine.stats["prefills"]:
        raise AssertionError(f"mamba: argmax kernel ran {launches['argmax_last']} times, want "
                             f">= {decode_ticks} ticks + {engine.stats['prefills']} admissions")
    if launches["paged_decode_attention"] or launches["flash_attention"]:
        raise AssertionError(f"mamba: an attention kernel ran in an SSM model: {launches}")
    if not max(check["prefill_logit_max_abs_err"],
               check["decode_logit_max_abs_err"]) <= MAMBA_LOGIT_BUDGET:
        raise AssertionError(f"mamba: logits off the plain route: {check}")
    if engine.last_logits is None or not bool(torch.isfinite(engine.last_logits).all()):
        raise AssertionError("mamba: non-finite logits")
    return out


def profile_prefill(torch, np, model, params, *, seed: int, s: int = 8192) -> dict:
    """One mamba2-130m prefill call of ``s`` tokens: its wall time (after a
    warm-up call), then the same call under `torch.profiler`: device time
    by kernel class, the SSD kernel's share of the call, and the top
    kernels. Not part of the counted run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (1, s)), device="cuda")

    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, tokens)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    call()
    wall_ms = call()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = call()
    classes = {"ssd_scan": 0.0, "gemm": 0.0, "other": 0.0}
    ssd_by_launch = dict.fromkeys(SSD_STAGES, 0.0)
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = device_us(ev) / 1e3
        name = ev.key
        if stage := ssd_stage(name):
            cls = "ssd_scan"
            ssd_by_launch[stage] += ms
        elif any(w in name.lower() for w in ("gemm", "gemv", "nvjet", "sm90")):
            cls = "gemm"
        else:
            cls = "other"
        classes[cls] += ms
        kernels.append((ms, ev.count, name[:90]))
    dev_ms = sum(classes.values()) if kernels else None
    kernels.sort(reverse=True)
    out = {"phase": "profile_prefill", "model": model.cfg.name, "tokens": s,
           "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms, "device_ms": dev_ms,
           "idle_share": None if dev_ms is None else 1.0 - dev_ms / wall_ms,
           "device_ms_by_class": classes if kernels else None,
           "ssd_share_of_device": None if not dev_ms else classes["ssd_scan"] / dev_ms,
           "ssd_share_of_wall": None if not dev_ms else classes["ssd_scan"] / wall_ms,
           "ssd_ms_by_launch": ssd_by_launch,
           "device_launches": sum(n for _, n, _ in kernels),
           "top_kernels": [{"ms": ms, "launches": n, "name": name}
                           for ms, n, name in kernels[:10]]}
    emit(out)
    return out


# -- phase 8: training, in every step mode, with checkpoints ------------------------

TRAIN_ROWS = 4
TRAIN_STEPS = 3
TRAIN_CHUNK_BYTES = 16 << 20
TRAIN_SEQ = 2048
DECOUPLED_BATCH = 6  # two sequences for each of the three compute rows
DATA_PARALLEL_BATCH = 8  # two sequences for each of the four rows
TRAIN_CKPT_EVERY = 2  # the decoupled run saves at steps 2 and 3 (the last)
RESUME_STEP = 2
# the step the modes are compared at: step 1 carries each run's first-call
# costs, and the decoupled run's step 3 shares the host with the write of
# its step-2 save (the other runs save only after their last step)
COMPARE_STEP = 2


class PaddedPipeline:
    """The decoupled run's batches as conventional and overlap rows take
    them: the global batch padded with zero-masked sequences to the
    decoupled layout (8 sequences, 2 per row, the last row's masked), so
    that every row count divides it and the same tokens are counted."""

    def __init__(self, pipe, compute_rows: int, rows: int):
        self.pipe, self.compute_rows, self.rows = pipe, compute_rows, rows

    def global_batch(self, step: int) -> dict:
        return self.pipe.padded_for_groups(step, self.compute_rows, self.rows)


def _host_peak_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def train_rank(mesh, seed: int, ckpt_root: str) -> dict:
    """One rank of the train phase's four-row world (run by `spawn`), at
    qwen1.5-0.5b's full width: 3 AdamW steps through `Trainer` in
    decoupled mode, saving at steps 2 and 3; a fresh overlap `Trainer`
    resuming from step 2 (step 3's commit marker removed, as a crash
    before it would leave it) and taking step 3; 3 steps each of the
    conventional and the overlap step on 8 sequences; each run with this
    rank's kernel counts set to 0 just before and read just after, and row
    0 reading the files of its last step back against the live state, so
    every checkpoint written is read. Then one SGD step of each mode
    against the conventional step in one process, in f32 and bf16."""
    import shutil

    import torch

    from repro_torch.configs import get
    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.io import checkpoint as ckpt
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (
        TrainStepConfig,
        build_conventional_step,
        make_step,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.treeutil import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mem = []  # (where, GiB allocated, GiB reserved) on this rank

    def snap(where: str) -> None:
        mem.append((where, torch.cuda.memory_allocated() / 2 ** 30,
                    torch.cuda.memory_reserved() / 2 ** 30))

    cfg = get("qwen1.5-0.5b")
    model = build(cfg)
    adamw = OptConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    decoupled_cfg = TrainStepConfig(mode="decoupled", reduce_alpha=0.25,
                                    wire_chunk_bytes=TRAIN_CHUNK_BYTES)
    pipe6 = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=DECOUPLED_BATCH, seed=seed, kind="zipf", skew=0.4))
    pipe8 = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=DATA_PARALLEL_BATCH, seed=seed, kind="zipf",
                                skew=0.4))
    counters = kernel_counters()
    out = {"row": mesh.row, "runs": {}, "mem": mem}

    def read_back(trainer, state) -> dict:
        """The files of the state's step against the state, on row 0."""
        def leaves(s):
            return tree_leaves(s["params"]) + tree_leaves(s["opt"]["m"]) \
                + tree_leaves(s["opt"]["v"])

        t0 = time.perf_counter()
        back = trainer.restore(state["step"], state)
        read_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(back)))
        return {"step": state["step"], "device_restore_s": read_s, "leaves": len(leaves(state)),
                "bit_identical": same and back["step"] == state["step"]
                and back["opt"]["step"] == state["opt"]["step"]}

    def drive(name: str, trainer, state, resume: bool) -> dict:
        """``trainer.run`` with the kernel counts at 0 just before, read
        just after, then its last files read back on row 0; this rank's
        record of the run."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.run(state, resume=resume)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"wall_s": wall, "launches": {k: fn.launches for k, fn in counters.items()},
               "log": trainer.metrics_log, "timings": trainer.step_fn.timings,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "host_peak_gib": _host_peak_gib(), "ckpt": trainer.checkpointer.log,
               "resumed": trainer.resumed,
               "moment_bytes": trainer.moment_bytes, "restore_check": None,
               "finite": all(bool(torch.isfinite(p).all())
                             for p in tree_leaves(state["params"]))}
        trainer.close()
        if mesh.row == 0:
            run["restore_check"] = read_back(trainer, state)
        snap(f"{name} done")
        out["runs"][name] = run
        return run

    # the decoupled run, checkpointing
    dec_dir = os.path.join(ckpt_root, "decoupled")
    trainer = Trainer(model, mesh, pipe6, adamw, decoupled_cfg,
                      TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                    ckpt_every=TRAIN_CKPT_EVERY, keep=2, ckpt_dir=dec_dir))
    state = trainer.init_state(seed)
    snap("adamw state")
    out["params"] = sum(p.numel() for p in tree_leaves(state["params"]))
    drive("decoupled", trainer, state, resume=False)
    if mesh.row == 0:  # step 3's save never committed, as if the run had crashed in it
        os.remove(os.path.join(dec_dir, f"step_{TRAIN_STEPS:08d}", ckpt.COMMIT))
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()

    # a fresh trainer in overlap mode resumes the decoupled run's files
    trainer = Trainer(model, mesh, PaddedPipeline(pipe6, TRAIN_ROWS - 1, TRAIN_ROWS), adamw,
                      TrainStepConfig(mode="overlap"),
                      TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                    ckpt_every=TRAIN_CKPT_EVERY, keep=2, ckpt_dir=dec_dir))
    drive("overlap_resume", trainer, state, resume=True)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # the conventional and overlap steps on 8 sequences
    for mode in ("conventional", "overlap"):
        d = os.path.join(ckpt_root, mode)
        trainer = Trainer(model, mesh, pipe8, adamw, TrainStepConfig(mode=mode),
                          TrainerConfig(total_steps=TRAIN_STEPS, log_every=1, keep=1,
                                        ckpt_dir=d))
        state = trainer.init_state(seed)
        drive(mode, trainer, state, resume=False)
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        if mesh.row == 0:
            shutil.rmtree(d, ignore_errors=True)
        mesh.barrier()

    # parity: one SGD step (lr 1: new params = params - gradient) of each
    # mode in the world against the conventional step in one process on the
    # same global batch (the decoupled layout: 6 real sequences of 8)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pmodel = build(dataclasses.replace(cfg, dtype=dtype))
        params = pmodel.init(seed, param_dtype=torch.float32)
        batch = row_shard(pipe6.padded_for_groups(0, TRAIN_ROWS - 1, TRAIN_ROWS), mesh.row,
                          TRAIN_ROWS, pmodel.device)
        news, losses = {}, {}
        for mode, ts in (("decoupled", decoupled_cfg), ("conventional", TrainStepConfig()),
                         ("overlap", TrainStepConfig(mode="overlap"))):
            opt = init_opt_state(sgd, params)
            if mode == "overlap":
                opt = sharding.shard_opt_state(
                    sharding.zero1_plan(params, mesh.n_rows, mesh.row), opt)
            new, _, metrics = make_step(pmodel, mesh, sgd, ts)(params, opt, batch)
            losses[mode] = metrics["loss"]
            if mesh.row == 0:  # only row 0 compares: the others leave the card to it
                news[mode] = new
            del new, opt
            gc.collect()
            torch.cuda.empty_cache()
        snap(f"parity {name} stepped")
        del batch
        if mesh.row != 0:
            params = None
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
        if mesh.row == 0:
            conv, _, cmetrics = build_conventional_step(pmodel, sgd)(
                params, init_opt_state(sgd, params),
                {k: v.to(pmodel.device) for k, v in pipe6.global_batch(0).items()})
            gmax = max((a - b).abs().max().item()
                       for a, b in zip(tree_leaves(params), tree_leaves(conv)))
            for mode, new in news.items():
                diff = max((a - b).abs().max().item()
                           for a, b in zip(tree_leaves(new), tree_leaves(conv)))
                # the world's modes against each other: each sums the same
                # rows' gradients, the order of the sum is gloo's or the
                # reducer's
                vs_dec = max((a - b).abs().max().item()
                             for a, b in zip(tree_leaves(new), tree_leaves(news["decoupled"])))
                out[f"parity_{name}_{mode}"] = {
                    "max_abs_diff": diff, "max_abs_grad": gmax, "rel": diff / gmax,
                    "max_abs_diff_vs_decoupled": vs_dec, "loss": losses[mode],
                    "conventional_loss": float(cmetrics["loss"])}
            del conv
        del params, news, pmodel
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
    out["peak_gib_parity"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["host_peak_gib"] = _host_peak_gib()
    return out


PHASES_BY_MODE = {
    "decoupled": ("fwd_bwd_s", "stream_s", "analytics_s", "broadcast_s", "update_s"),
    "conventional": ("fwd_bwd_s", "all_reduce_s", "update_s"),
    "overlap": ("fwd_bwd_s", "reduce_scatter_s", "update_s", "all_gather_s"),
}
WIRE_KEYS = ("wire_wait_s", "wire_fold_s", "wire_d2h_s", "wire_h2d_s", "wire_collective_s",
             "wire_sent_bytes", "wire_recv_bytes", "wire_collective_bytes", "wire_d2h_bytes",
             "wire_h2d_bytes")
# the resumed step 3 in overlap mode against the decoupled run's step 3:
# the loss is taken before the update, from step 2's parameters restored
# bit for bit, on the same sequences, each row's shard the same as a
# decoupled compute row's (the fourth row's masked); the rows' loss sums
# add in another order (four ranks against three), a few f32 ulps of the
# sum.
RESUME_LOSS_REL = 1e-5
# overlap's per-step losses against conventional's (the same parameters,
# batches, AdamW and clip): the parameters agree to f32 rounding after a
# step (the SGD parity holds the two modes' gradients within an ulp), but
# qwen1.5-0.5b computes in bf16, so a parameter that the rounding moves
# across a bf16 boundary changes the forward pass at bf16 resolution
# (2^-8), which a step's mean over 16,384 tokens averages down to about
# 2^-8 / sqrt(16,384) = 3e-5 of the loss (on an H100: 1.3e-5 and 1.6e-5
# at steps 2 and 3). A step moves the loss by 0.3 to 2.7 here, so an
# update wrong on one row's part shows far above this budget.
OVERLAP_LOSS_REL = 1e-4


def train_run_line(name: str, mode: str, ranks: list, smi: str, **extra) -> dict:
    """One JSON line of a train run: per step the slowest rank's summed
    phases, per rank the phases, wire and staging bytes and seconds, peak
    device and host memory, checkpoint saves."""
    runs = [r["runs"][name] for r in ranks]
    n_steps = len(runs[0]["timings"])
    phase_keys = PHASES_BY_MODE[mode]
    saved = {c["step"] for c in runs[0]["ckpt"]}
    steps = [{"step": runs[0]["log"][i]["step"], "loss": runs[0]["log"][i]["loss"],
              "wall_s": max(sum(run["timings"][i][k] for k in phase_keys) for run in runs),
              "after_save": runs[0]["log"][i]["step"] - 1 in saved}
             for i in range(n_steps)]
    launches = {k: sum(run["launches"][k] for run in runs) for k in runs[0]["launches"]}
    per_rank = [{"row": r["row"], "wall_s": run["wall_s"], "peak_gib": run["peak_gib"],
                 "host_peak_gib": run["host_peak_gib"], "moment_bytes": run["moment_bytes"],
                 "per_step": [{k: t[k] for k in phase_keys + WIRE_KEYS} for t in run["timings"]]}
                for r, run in zip(ranks, runs)]
    line = {"phase": "train", "run": name, "mode": mode, "model": "qwen1.5-0.5b",
            "params": ranks[0]["params"], "rows": TRAIN_ROWS, "seq_len": TRAIN_SEQ,
            "steps": steps, "launches": launches, "per_rank": per_rank,
            "ckpt": runs[0]["ckpt"], "resumed": runs[0]["resumed"],
            "restore_check": runs[0]["restore_check"],
            "wire": "gloo over host loopback (device -> pinned host -> gloo -> host -> device)",
            "nvidia_smi": smi, **extra}
    emit(line)
    losses = [x["loss"] for x in runs[0]["log"]]
    if not all(math.isfinite(x) for x in losses) or not all(run["finite"] for run in runs):
        raise AssertionError(f"train {name}: non-finite losses or parameters: {losses}")
    if any([x["loss"] for x in run["log"]] != losses for run in runs):
        raise AssertionError(f"train {name}: the rows disagree on the loss")
    if not line["restore_check"]["bit_identical"]:
        raise AssertionError(f"train {name}: the checkpoint read back differs: "
                             f"{line['restore_check']}")
    if mode != "decoupled" and launches["chunk_accumulate"] != 0:
        raise AssertionError(f"train {name}: chunk_accumulate launched "
                             f"{launches['chunk_accumulate']} times in {mode} mode")
    return line


def train_phase(torch, np, seed: int, smi: str) -> dict:
    """The four-row world on the card (every kernel already built by the
    parent), its train lines, and the checks. Checkpoints go to a fresh
    temporary directory, removed at the end."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn

    # the ranks' allocators map memory in growable segments, so the large,
    # differently sized buffers of the fold and the parity step reuse it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    parent_gib = torch.cuda.memory_reserved() / 2 ** 30
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gib = shutil.disk_usage(ckpt_root).free / 2 ** 30
        t0 = time.perf_counter()
        ranks = spawn(train_rank, TRAIN_ROWS, device="cuda", args=(seed, ckpt_root),
                      timeout_s=1000)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    waves, f32_groups = TRAIN_ROWS - 1, 1
    expected = waves * f32_groups * TRAIN_STEPS
    parity = {k: ranks[0][k] for k in ranks[0] if k.startswith("parity_")}
    dec = train_run_line("decoupled", "decoupled", ranks, smi, compute_rows=TRAIN_ROWS - 1,
                         reduce_rows=1, global_batch=DECOUPLED_BATCH,
                         wire_chunk_bytes=TRAIN_CHUNK_BYTES, waves=waves,
                         chunk_accumulate_expected=expected, ckpt_dir_free_gib=free_gib)
    resume = train_run_line("overlap_resume", "overlap", ranks, smi,
                            global_batch=DECOUPLED_BATCH, resume_loss_budget=RESUME_LOSS_REL)
    conv = train_run_line("conventional", "conventional", ranks, smi,
                          global_batch=DATA_PARALLEL_BATCH)
    over = train_run_line("overlap", "overlap", ranks, smi, global_batch=DATA_PARALLEL_BATCH)
    launches = {name: line["launches"] for name, line in
                (("decoupled", dec), ("overlap_resume", resume), ("conventional", conv),
                 ("overlap", over))}
    by_mode = {"decoupled": dec, "conventional": conv, "overlap": over}
    overlap_loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                        for a, b in zip(over["steps"], conv["steps"])]
    summary = {"phase": "train_summary", "world_s": world_s, "parent_reserved_gib": parent_gib,
               "launches_by_run": launches,
               "compare_step": COMPARE_STEP,
               "compare_step_wall_s": {m: line["steps"][COMPARE_STEP - 1]["wall_s"]
                                       for m, line in by_mode.items()},
               "overlap_vs_conventional_loss_rel": overlap_loss_rel,
               "overlap_loss_budget": OVERLAP_LOSS_REL,
               "parity_f32_budget": TRAIN_PARITY_REL, **parity,
               "peak_gib_parity": [r["peak_gib_parity"] for r in ranks],
               "host_peak_gib": [r["host_peak_gib"] for r in ranks], "nvidia_smi": smi}
    emit(summary)
    reducer = ranks[-1]["runs"]["decoupled"]
    if launches["decoupled"]["chunk_accumulate"] != expected:
        raise AssertionError(f"train: chunk_accumulate launched "
                             f"{launches['decoupled']['chunk_accumulate']} times, want {expected}")
    if reducer["launches"]["chunk_accumulate"] != expected:
        raise AssertionError("train: a compute row folded a wave")
    if len(dec["steps"]) != TRAIN_STEPS or len(conv["steps"]) != TRAIN_STEPS \
            or len(over["steps"]) != TRAIN_STEPS:
        raise AssertionError("train: a run did not take its steps")
    if any(line["steps"][COMPARE_STEP - 1]["after_save"] for line in by_mode.values()):
        raise AssertionError(f"train: a run saved before step {COMPARE_STEP}, the step the "
                             f"modes are compared at")
    if not all(r <= OVERLAP_LOSS_REL for r in overlap_loss_rel):
        raise AssertionError(f"train: overlap's losses are off conventional's: "
                             f"{overlap_loss_rel}, budget {OVERLAP_LOSS_REL}")
    if resume["resumed"] is None or resume["resumed"]["step"] != RESUME_STEP \
            or [s["step"] for s in resume["steps"]] != [RESUME_STEP + 1]:
        raise AssertionError(f"train: overlap did not resume from step {RESUME_STEP}: "
                             f"{resume['resumed']}, {resume['steps']}")
    want, got = dec["steps"][RESUME_STEP]["loss"], resume["steps"][0]["loss"]
    if not abs(got - want) <= RESUME_LOSS_REL * abs(want):
        raise AssertionError(f"train: the resumed step {RESUME_STEP + 1} loss {got} is off the "
                             f"decoupled run's {want}")
    for mode in ("decoupled", "conventional", "overlap"):
        if not parity[f"parity_f32_{mode}"]["rel"] <= TRAIN_PARITY_REL:
            raise AssertionError(f"train: the {mode} step is off the conventional step in one "
                                 f"process: {parity[f'parity_f32_{mode}']}")
    return {"launches": launches["decoupled"], "launches_by_run": launches}


# -- phase 9: the paper's decoupled MapReduce --------------------------------------

MR_ROWS = 8
# 16,384 documents of 4,096 word slots (2^26), Zipf(1.4) ids, skewed lengths
MR_CFG = dict(n_docs_per_row=2048, words_per_doc=4096, skew=0.8)
MR_VOCABS = (151_936, 32_000)  # qwen's vocabulary (global path); the block path
MR_GRANULARITY = 8192  # words per element: 64 KiB [keys | counts] elements
# (run, mode, vocab, keyword arguments of run_wordcount)
MR_RUNS = [("reference", "reference", 151_936, {}),
           ("decoupled", "decoupled", 151_936, {"alpha": 0.25}),
           ("pipelined", "pipelined", 151_936, {"alpha": 0.25, "chain_alphas": {"io": 0.125}}),
           ("decoupled_32000", "decoupled", 32_000, {"alpha": 0.25})]
MR_FOLD_ELEMENTS = 256  # elements of compute row 0's stream timed on a reduce row
# the measured variant's reduce-stage word count is an f32 running sum, as
# in the reference: each reduce row adds ~4,098 exact element counts and
# passes 2^24 (~17.2M words each), where every add may round by one (half
# an ulp of 2), and the group sum of the two rows by two (half an ulp of
# 4). So |count - valid words| <= adds on a row + 2; the per-row work
# vector and the histogram stay exact.


def fold_case(torch, device, corpus, vocab: int, work_rows: int) -> dict:
    """MapReduce's fold at the shape the main path gives it: the first
    `MR_FOLD_ELEMENTS` elements of compute row 0's stream, each added into
    an accumulator. Times per element the kernel's wrapper (keys already
    converted and clamped, one launch), its plain version (`index_add_`
    of the valid keys) and `torch.bincount` of the element's valid keys on
    the same inputs, and the whole fold (`histogram_fold`: conversion,
    clamp and launch); holds the kernel's and the fold's accumulators
    against the plain one bit for bit (integer counts under 2^24); the
    bound of one element from this data: its keys and counts read once,
    each bin it touches read and written once, one add per valid key."""
    from repro_torch.apps.mapreduce import _pack_word_elements, row_docs
    from repro_torch.core.operators import histogram_fold
    from repro_torch.kernels.stream_reduce import ops
    from repro_torch.kernels.stream_reduce.stream_reduce import histogram_plan

    t, m = row_docs(*corpus, 0, work_rows, MR_ROWS)
    elements, s = _pack_word_elements(torch.from_numpy(t).to(device),
                                      torch.from_numpy(m).to(device), MR_GRANULARITY)
    elements = elements[:MR_FOLD_ELEMENTS].contiguous()
    n = elements.shape[0]
    keys = [e[:s].to(torch.int32).clamp_(max=vocab - 1) for e in elements]
    counts = [e[s:] for e in elements]
    lib_in = [(k[k >= 0].long(), c[k >= 0]) for k, c in zip(keys, counts)]
    touched = sum(torch.unique(k).numel() for k, _ in lib_in)
    valid = sum(k.numel() for k, _ in lib_in)
    fold = histogram_fold(vocab, s)

    def kern(acc):
        for k, c in zip(keys, counts):
            ops.keyed_histogram(k, c, vocab, out=acc)

    def plain(acc):
        for k, c in zip(keys, counts):
            ops.keyed_histogram(k, c, vocab, out=acc, impl="ref")

    def whole(acc):
        for i in range(n):
            fold(acc, elements[i], i)

    accs = {}
    for name, fn in (("kernel", kern), ("plain", plain), ("fold", whole)):
        accs[name] = torch.zeros(vocab, device=device)
        fn(accs[name])
    torch.cuda.synchronize()
    if accs["plain"].max().item() >= 2 ** 24:
        raise AssertionError("mapreduce fold: a bin is past f32's exact integers")
    err = max((accs[k] - accs["plain"]).abs().max().item() for k in ("kernel", "fold"))
    identical = all(torch.equal(accs[k], accs["plain"]) for k in ("kernel", "fold"))
    acc = torch.zeros(vocab, device=device)
    run = {"kernel": [lambda: kern(acc)], "plain": [lambda: plain(acc)],
           "library": [lambda: [torch.bincount(k, c, minlength=vocab) for k, c in lib_in]],
           "fold": [lambda: whole(acc)]}
    nbytes = n * 2 * s * 4 + touched * 8
    b_ms, b_by = bound_ms(nbytes, float(valid), F32_FLOPS)
    case = {"elements": n, "keys_per_element": s, "valid_keys": valid, "touched_bins": touched,
            "plan": list(histogram_plan(vocab)), "bit_identical": identical,
            "max_abs_err": err, "bytes_per_element": nbytes / n,
            "bound_ms": b_ms / n, "bound_by": b_by,
            "library_call": "torch.bincount(keys[valid], counts[valid], minlength) per element"}
    for name, fns in run.items():
        by_kernel = device_ms_by_kernel(torch, fns, iters=4)
        case[f"{name}_ms"] = cuda_ms(torch, fns, iters=4, warmup=1) / n
        case[f"{name}_device_ms"] = sum(by_kernel.values()) / n if by_kernel else None
        case[f"{name}_device_ms_by_kernel"] = {k: v / n for k, v in by_kernel.items()}
    if not identical:
        raise AssertionError(f"mapreduce fold at {vocab} bins disagrees with its plain version:"
                             f" max abs err {err}")
    return case


def mapreduce_rank(mesh, seed: int, paths: dict) -> dict:
    """One rank of the MapReduce phase's eight-row world (run by `spawn`):
    each run of `MR_RUNS` through `run_wordcount`, its kernel counts set to
    0 just before and read just after, its phases, wire bytes and peak
    memory; the measured variant's counters; the fold timed on the first
    reduce row; the quickstart's workload statistics."""
    import torch

    from repro_torch.apps.mapreduce import (
        CorpusCfg,
        decoupled_wordcount_measured,
        load_corpus,
        row_docs,
        run_wordcount,
        wordcount_graph,
    )
    from repro_torch.examples.quickstart import workload_stats
    from repro_torch.launch.mesh import WireStats

    counters = kernel_counters()
    corpora = {v: load_corpus(paths[v]) for v in MR_VOCABS}
    out = {"row": mesh.row, "runs": {}}
    for name, mode, vocab, kw in MR_RUNS:
        cfg = CorpusCfg(**MR_CFG, vocab=vocab, seed=seed)
        phases = {}
        mesh.stats = WireStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.barrier()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        hist, _ = run_wordcount(mesh, mode, cfg, granularity_words=MR_GRANULARITY,
                                corpus=corpora[vocab], phases=phases, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["runs"][name] = {"wall_s": wall, "phases": phases,
                             "launches": {k: fn.launches for k, fn in counters.items()},
                             "wire": mesh.stats.as_dict(),
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                             "hist": hist.cpu().numpy(), "device": str(hist.device)}
        del hist
        torch.cuda.empty_cache()

    # the measured variant: per-row mapped words and the reduce stage's count
    cfg = CorpusCfg(**MR_CFG, vocab=MR_VOCABS[0], seed=seed)
    graph, gmesh, _ = wordcount_graph(mesh, "decoupled", 0.25)
    t, m = row_docs(*corpora[cfg.vocab], mesh.row, gmesh.compute.size, MR_ROWS)
    hist, work, stage = decoupled_wordcount_measured(
        torch.from_numpy(t).to(mesh.device), torch.from_numpy(m).to(mesh.device), cfg.vocab,
        graph, MR_GRANULARITY)
    out["measured"] = {"hist": hist.cpu().numpy(), "work": work.cpu().numpy(),
                       "stage": float(stage)}
    del t, m, hist

    # the fold alone, on the first reduce row while the others wait
    mesh.barrier()
    if mesh.row == gmesh.group("reduce").start:
        out["fold"] = {v: fold_case(torch, mesh.device, corpora[v], v, gmesh.compute.size)
                       for v in MR_VOCABS}
    mesh.barrier()
    out["quickstart"] = workload_stats(mesh, seed)
    return out


def mapreduce_phase(torch, np, seed: int, smi: str) -> dict:
    """The MapReduce phase: the corpora made once here and shared with the
    eight ranks through files, every run's histogram held against
    `np.bincount` of the valid words bit for bit, the modes against each
    other, the histogram kernel's launches against the schedule, the
    measured counters against the host's per-row counts, and the
    quickstart's statistics against the rows' figures."""
    import tempfile

    from repro_torch.apps.mapreduce import CorpusCfg, histogram_launches, save_corpus
    from repro_torch.launch.mesh import spawn

    total_docs = MR_CFG["n_docs_per_row"] * MR_ROWS
    t0 = time.perf_counter()
    host, paths, stats = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        for vocab in MR_VOCABS:
            cfg = CorpusCfg(**MR_CFG, vocab=vocab, seed=seed)
            os.makedirs(os.path.join(tmp, str(vocab)))
            paths[vocab] = save_corpus(cfg, total_docs, os.path.join(tmp, str(vocab)))
            tokens = np.load(paths[vocab] + ".tokens.npy", mmap_mode="r")
            mask = np.load(paths[vocab] + ".mask.npy", mmap_mode="r")
            valid = np.asarray(mask) > 0
            host[vocab] = np.bincount(np.asarray(tokens)[valid], minlength=vocab)
            stats[vocab] = {"valid_words": int(valid.sum()),
                            "hottest_bin": int(host[vocab].max()),
                            "doc_words": np.asarray(mask).sum(1)}
            del tokens, mask, valid
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn(mapreduce_rank, MR_ROWS, device="cuda", args=(seed, paths),
                      timeout_s=900)
        world_s = time.perf_counter() - t0
    for vocab in MR_VOCABS:
        if stats[vocab]["hottest_bin"] >= 2 ** 24:
            raise AssertionError(f"mapreduce: a bin ({stats[vocab]['hottest_bin']}) is past "
                                 f"f32's exact integers")
    runs, launches_total = [], {}
    for name, mode, vocab, kw in MR_RUNS:
        cfg = CorpusCfg(**MR_CFG, vocab=vocab, seed=seed)
        per = [r["runs"][name] for r in ranks]
        launches = {k: sum(p["launches"][k] for p in per) for k in per[0]["launches"]}
        for k, v in launches.items():
            launches_total[k] = launches_total.get(k, 0) + v
        want = histogram_launches(mode, cfg, MR_ROWS, granularity_words=MR_GRANULARITY, **kw)
        wall = max(p["wall_s"] for p in per)
        line = {"phase": "mapreduce", "run": name, "mode": mode, "vocab": vocab,
                "rows": MR_ROWS, "corpus": {**MR_CFG, "seed": seed, "docs": total_docs},
                "granularity_words": MR_GRANULARITY, "element_bytes": 2 * MR_GRANULARITY * 4,
                "valid_words": stats[vocab]["valid_words"],
                "hottest_bin": stats[vocab]["hottest_bin"], "wall_s": wall,
                "valid_words_per_s": stats[vocab]["valid_words"] / wall,
                "launches": launches, "histogram_expected": want,
                "histogram_by_row": [p["launches"]["histogram"] for p in per],
                "bit_identical_to_host": all(np.array_equal(p["hist"], host[vocab])
                                             for p in per),
                "device": per[0]["device"],
                "per_rank": [{"row": r["row"], "wall_s": p["wall_s"], "phases": p["phases"],
                              "peak_gib": p["peak_gib"],
                              "wire": {k: v for k, v in p["wire"].items() if v}}
                             for r, p in zip(ranks, per)],
                "wire": "gloo over host loopback (device -> pinned host -> gloo -> host -> device)",
                "nvidia_smi": smi}
        emit(line)
        if not line["bit_identical_to_host"]:
            raise AssertionError(f"mapreduce {name}: a row's histogram differs from the host's "
                                 f"np.bincount")
        if launches["histogram"] != want or want <= 0:
            raise AssertionError(f"mapreduce {name}: histogram launched {launches['histogram']} "
                                 f"times, the schedule says {want}")
        if not per[0]["device"].startswith("cuda"):
            raise AssertionError(f"mapreduce {name}: the histogram lies on {per[0]['device']}")
        runs.append(line)
    by_vocab = {}
    for (name, _, vocab, _), r in zip(MR_RUNS, ranks[0]["runs"].values()):
        by_vocab.setdefault(vocab, []).append(r["hist"])
    if not all(np.array_equal(h, hs[0]) for hs in by_vocab.values() for h in hs):
        raise AssertionError("mapreduce: the modes disagree")

    # the measured variant's counters against the host's per-row counts:
    # the work vector exactly; the reduce stage's word count, an f32 sum
    # (the reference's counter) past 2^24 on each reduce row, within its
    # rounding (stated beside MR_FOLD_ELEMENTS)
    per_row = -(-total_docs // (MR_ROWS - 2))
    doc_words = stats[MR_VOCABS[0]]["doc_words"]
    want_work = np.array([doc_words[r * per_row:(r + 1) * per_row].sum()
                          for r in range(MR_ROWS)], np.float32)
    valid = stats[MR_VOCABS[0]]["valid_words"]
    folds = max(next(r for r in runs if r["run"] == "decoupled")["histogram_by_row"])
    stage_budget = folds + 2
    measured = [{"row": r["row"], "work": r["measured"]["work"].tolist(),
                 "stage": r["measured"]["stage"]} for r in ranks]
    measured_ok = all(np.array_equal(r["measured"]["work"], want_work)
                      and abs(r["measured"]["stage"] - valid) <= stage_budget
                      and np.array_equal(r["measured"]["hist"], host[MR_VOCABS[0]])
                      for r in ranks)
    fold = next(r["fold"] for r in ranks if "fold" in r)
    local = np.array([r["quickstart"]["local"] for r in ranks])
    qstats = ranks[-1]["quickstart"]["stats"]
    compute = np.sort(local[:-1])
    quick_ok = (abs(qstats["min"] - compute[0]) <= 1e-3 and abs(qstats["max"] - compute[-1])
                <= 1e-3 and abs(qstats["median"] - float(np.median(compute))) <= 1e-3
                and qstats["count"] == MR_ROWS - 1)
    summary = {"phase": "mapreduce_summary", "corpus_s": corpus_s, "world_s": world_s,
               "numpy": np.__version__,
               "measured_counters_match_host": measured_ok, "host_work": want_work.tolist(),
               "valid_words": valid, "stage_budget": stage_budget, "measured": measured,
               "fold": {str(k): v for k, v in fold.items()},
               "quickstart": {"local": local.tolist(), "stats": qstats, "ok": quick_ok},
               "launches": launches_total, "nvidia_smi": smi}
    emit(summary)
    if not measured_ok:
        raise AssertionError("mapreduce: the measured counters differ from the host's counts")
    if not quick_ok:
        raise AssertionError(f"quickstart: analytics {qstats} disagree with the rows {local}")
    return {"runs": runs, "launches": launches_total, "fold": fold}


# -- phase 10: the paper's halo-exchange CG -------------------------------------------

CG_ROWS = 8
# the paper's per-process grid (120^3) and its 300 iterations; the x-slab
# is 126 so that 7 compute rows (decoupled) split the same 1,008 x 120 x
# 120 global grid, 144 planes each
CG_CFG = dict(nx_local=126, ny=120, nz=120, n_iters=300)
CG_ALPHA = 0.125  # decoupled: 7 compute rows, 1 halo row
CG_MODES = ("blocking", "nonblocking", "decoupled")
# tolerances, stated before the run (PERF.md §6): blocking and
# nonblocking bit for bit (the same operations in the same order). The
# decoupled mode against blocking, on sqrt(r.r) per iteration: 1e-3 over
# the first 20 iterations (the reference test's bound) and 1e-4 over all
# 300 (another slab split sums the dot products in another order; f32
# drift measured <= 8.5e-6 on grids of the same x extent,
# scripts/torch_cg_drift.py). The reported residual sqrt(r.r) against
# ||b - A u|| recomputed in float64 on the host from the gathered u: 1e-4
# relative (the recursive residual's f32 drift, measured <= 1.9e-5 there).
CG_FIRST_REL = 1e-3
CG_ALL_REL = 1e-4
CG_TRUE_REL = 1e-4


def cg_rank(mesh) -> dict:
    """One rank of the CG phase's eight-row world (run by `spawn`): each
    mode of `CG_MODES` as `apps.cg.run_cg` runs it: `cg_setup` (the
    grouped mesh, the right-hand side on the card) before the clock starts
    and `cg_solve` inside it, so that the wall time and wire statistics
    are the iterations' alone; its kernel counts set to 0 just before and
    read just after, and peak memory; then the
    stencil of one slab timed on row 0. The right-hand side is the
    reference's (`default_rng(7)`), so the phase takes no seed."""
    import torch

    from repro_torch.apps.cg import (CGCfg, _apply_halo, _laplacian_inner, cg_rhs, cg_setup,
                                     cg_solve)
    from repro_torch.launch.mesh import WireStats

    counters = kernel_counters()
    base = CGCfg(**CG_CFG)
    rhs = {n: cg_rhs(base, CG_ROWS, n) for n in (CG_ROWS, CG_ROWS - 1)}
    out = {"row": mesh.row, "runs": {}}
    for mode in CG_MODES:
        cfg = dataclasses.replace(base, mode=mode)
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        b, gmesh = cg_setup(mesh, cfg, CG_ALPHA,
                            rhs=rhs[CG_ROWS - 1 if mode == "decoupled" else CG_ROWS])
        mesh.stats = WireStats()
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        u, res, hist = cg_solve(b, cfg, gmesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["runs"][mode] = {"wall_s": wall, "u": u.cpu().numpy(), "res": float(res),
                             "hist": hist.cpu().numpy(), "wire": mesh.stats.as_dict(),
                             "launches": {k: fn.launches for k, fn in counters.items()},
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                             "device": str(u.device)}
        del u
    mesh.barrier()
    if mesh.row == 0:
        slab = torch.randn((144, CG_CFG["ny"], CG_CFG["nz"]), device=mesh.device)
        plane = torch.zeros_like(slab[0])
        out["stencil_ms"] = cuda_ms(torch, [lambda: _apply_halo(_laplacian_inner(slab), plane,
                                                                plane)], iters=20)
    mesh.barrier()
    return out


def cg_phase(torch, np, smi: str) -> dict:
    """The CG phase: one line per mode, then the checks, with the
    tolerances stated beside `CG_CFG`."""
    from repro_torch.apps.cg import CGCfg, cg_rhs, residual_norm
    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    ranks = spawn(cg_rank, CG_ROWS, device="cuda", timeout_s=600)
    world_s = time.perf_counter() - t0
    cfg = CGCfg(**CG_CFG)
    b = cg_rhs(cfg, CG_ROWS, CG_ROWS).reshape(-1, cfg.ny, cfg.nz)
    lines = {}
    base = np.sqrt(ranks[0]["runs"]["blocking"]["hist"])
    for mode in CG_MODES:
        per = [r["runs"][mode] for r in ranks]
        work = CG_ROWS - 1 if mode == "decoupled" else CG_ROWS
        u = np.stack([p["u"] for p in per])
        hist = per[0]["hist"]
        rel = np.abs(np.sqrt(hist) - base) / base
        true = residual_norm(u[:work].reshape(-1, cfg.ny, cfg.nz), b)
        wall = max(p["wall_s"] for p in per)
        launches = {k: sum(p["launches"][k] for p in per) for k in per[0]["launches"]}
        line = {"phase": "cg", "mode": mode, "grid": list(b.shape), "rows": CG_ROWS,
                "compute_rows": work, "slab": [u.shape[1], cfg.ny, cfg.nz],
                "iters": cfg.n_iters, "wall_s": wall, "s_per_iter": wall / cfg.n_iters,
                "hist_first_last": [float(hist[0]), float(hist[-1])],
                "reported_residual": per[0]["res"], "true_residual": true,
                "true_vs_reported_rel": abs(true - per[0]["res"]) / per[0]["res"],
                "vs_blocking_first20": float(rel[:20].max()),
                "vs_blocking_all": float(rel.max()),
                "sent_bytes": sum(p["wire"]["sent_bytes"] for p in per),
                "launches": launches, "device": per[0]["device"],
                "per_rank": [{"row": r["row"], "wall_s": p["wall_s"], "peak_gib": p["peak_gib"],
                              "wire": {k: v for k, v in p["wire"].items() if v}}
                             for r, p in zip(ranks, per)],
                "wire": "gloo over host loopback (device -> pinned host -> gloo -> host -> device)",
                "nvidia_smi": smi}
        emit(line)
        lines[mode] = line
        if not per[0]["device"].startswith("cuda"):
            raise AssertionError(f"cg {mode}: u lies on {per[0]['device']}")
        if not all(np.array_equal(p["hist"], hist) for p in per[:work]):
            raise AssertionError(f"cg {mode}: the compute rows' histories differ")
        if not hist[-1] < hist[0]:
            raise AssertionError(f"cg {mode}: r.r rose from {hist[0]} to {hist[-1]}")
        if line["true_vs_reported_rel"] > CG_TRUE_REL:
            raise AssertionError(f"cg {mode}: true residual {true} against the reported "
                                 f"{per[0]['res']}")
    same = all(np.array_equal(r["runs"]["blocking"][k], r["runs"]["nonblocking"][k])
               for r in ranks for k in ("u", "hist"))
    summary = {"phase": "cg_summary", "world_s": world_s,
               "blocking_equals_nonblocking": same,
               "stencil_ms": next(r["stencil_ms"] for r in ranks if "stencil_ms" in r),
               "tolerances": {"decoupled_first20": CG_FIRST_REL, "decoupled_all": CG_ALL_REL,
                              "true_residual": CG_TRUE_REL},
               "nvidia_smi": smi}
    emit(summary)
    if not same:
        raise AssertionError("cg: blocking and nonblocking differ")
    dec = lines["decoupled"]
    if dec["vs_blocking_first20"] > CG_FIRST_REL or dec["vs_blocking_all"] > CG_ALL_REL:
        raise AssertionError(f"cg: decoupled against blocking {dec['vs_blocking_first20']} "
                             f"(first 20), {dec['vs_blocking_all']} (all)")
    return {"lines": lines, "launches": {k: sum(ln["launches"][k] for ln in lines.values())
                                         for k in dec["launches"]}}


# -- phase 11: the paper's particle communication and decoupled I/O ------------------------

PIC_ROWS = 8
# 2^21 particles over 1,048,576 slots per row: the heaviest row starts with
# ~0.35 x 2^21 (skew 0.8 over 6 rows), under the capacity
PIC_CFG = dict(capacity=2 ** 20, n_particles_total=2 ** 21, n_steps=8, dt=0.08, skew=0.8)
PIC_ALPHA = 0.125
PIC_IO_CHUNKS = 256  # the io service's ring: 6 rows x 3 chunks x 8 steps = 144 fit
DRAIN_GRANULARITY = 2 ** 20  # the final state's drain: 6 rows x 3 chunks
DRAIN_CAPACITY = 64


def pic_rank(mesh, seed: int, sink_dir: str) -> dict:
    """One rank of the PIC phase's eight-row world (run by `spawn`): each
    run of `apps.pic.RUNS` through `apps.pic.run_pic`, its kernel counts set to
    0 just before and read just after, with its phase times, movers, wire
    statistics and peak memory; after the io run, its final state streamed
    to a `HostSink` through `io.iogroup.stream_to_io_group`."""
    import torch

    from repro_torch.apps.pic import RUNS, PICCfg, pic_graph, run_pic
    from repro_torch.io.iogroup import HostSink, stream_to_io_group
    from repro_torch.launch.mesh import WireStats

    counters = kernel_counters()
    cfg = PICCfg(**PIC_CFG, seed=3 + seed)
    out = {"row": mesh.row, "runs": {}}
    for name, mode, io_alpha in RUNS:
        stats = {}
        mesh.stats = WireStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.barrier()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = run_pic(mesh, mode, cfg, PIC_ALPHA, io_alpha, PIC_IO_CHUNKS, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        x, v, m = res[:3]
        run = {"wall_s": wall, "stats": stats, "x": x.cpu().numpy(), "v": v.cpu().numpy(),
               "m": m.cpu().numpy(), "counts": res[3].cpu().numpy(),
               "io_chunks": int(res[4]) if len(res) > 4 else None,
               "launches": {k: fn.launches for k, fn in counters.items()},
               "wire": mesh.stats.as_dict(),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "device": str(x.device)}
        if io_alpha > 0:
            graph = pic_graph(mesh, mode, PIC_ALPHA, io_alpha)
            sink = HostSink(sink_dir)
            mesh.barrier()
            t0 = time.perf_counter()
            n = stream_to_io_group({"x": x, "v": v, "m": m}, graph, sink,
                                   granularity_elems=DRAIN_GRANULARITY,
                                   capacity_chunks=DRAIN_CAPACITY)
            torch.cuda.synchronize()
            run["drain"] = {"s": time.perf_counter() - t0, "chunks": int(n),
                            "files": sink.n_drains}
        out["runs"][name] = run
        del res, x, v, m
        torch.cuda.empty_cache()
    return out


def pic_phase(torch, np, seed: int, smi: str) -> dict:
    """The PIC phase: one line per run, then the checks: particles conserved
    at every step and owned by their row, the valid (x, v) over all rows
    equal to a numpy replay of the push in f32 from the run's initial
    particles, the io row's chunks, and the drained file equal to the
    packed final state bit for bit."""
    import tempfile

    from repro_torch.apps.pic import RUNS, PICCfg, init_particles
    from repro_torch.launch.mesh import spawn

    cfg = PICCfg(**PIC_CFG, seed=3 + seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sink_") as sink_dir:
        t0 = time.perf_counter()
        ranks = spawn(pic_rank, PIC_ROWS, device="cuda", args=(seed, sink_dir), timeout_s=600)
        world_s = time.perf_counter() - t0
        files = sorted(os.listdir(sink_dir))
        drained = np.load(os.path.join(sink_dir, files[0])) if files else None
    lines, launches_total = {}, {}

    def sorted_pairs(x, v):
        order = np.lexsort((v, x))
        return np.stack([x[order], v[order]])

    for name, mode, io_alpha in RUNS:
        per = [r["runs"][name] for r in ranks]
        work = PIC_ROWS - (0 if mode == "reference" else 1) - (1 if io_alpha > 0 else 0)
        width = np.float32(cfg.domain / work)
        counts = np.stack([p["counts"] for p in per])
        conserved = bool((counts.sum(0) == cfg.n_particles_total).all())
        owned = all(r < work or not (p["m"] > 0).any() for r, p in enumerate(per)) and all(
            (np.floor(p["x"][p["m"] > 0] / width) == r).all() for r, p in enumerate(per))
        xs, vs, valid = init_particles(cfg, work)
        x, v = xs[valid > 0], vs[valid > 0]
        for _ in range(cfg.n_steps):
            x = x + v * np.float32(cfg.dt) * np.float32(1.0)
            v = np.where((x < 0) | (x > np.float32(cfg.domain)), -v, v)
            x = np.clip(x, np.float32(0.0), np.float32(cfg.domain - 1e-6))
        got_x = np.concatenate([p["x"][p["m"] > 0] for p in per])
        got_v = np.concatenate([p["v"][p["m"] > 0] for p in per])
        replay = got_x.shape == x.shape and np.array_equal(sorted_pairs(got_x, got_v),
                                                           sorted_pairs(x, v))
        steps_s = [sum(p["stats"].get(k, 0.0) for k in ("push_s", "comm_s", "io_s"))
                   for p in per]
        launches = {k: sum(p["launches"][k] for p in per) for k in per[0]["launches"]}
        for k, n in launches.items():
            launches_total[k] = launches_total.get(k, 0) + n
        line = {"phase": "pic", "run": name, "mode": mode, "rows": PIC_ROWS,
                "compute_rows": work, "service": {"comm": int(mode == "decoupled"),
                                                  "io": int(io_alpha > 0)},
                "cfg": {**PIC_CFG, "seed": cfg.seed}, "wall_s": max(p["wall_s"] for p in per),
                "steps_s": max(steps_s), "s_per_step": max(steps_s) / cfg.n_steps,
                "movers_per_step": np.sum([p["stats"]["movers"] for p in per], 0).tolist(),
                "max_row_particles": int(counts.max()),
                "sent_bytes": sum(p["wire"]["sent_bytes"] for p in per),
                "conserved": conserved, "owned": owned, "replay_identical": replay,
                "io_chunks": [p["io_chunks"] for p in per], "launches": launches,
                "device": per[0]["device"],
                "per_rank": [{"row": r["row"], "wall_s": p["wall_s"], "peak_gib": p["peak_gib"],
                              **{k: p["stats"][k] for k in ("push_s", "comm_s", "io_s")
                                 if k in p["stats"]},
                              "wire": {k: v for k, v in p["wire"].items() if v}}
                             for r, p in zip(ranks, per)],
                "wire": "gloo over host loopback (device -> pinned host -> gloo -> host -> device)",
                "nvidia_smi": smi}
        if io_alpha > 0:
            state = np.concatenate([np.stack([p["m"], p["v"], p["x"]]) for p in per[:work]])
            io_row = per[PIC_ROWS - 1]["drain"]
            line["drain"] = {"files": files, "chunks": io_row["chunks"],
                             "bytes": None if drained is None else drained.nbytes,
                             "io_row_s": io_row["s"],
                             "slowest_s": max(p["drain"]["s"] for p in per),
                             "identical": drained is not None
                             and drained.shape == state.shape
                             and np.array_equal(drained.view(np.uint32), state.view(np.uint32))}
        emit(line)
        lines[name] = line
        if not per[0]["device"].startswith("cuda"):
            raise AssertionError(f"pic {name}: particles lie on {per[0]['device']}")
        if not (conserved and owned and replay):
            raise AssertionError(f"pic {name}: conserved {conserved}, owned {owned}, "
                                 f"replay identical {replay}")
        if io_alpha > 0:
            want = [0] * (PIC_ROWS - 1) + [work * 3 * cfg.n_steps]
            if line["io_chunks"] != want:
                raise AssertionError(f"pic {name}: io chunks {line['io_chunks']}, want {want}")
            if files != ["drain_000000.npy"] or not line["drain"]["identical"]:
                raise AssertionError(f"pic {name}: the drain wrote {files}, identical to the "
                                     f"packed state: {line['drain']['identical']}")
    emit({"phase": "pic_summary", "world_s": world_s, "launches": launches_total,
          "nvidia_smi": smi})
    return {"lines": lines, "launches": launches_total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.configs import get
        from repro_torch.kernels import runtime
        from repro_torch.models.model_zoo import build
        from repro_torch.serve import KVSpec
    except ImportError as e:
        print(f"chip_smoke: the repository's src/repro_torch is missing ({e})", file=sys.stderr)
        return 2

    # phase 1: device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # phase 2: build every kernel of the path, one nvcc per source at once
    t0 = time.perf_counter()
    libs = runtime.build_all()
    ptxas = {}
    for name, path in libs.items():
        log = path.with_name(path.name + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {n: str(p.relative_to(HERE)) for n, p in libs.items()}, "ptxas": ptxas})

    # phase 3: kernels against their plain versions, full-width shapes
    kernels = [check_paged(torch, np, args.seed), check_argmax(torch, np, args.seed),
               check_flash(torch, np, args.seed), check_ssd(torch, np, args.seed),
               check_accumulate(torch, np, args.seed), check_histogram(torch, np, args.seed)]
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4: full-width serve of tinyllama-1.1b
    cfg = get("tinyllama-1.1b")
    model = build(cfg)
    params = model.init(args.seed)
    bf16 = serve_arm(torch, np, model, params, arm="bf16",
                     reqs=short_requests(np, cfg, n_req=16, seed=args.seed),
                     kv=KVSpec(kind="paged", block_size=16, prefix_cache=True))
    if bf16["prefix_hit_tokens"] <= 0:
        raise AssertionError("the shared prefix never hit the prefix cache")
    serve_arm(torch, np, model, params, arm="int8",
              reqs=short_requests(np, cfg, n_req=4, seed=args.seed + 1),
              kv=KVSpec(kind="paged", block_size=16, kv_dtype="int8"))
    profile_decode(torch, np, model, params, seed=args.seed + 2)
    del model, params
    torch.cuda.empty_cache()

    # phase 6: long prompts, qwen2.5-3b at full width and depth
    qcfg = get("qwen2.5-3b")
    qmodel = build(qcfg)
    # the prefix cache keeps one entry per 16-token block boundary of a
    # prompt; its default 256 entries hold 4,096 tokens of prefixes, so
    # the arm sizes it to both slots' prompts (a 12,000-token document
    # alone takes 750)
    qparams = qmodel.init(args.seed)
    long = serve_arm(torch, np, qmodel, qparams, arm="long",
                     reqs=long_requests(np, qcfg, seed=args.seed + 3), max_batch=2,
                     max_len=16384, kv=KVSpec(kind="paged", block_size=16, prefix_cache=True,
                                              prefix_capacity=2 * (16384 // 16 + 1)))
    if long["prefix_hit_tokens"] <= 0:
        raise AssertionError("the shared document never hit the prefix cache")
    if any(shape[1] != 16384 for shape in long["prefill_shapes"]):
        raise AssertionError(f"a long prompt missed the 16384 bucket: {long['prefill_shapes']}")
    # one profiled window of the long arm's decode ticks: 2 slots at the
    # arm's 15,000- and 9,500-token prompts
    profile_decode(torch, np, qmodel, qparams, seed=args.seed + 7, ticks=8,
                   prompt_lens=(15_000, 9_500), max_len=16384)
    del qparams
    # the arms' engines hold their params in reference cycles (the timed
    # step closures): collect them, so the mamba arm's peak is its own
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()

    # phase 7: mamba2-130m at full width and depth, aligned mode
    mcfg = get("mamba2-130m")
    mmodel = build(mcfg)
    mparams = mmodel.init(args.seed)
    mamba = mamba_arm(torch, np, mmodel, mparams,
                      reqs=mamba_requests(np, mcfg, n_req=16, seed=args.seed + 4))
    profile_prefill(torch, np, mmodel, mparams, seed=args.seed + 5)
    profile_decode(torch, np, mmodel, mparams, seed=args.seed + 6, mode="aligned")
    del mmodel, mparams
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8: training in every step mode, with checkpoints and a resume,
    # qwen1.5-0.5b at full width in a four-row world on this card
    train = train_phase(torch, np, args.seed + 8, smi)

    # phase 9: the paper's decoupled MapReduce in an eight-row world on this card
    mapreduce = mapreduce_phase(torch, np, args.seed, smi)

    # phases 10 and 11: the paper's halo-exchange CG, and its particle
    # communication and decoupled I/O, in eight-row worlds on this card
    cg = cg_phase(torch, np, smi)
    pic = pic_phase(torch, np, args.seed, smi)

    # phase 12: summary; "launches" is the count from the run of the path
    # each kernel belongs to (the bf16 tinyllama arm for paged decode,
    # argmax and flash; the mamba arm for the SSD scan; the train phase's
    # decoupled run, summed over its four ranks, for chunk_accumulate, every
    # train run's counts beside it (launches_train_by_run); the MapReduce
    # phase, its four runs summed over their eight ranks, for histogram),
    # each arm's counts beside it (the CG and PIC phases launch none of the
    # kernels: their stencil, dots, push and merges are plain PyTorch, as the
    # reference's are plain jnp).
    # "ms", "plain_ms" and "library_ms" are CUDA-event times of
    # back-to-back calls (host launch gaps included); the "*device_ms"
    # keys are the profiler's kernel time alone. The histogram's path gives
    # it 8,192-key elements to add into the reducer's accumulator, so its
    # row holds that fold's times per element at 151,936 bins, and the
    # 2^26-key case's beside them ("isolated_2p26").
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
             "plain_device_ms", "library_device_ms")
    for kern in kernels:
        name = kern["name"]
        if name == "histogram":
            fold = mapreduce["fold"][MR_VOCABS[0]]
            kern["isolated_2p26"] = {k: kern[k] for k in timed}
            kern.update({k: fold["kernel_" + k if k in ("ms", "device_ms") else k]
                         for k in timed},
                        max_abs_err=max(kern["max_abs_err"], fold["max_abs_err"]))
        main_arm = {"ssd_scan": mamba["launches"], "chunk_accumulate": train["launches"],
                    "histogram": mapreduce["launches"]}.get(name, bf16["launches"])
        kern["launches"] = main_arm[name]
        kern["launches_long_arm"] = long["launches"][name]
        kern["launches_mamba_arm"] = mamba["launches"][name]
        kern["launches_train"] = train["launches"][name]
        kern["launches_train_by_run"] = {run: counts[name]
                                         for run, counts in train["launches_by_run"].items()}
        kern["launches_mapreduce"] = mapreduce["launches"][name]
        kern["launches_cg"] = cg["launches"][name]
        kern["launches_pic"] = pic["launches"][name]
        if kern["launches"] <= 0:
            raise AssertionError(f"{name} was launched no time on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "plain_device_ms", "library_device_ms", "launches_long_arm",
            "launches_mamba_arm", "launches_train", "launches_train_by_run",
            "launches_mapreduce", "launches_cg", "launches_pic")
    emit({"kernels": [{k: kern[k] for k in keys + ("isolated_2p26",) if k in kern}
                      for kern in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report it, print no result
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        import traceback

        traceback.print_exc()
        sys.exit(1)
