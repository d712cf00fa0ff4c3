#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing JSON lines (each phase line carries ``seconds``
since its phase began; a ``timing`` line gives every phase's total); any
failure exits non-zero and prints no result:

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
6b. scenario — the serving user's path, `python -m
               repro_torch.examples.serve_lm --scenario bursty-prefix --paged
               --trace PATH`, through the example's own `serve_lm.serve`
               on the same qwen2.5-3b weights, the scenario cut to its
               first 40 arrival ticks: 68 requests of three
               tenants through `FleetScheduler` (WFQ,
               token budget 2000, aging 0.05) into the paged engine (4
               slots, max_len 160, prefix cache) with the tracer on: a
               valid Chrome trace, one closed lifecycle per accepted
               request, the registry's counts against the engine's, launch
               counts (paged = layers x decode ticks, flash = layers x
               prefill calls, argmax >= ticks + admissions) and the
               tracer's own host time (its calls made again on a fresh
               tracer); then the same replay with the tracer off, whose
               streams, ticks, ledger and every decode tick's logits (a hash
               a tick) must be identical; then `single-fifo` through two
               aligned engines in lockstep, `FleetScheduler.fifo()` against
               a bare deque (`DequeShim`), every decode tick's logits bit for
               bit.
6c. spec    — speculative decoding (`serve/spec.py`) on qwen2.5-3b at full
               width and depth, k = 4. (a) f32 (TF32 off) from --seed, the
               draft the target's copy plus `SPEC_EPS` * N(0, 1) per float
               leaf: fig17's settings (4 slots, max_len 96, 12 requests of
               4-15 prompt tokens, 14 new each) over the dense store and the
               paged store of 8-token blocks; every stream equal to the
               target-only engine's up to its first step with a top-2 margin
               under `SPEC_MARGIN`, acceptance inside `SPEC_ACCEPT_BAND`, at
               every tick the draft store's lengths equal to the target
               store's and private blocks = the live block demand, none in
               use after the drain, and exact launch counts (argmax =
               admissions + draft steps + verify calls; flash = layers x
               each model's prefill calls; paged 0). (b) bf16 on phase 6's
               weights through `serve_lm.serve` at the example's settings
               (paged, 16-token blocks, prefix cache): the example's 10
               requests target-only, with a full-width qwen1.5-0.5b draft
               (random bf16 weights from --seed + 1; the reference's pair)
               and with the noised bf16 target: tokens/s, ms a tick (no
               synchronisation added, as target-only), acceptance, tokens
               per verify, peak memory, launch counts; then `bursty-prefix`
               cut to its first 24 arrival ticks (25 of 145 requests)
               with the noised draft, through the multi-tenant scheduler
               and the shared prefix cache: the stores checked every
               tick and after the drain, prefix hits, launch counts; then
               for the qwen1.5-0.5b draft a fresh engine of 4 slots at a
               fixed load: 4 spec ticks on the host clock, 4 profiled as
               in phase 5 and 4 with ms per draft step, verify forward
               and rollback, each ended by a synchronisation. (c) sampled mode: seed 3 twice gives identical
               streams, seed 4 others.
6d. disagg  — disaggregated serving and the serving fleet
               (`serve/disagg.py`, `checkpoint_bridge.py`, `fleet.py`). (a)
               qwen2.5-3b in f32 (TF32 off) from --seed: `DisaggEngine`
               (aligned, dense, 4 prefill rows, 4 decode slots) beside the
               colocated aligned `Engine` (4 slots) on 4 requests of 64-512
               prompt tokens, 16 new each, in lockstep: every decode tick's
               logits, the streams and the slot caches bit for bit (else the
               largest difference and the margin rule). (c) the same f32
               model: a `FleetEngine` with checkpoint recovery (a snapshot
               every 4 ticks, continuous, paged) on phase 6c's 12 requests,
               a device loss right after the snapshot at tick 8: restored >=
               1, every stream = the colocated continuous engine's under the
               margin rule; the snapshot's bytes and save()'s blocking
               seconds. (b) the bf16 weights through `serve_lm.serve`, the
               user's `serve_lm --scenario bursty-multitenant --adapt
               --paged --fail-at 36 --preempt-at 32` (8 rows, 2 prefill, 1
               slot a row, the scenario's first 44 of 56 arrival ticks, cut
               for the smoke's time since phase 8c): every accepted
               request finished, a device loss, a preemption and a regrow in
               the fault log, staged >= 1 and retried >= 1, a replan, block
               references = the live demand after every tick and none in use
               after the drain, launches exact (flash = layers x prefill
               calls, paged = layers x decode ticks, argmax = first tokens +
               decode ticks); regroups, deferrals, TTFT p50/p99, tokens/s.
               (d) `build_disagg_spmd_step` in a four-row gloo world of
               tinyllama-1.1b (bf16, 2 prefill + 2 decode rows, 2 slots a
               row, 512-token prompts, 4 ticks): the decode rows' tokens,
               cursors and KV equal a one-process replay on the card bit for
               bit, the stats the arithmetic, and `reshard_serving_state` 2
               + 2 -> 1 + 3 inside the world keeps every kept slot's KV and
               token bit for bit; the handoff's wire bytes and seconds.
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
7b. moe     — the MoE family (`models/moe.py`) at full width and cut
               depth, random weights from --seed, through `make_engine`
               in continuous mode (paged store of 16-token blocks, prefix
               cache), one model at a time: (a) mixtral-8x7b, 2 of 32
               layers, f32 (TF32 off), 4 slots, 8 requests of 64-1,500
               tokens, 16 new each: the first prefill call's logits within
               1e-4 of their largest magnitude of the plain route's and the
               first decode tick's within 1e-3 (`MOE_F32_DECODE_REL`), with
               every expert choice identical, and
               every stream the plain-route engine's under the margin
               rule; (b) mixtral-8x7b, 8 layers, bf16, 8 slots, max_len
               8,192: 16 requests of 64-2,048 tokens, two over one
               3,000-token document and two of 5,000-6,000 (past the 4,096
               window), 32 new each; (c) llama4-scout-17b-a16e, 4 of 48
               layers (3 chunked-local, 1 global), bf16, 2 slots, max_len
               16,384: three prompts of 9,000-14,000 tokens, two over one
               8,000-token document, 16 new each. (b) and (c) hold the
               first calls to 1/16 of the plain route's largest logit with
               the kernel call's expert choices replayed (`RouteTape`), and
               report the share of tokens whose own choice differs. Every
               arm: launches exact (paged = layers x decode ticks, flash =
               layers x prefill calls, argmax = ticks + admissions), prefix
               hits, ms per prefill call, the median decode tick, tokens/s,
               peak memory; (b) also one forward's aux_loss and
               router_entropy.
7c. families — the last model families at full width and depth, random
               weights from --seed, one model at a time: (a) pixtral-12b
               bf16: 4 image prompts (256 patch embeddings, N(0, 0.02^2),
               before 768-2,048 text tokens) through `model.prefill(patches=)`,
               migrated into a 4-slot aligned cache, 32 `decode_step` ticks;
               then 8 text requests of 64-2,048 tokens, 32 new each,
               through `make_engine` in continuous mode (paged store of
               16-token blocks, prefix cache); (b) hymba-1.5b bf16 through
               `make_engine` in aligned mode: 8 slots, 16 prompts of
               500-8,000 tokens (all but the shortest past the 1,024-token
               window), 64 new each, flash and the SSD scan in every layer
               of every prefill; (c) whisper-small bf16: 8 requests of 1,500
               frames and a 16-token prompt through `model.prefill(frames=)`
               (flash in the 12 encoder layers and in both attentions of the
               12 decoder layers), 128 new tokens; each with exact launch
               counts, ms per prefill call, prefill tokens/s, the median
               decode tick, tokens/s, peak memory and the first calls
               against the plain route (1/16 of the largest logit); (d) f32
               (TF32 off, f32 caches): pixtral-12b at 2 layers, hymba-1.5b
               and whisper-small whole, 2 requests each: the first prefill
               call's and the first decode tick's logits within 1e-4 of the
               plain route's largest, 16 greedy tokens under the margin rule.
   The kernels phase also holds chunk_accumulate against its plain
   version (bit for bit at the train phases' f32 folds, summed into the
   accumulator's row as the stream channel calls it: phase 8's (2,
   184,549,376) and phase 8d (c)'s mixtral column (2, 859,832,320); and at a ragged
   S; 1e-6 at n = 7 and at 16 rows of bf16); the argmax
   at each serve arm's decode shape ((8, 32,000), (2, 151,936), (8,
   50,280)), at the spec path's verify targets and draft step ((20,
   151,936), (4, 151,936)) and at two admission rows (the last position of (1, 1024, V),
   V = 32,000 and 151,936), maxima planted at its split's edges, exact,
   with host microseconds per call beside `torch.argmax`'s (and at
   llama4-scout's (2, 202,048) decode tick and (1, 1024, 202,048)
   admission row), at (8, 32,001), (8, 51,865) and (4, 131,072) (phase
   7c's decode ticks); paged decode at phase 7b's shapes (mixtral-8x7b's 8
   slots over 32/8 heads of 128, window 4,096; llama4-scout's 2 slots
   over 40/8, windows 8,192 and 0, in a 16,384-position view) and flash
   attention at (8, 1,024, 32/8, 128), window 4,096, and (1, 12,000,
   40/8, 128), windows 8,192 and 0 (also in f32), hymba-1.5b's (1, 8,192,
   25/5, 64) past its 1,024 window and whisper-small's non-causal (8,
   1,500, 12/12, 64) encoder and (8, 16 x 1,500) cross-attention (also in
   f32); the SSD scan at hymba-1.5b's (1, 8,192, 50 x 64), state 16 (and in
   f32 at S=1000); and the keyed
   histogram (2^26 Zipf keys into 151,936 bins, the same keys with the
   bins permuted, 2^26 uniform keys with f32 and bf16 counts, 4,096 bins,
   and 2^24 keys at 58,112 / 58,113 bins, the plan's path boundary),
   exact at counts of 1.
8. train    — qwen1.5-0.5b at full width, 2 of its 24 layers (cut for
               the smoke's time: 12 since phase 8b, 6, then 2 since phase
               8d),
               random f32 weights
               from --seed, through `Trainer` in a four-row gloo world on
               this card (`RankPool`; the wire is host loopback),
               AdamW steps of 2,048-token sequences:
               3 in decoupled mode (three compute rows and one reducer, 6
               sequences, the reducer folding each wave of 16 MiB gradient
               chunks with chunk_accumulate: launches checked, waves x
               steps), checkpointing at steps 2 and 3 into a temporary
               directory (row 0 reads step 3 back, bit for bit against the
               live state); a fresh trainer in overlap mode resuming from
               step 2 and taking step 3 (its loss against the decoupled
               run's step 3); then 2 steps each of the data-parallel
               conventional step and the ZeRO-1 overlap step on 8
               sequences (chunk_accumulate launched 0 times). Per run and step the loss and the
               slowest rank's time; per rank the phases, wire and staging
               bytes and seconds, peak device and host memory, moment bytes
               held, checkpoint bytes and seconds. Then the decoupled
               trainer under the adaptive loop (`TrainerConfig.adapt`,
               window 2, cooldown 1, threshold 1.05) for 4 steps from the
               same initial state, and step 5's loss by one forward on
               the parameters it leaves: its regroups, chunk_accumulate
               launches against the schedule (every compute row's
               gradient folded once a step, whatever the partition), its
               losses bit for bit the static decoupled run's up to the
               first regroup and within `OVERLAP_LOSS_REL` until an update
               on a new partition; after a regroup after step 3, step 4's
               and step 5's losses bit for bit those of a decoupled step
               built on the new partition from the state the static run's
               step 3 left (step 5's loss holds the update made there;
               its distance to the static run carried on by one step,
               another summation order, reported), the seconds of the
               steps on the new partition.
               Then one SGD step (lr 1) of each mode in the world held
               against the conventional step in one process in f32 (1e-4
               of the largest gradient).
8b. train_families — the MoE, VLM, hybrid and encoder-decoder families
               training at full width and cut depth in a two-row gloo
               world on this card (`RankPool`), one model at a
               time, random f32 weights from --seed, AdamW through
               `make_step` in place on the pipeline's batches (Zipf
               tokens, skewed lengths, the frontend's embeddings) laid
               out as `Trainer` lays them out, with the reference's
               default ``fsdp="auto"``: mixtral's and pixtral's runs shard
               (FSDP, their parts drawn unit by unit), hymba's and
               whisper's do not, and each line says which; decoupled mode with
               reduce_alpha 1/2 (one compute row holding the whole global
               batch, one reducer folding each step's single wave of
               16 MiB chunks with chunk_accumulate). (a) mixtral-8x7b, 1
               of 32 layers, f32 compute: 2 sequences of 1,536 tokens, 1
               overlap (ZeRO-1) step, one sequence a row (the second
               routing group of 1,024 tokens straddles the rows): its
               loss, aux_loss and router_entropy within 1e-5 relative
               (`MOE_ROUTING_REL`, TF32 off) of phase 8d (c)'s one process
               on the same weights and batch, checked there (8d (c)
               holds every updated element of its conventional and
               decoupled steps, and the next batch's loss after its
               overlap AdamW step, to one process); (b) pixtral-12b, 1 of 40 layers: 256
               patch embeddings before 1,024 text tokens, 1 decoupled
               step; (c) hymba-1.5b, 8 of 32 layers: 2,048-token
               sequences (past its 1,024 window), 1 decoupled step (its
               conventional step is phase 8d (d1)'s, held to
               one process there); (d) whisper-small whole: 1,500 frames
               and 256 decoder tokens, 1 decoupled and 1 overlap step
               (arms (b)-(d) took 2 steps a run until phase 8c came),
               then one step with runtime_skip=False against the default
               decoupled step (bit for bit on every row) and one with
               zero1=False against the ZeRO-1 step (`ZERO1_ATOL`), from the
               same weights. Every run: finite losses the rows agree on,
               chunk_accumulate launched once a decoupled step on the
               reducer and never elsewhere, per step the slowest rank's
               phases, per rank the wire and staging bytes and seconds,
               the FSDP gathers' and reduce-scatters' bytes and seconds,
               peak device memory (allocated and reserved), the host's
               peak and the moment bytes held.
8c. train_fsdp — qwen2.5-3b at full width and all 36 layers, f32 weights
               and compute, TF32 off. First, in this process alone, one
               conventional SGD step (lr 1) on the global batch (2
               sequences of 512 tokens) from the per-unit draw of --seed,
               its new parameters written to a temporary .npy, the card
               freed. Then a two-row gloo world on this card with the
               reference's default ``fsdp="auto"`` (it must resolve on):
               each row draws its parts unit by unit, takes the FSDP
               conventional step on its sequence, and compares every
               element of its parts with a memory map of the file (within
               `TRAIN_PARITY_REL` of the largest gradient element). The
               step's phases, the FSDP gathers' and reduce-scatters'
               bytes and seconds, and each rank's device peak (allocated
               and reserved); the two ranks' reserved peaks must sum to
               under the card's 80 GB, printed beside the replicated
               two-row figure (16 bytes a parameter a row: parameters,
               momentum, gradient and its flat copy for the all-reduce,
               98.7 GB). No kernel is on this path (the loss's
               attention is the reference's plain route, conventional
               mode folds nothing): its counts are read and reported.
8d. train_model — the model axis (tensor parallelism by hand, the
               reference's ``param_specs``) on a (data 2, model 2) gloo
               world of four ranks on this card, f32, TF32 off. (a)
               qwen2.5-3b whole, built for each rank's column
               (``build(tp=mesh)``), the reference's default step config,
               whose FSDP must resolve on at a model axis of 2 (12.34e9 B
               / 2 > 6e9): each rank draws each unit whole, keeps its
               column slice and its row's part of that, takes the
               conventional SGD step (lr 1) on its row's sequence, and
               compares every element with the slice of phase 8c's file
               that its spec and part name (`TRAIN_PARITY_REL`); the loss
               within 1e-5 of 8c's one process and equal on every rank;
               the four ranks' reserved peaks under 80 GB, printed beside
               8c's; per rank the data axis's gathers and reduce-scatters
               and the model axis's all-reduces (count, bytes, seconds).
               (b) qwen1.5-0.5b at phase 8's 2 layers, FSDP off: one SGD
               step each of the decoupled (one reducer row a column), the
               conventional and the overlap step on 2 sequences of 2,048,
               each against one process on rank 0 (`TRAIN_PARITY_REL`);
               chunk_accumulate once on each column's reducer in the
               decoupled step (waves x columns) and never elsewhere. (c)
               the MoE family: mixtral-8x7b at full width, 1 of 32
               layers, each column holding 4 of the 8 experts and the
               router's 4 columns of them. First one conventional SGD
               step (lr 1) in this process on phase 8b's batch (2
               sequences of 1,536 tokens; the second 1,024-token routing
               group straddles the rows), its new parameters to a file,
               the card freed, and one AdamW step (phase 8b's) with one
               forward of the next global batch after it; then on the
               world, each rank's column slices drawn unit by unit, the
               conventional SGD step under the default config (FSDP
               "auto" resolves off: 6.86e9 B / 2 < 6e9), the decoupled SGD
               step with fsdp=True (FSDP over each column's expert
               slices) and the overlap (ZeRO-1) AdamW step under the
               default config with the next batch's loss by one forward
               routed over the rows: every element of the SGD steps
               within `TRAIN_PARITY_REL` x max |gradient| of the file,
               loss, aux_loss and router_entropy within `MOE_ROUTING_REL`
               and equal on every rank, the next batch's loss within
               `OVERLAP_LOSS_REL`, chunk_accumulate once on each column's
               reducer in the decoupled step (which receives
               `MOE_AXIS_FOLD` values, the kernels phase's shape) and
               never elsewhere, the four ranks' reserved peaks under 80 GB
               beside phase 8b's two-row mixtral peaks; per rank the model
               axis's collectives and the data axis's gathers and
               reduce-scatters (count, bytes, seconds). (d) the SSM,
               hybrid and encoder-decoder families, each built for each
               rank's column and held to its own one-process SGD step on
               the same weights and global batch (a file a part, the card
               freed after each): (d1) hymba-1.5b at full width and phase
               8b's 8 layers, 2 x 2,048 tokens, the conventional step
               (FSDP "auto" resolves off; 25 / 5 heads take the gathered
               projections, a Mamba block's in_proj weight is gathered
               and its out_proj row-parallel, the 32,001-row tables
               whole); (d2) mamba2-130m whole, 2 x 1,024, the decoupled
               step (one reducer row a column) with fsdp=True, each
               column's reducer folding its 16 MiB chunks with
               chunk_accumulate once and receiving `SSM_AXIS_FOLD` values;
               (d3) whisper-small whole, 1,500 frames before 448 decoder
               tokens, the overlap (ZeRO-1) step: every element within
               `TRAIN_PARITY_REL` x max |gradient| of the file, the loss
               within 1e-5 relative of the one process's and equal on
               every rank, finite parameters, chunk_accumulate once on
               each reducer in (d2) and never elsewhere, the four ranks'
               reserved peaks under 80 GB. pixtral-12b's model-axis step
               is held on the CPU only (tests/test_torch_model_axis_
               families.py): its forward is the dense family's after
               prepended patch embeddings, which (a) and (b) run here.
9. mapreduce — the paper's word-count MapReduce (Sec. IV-B) in an
               eight-row gloo world on this card (`RankPool`;
               the wire is host loopback): 16,384 documents of 4,096 word
               slots (Zipf ids, skewed lengths, from --seed) over qwen's
               151,936-word vocabulary, 8,192-word (64 KiB) elements, run
               through `apps.mapreduce.run_wordcount` in the reference
               (8 map rows and one sum), decoupled (6 map rows, 2 reduce
               rows, 3 waves) and pipelined (5 map, 2 reduce, 1 io) modes;
               every reduce-side fold and every local map is the
               keyed-histogram kernel. Each run's histogram equals
               `np.bincount` of the valid words bit for bit on every row,
               the modes agree, and the kernel's launches, summed over
               ranks, equal the schedule's (`histogram_launches`); per run
               the slowest rank's wall time, per-rank phases (map/pack,
               stream+fold, group sum, broadcast), wire bytes, words per
               second and peak memory. Then the measured variant's
               counters against the host's per-row counts, the fold at
               its own shape on a reduce row, at 151,936 and at 32,000
               bins (the histogram's block path) (`fold_case`: the kernel
               against its plain version bit for bit, both timed beside
               `torch.bincount` and the bound), and the quickstart's
               workload statistics. Then `run_wordcount_adaptive` over
               2 balanced corpora (skew 0: every slot a word; 8,192
               documents of 4,096 slots, so that every bin stays under
               2^24; seeds --seed + t) from alpha0 1/2, the planner's own allocation for a
               balanced load at this size (fig12's check (a), the no-op
               hysteresis, at the paper's scale): no regroup, every
               superstep's histogram `np.bincount`'s bit for bit on every
               row, the kernel's launches the schedule's with the warmup
               superstep of `warmed_step` included; each superstep's wall
               and reason.
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
               seconds. Then `run_pic_adaptive` (fig12's check (b)):
               2^21 particles in 2^21-slot rows, skew 0.9, the current
               sheet from 0.25 drifting 0.12 a step with pull 2.0, dt
               0.1, 2 steps a superstep, 4 supersteps from alpha0 1/4:
               its regroups, every particle conserved at every superstep
               and across each in-memory migration
               (`launch.elastic.reshard_state`), each owned by its row on
               the final partition, each migration's seconds and bytes.
12. summary — a ``timing`` line, a ``{"kernels": [...]}`` line (the
               histogram's times are the fold's, the path's shape;
               ``launches_spec`` from phase 6c's run with the qwen1.5-0.5b
               draft; ``launches_disagg`` from phase 6d's adaptive fleet
               under faults; ``launches_moe`` from phase 7b's arm (b);
               ``launches_families`` from phase 7c's arms (a)-(c); the histogram's ``launches_adaptive`` from phase 9's
               adaptive run, and chunk_accumulate's
               ``launches_train_by_run`` with phase 8's adaptive run,
               ``launches_train_families`` from phase 8b's runs,
               ``launches_train_fsdp`` from phase 8c's world and
               ``launches_train_model`` from phase 8d's), then
               the last line ``{"ok": true, "device": {...}}``.

The worlds of phases 8-11 run on eight rank processes started once, in
the background, before phase 7b (`RankPool`: each world a fresh gloo
process group through the port's rank entry, `launch.mesh._rank_main`,
with no new process, torch import or CUDA context); phase 6d's world
goes through `launch.mesh.spawn` itself. The MapReduce corpora are made
in worker processes started at the same time (`start_corpora`).

Without a CUDA device, or without the repository beside it, the script
exits non-zero before printing any result. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import concurrent.futures
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import queue
import shutil
import statistics
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
# ... except at hymba-1.5b's widths (50 heads of 64 over a state of 16),
# held to 1e-4 of the largest |y| (and of the largest state element): with
# N = 16 the inputs' C.B has 8x the variance it has at N = 128, y reaches
# ~7, and f32's error scales with it. Measured on the card (NVIDIA H100
# 80GB HBM3, 700.00 W): 1.5e-4 at max |y| 7.24, i.e. 2.1e-5 of it, where
# mamba's widths give 6.0e-5 at 2.19 (2.7e-5); each f32 case also reports
# both sides' error against the recurrence in f64 (`ssd_f64`).
SSD_F32_SCALED = ("hymba-1.5b widths, model's dt",)
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


class PhaseClock:
    """Seconds since the current phase of `main` began: `emit` adds them to
    every phase line as ``seconds`` (a line that has its own keeps it), and
    `summary` gives every phase's total."""

    def __init__(self):
        self.name, self.t0, self.totals = None, None, {}

    def start(self, name: str) -> None:
        self.stop()
        self.name, self.t0 = name, time.perf_counter()

    def stop(self) -> None:
        if self.name is not None:
            self.totals[self.name] = time.perf_counter() - self.t0
            self.name = None

    def elapsed(self) -> float | None:
        return None if self.name is None else time.perf_counter() - self.t0


CLOCK = PhaseClock()


def emit(obj) -> None:
    if "phase" in obj and "seconds" not in obj and CLOCK.elapsed() is not None:
        obj = {**obj, "seconds": CLOCK.elapsed()}
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


# phase 7b's decode shapes: (case, query heads, KV heads, head dim, blocks
# per table, cursors, windows). mixtral-8x7b's 8 slots over 32/8 heads of
# 128 at its 8,192-position view (max_len 8,192), its 4,096 window biting
# the slots past it; llama4-scout's 2 slots over 40/8 (a group of 5) at
# 16,384 positions, its chunked-local 8,192 window and its global layer
MOE_PAGED = [("mixtral-8x7b decode", 32, 8, 128, 512,
              (5_900, 4_097, 2_047, 8_000, 1_000, 300, 6_000, 64), (4096,)),
             ("llama4-scout decode", 40, 8, 128, 1024, (14_000, 9_000), (8192, 0))]


def check_paged_moe(torch, np, seed: int) -> list:
    """The MoE decode shapes: f32 at PAGED_F32_ATOL, then bf16 at PAGED_REL
    with kernel, plain and bound times (4 pool copies against L2)."""
    from repro_torch.kernels.paged_attention import ops

    cases = []
    for name, h, n_kv, hd, mb, cursors, windows in MOE_PAGED:
        for window in windows:
            shape = dict(h=h, n_kv=n_kv, hd=hd, mb=mb, cursors=cursors)
            args, kw, _, _ = paged_case(torch, np, quantized=False, window=window, seed=seed,
                                        dtype=torch.float32, **shape)
            out = ops.paged_decode_attention(**args, **kw)
            ref = ops.paged_decode_attention(**args, **kw, impl="ref",
                                             dequant_dtype=torch.float32)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            case = {"phase": "kernels", "kernel": "paged_decode_attention", "case": name,
                    "heads": [h, n_kv, hd], "cursors": list(cursors), "q": "f32", "pool": "f32",
                    "window": window, "max_abs_err": err, "atol": PAGED_F32_ATOL,
                    "finite": bool(torch.isfinite(out).all().item())}
            emit(case)
            if not case["finite"] or not err <= PAGED_F32_ATOL:
                raise AssertionError(f"paged decode kernel disagrees at {name}: {case}")
            del args, out, ref
            args, kw, nbytes, flops = paged_case(torch, np, quantized=False, window=window,
                                                 seed=seed, dtype=torch.bfloat16, **shape)
            out = ops.paged_decode_attention(**args, **kw)
            ref = ops.paged_decode_attention(**args, **kw, impl="ref",
                                             dequant_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            rel = slot_rel_err(out, ref)
            finite = bool(torch.isfinite(out).all().item())
            copies = [dict(args, k_blocks=args["k_blocks"].clone(),
                           v_blocks=args["v_blocks"].clone()) for _ in range(4)]
            kern = [lambda a=a: ops.paged_decode_attention(**a, **kw) for a in copies]
            plain = [lambda a=a: ops.paged_decode_attention(
                **a, **kw, impl="ref", dequant_dtype=torch.bfloat16) for a in copies]
            b_ms, b_by = bound_ms(nbytes, flops)
            case = {"phase": "kernels", "kernel": "paged_decode_attention", "case": name,
                    "heads": [h, n_kv, hd], "cursors": list(cursors), "q": "bf16",
                    "pool": "bf16", "window": window,
                    "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                    "max_slot_rel_err": rel, "rel_budget": PAGED_REL, "finite": finite,
                    "kernel_ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain, 20),
                    "kernel_device_ms": device_ms(torch, kern),
                    "plain_device_ms": device_ms(torch, plain),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            emit(case)
            if not finite or not rel <= PAGED_REL:
                raise AssertionError(f"paged decode kernel disagrees at {name}: {case}")
            cases.append(case)
            del copies, kern, plain, args, out, ref
            torch.cuda.empty_cache()
    return cases


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
    cases += check_paged_moe(torch, np, seed)
    main = cases[0]  # bf16 pool, full layers: the main path's case
    return {"name": "paged_decode_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": PAGED_TPU, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["kernel_device_ms"], "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "library_device_ms": None}


# argmax at the shapes the serve arms launch, on the last position of
# (B, S, V) bf16 logits: each arm's decode tick (S = 1), the speculative
# path's verify targets and draft steps (phase 6c), and an admission's
# prefill row (S = 1024, rows strided by S x V). (case, B, S, V)
ARGMAX_CASES = [("tinyllama-1.1b decode", 8, 1, 32_000),
                ("qwen2.5-3b long-arm decode", 2, 1, 151_936),
                ("qwen2.5-3b spec verify targets (4 slots x (k + 1))", 20, 1, 151_936),
                ("spec draft step (4 slots)", 4, 1, 151_936),
                ("mamba2-130m decode", 8, 1, 50_280),
                ("tinyllama-1.1b admission", 1, 1024, 32_000),
                ("qwen2.5-3b admission", 1, 1024, 151_936),
                # phase 7b: llama4-scout's 202,048 vocabulary, its 2-slot
                # decode tick and an admission row (mixtral's 32,000 is
                # tinyllama's shape above)
                ("llama4-scout decode", 2, 1, 202_048),
                ("llama4-scout admission", 1, 1024, 202_048),
                # phase 7c: the decode ticks of its 8-row arms over
                # hymba-1.5b's and whisper-small's odd vocabularies (rows
                # not 16-byte aligned) and pixtral-12b's 4-slot image ticks
                ("hymba-1.5b decode", 8, 1, 32_001),
                ("whisper-small decode", 8, 1, 51_865),
                ("pixtral-12b image decode", 4, 1, 131_072)]


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
    # phase 6c: the qwen1.5-0.5b draft's batch-1 prefill (MHA, group 1) at
    # its 16-token bucket, and the target's packed short-bucket prefill
    ("qwen1.5-0.5b spec draft prefill", 1, 16, 16, 16, 64, 0, False, 20),
    ("qwen2.5-3b packed short-bucket prefill", 4, 128, 16, 2, 128, 0, False, 20),
    # phase 7b: mixtral-8x7b's packed prefill (32/8 heads, window 4,096),
    # llama4-scout's 40/8 heads (a group of 5) past its chunked-local
    # 8,192 window and on its global layer
    ("mixtral-8x7b packed prefill, window 4096", 8, 1024, 32, 8, 128, 4096, False, 20),
    ("llama4-scout, window 8192", 1, 12_000, 40, 8, 128, 8192, True, 3),
    ("llama4-scout global layer", 1, 12_000, 40, 8, 128, 0, True, 3),
    # phase 7c: hymba-1.5b's 25/5 heads of 64 past its 1,024-token window
    ("hymba-1.5b, window 1024", 1, 8192, 25, 5, 64, 1024, False, 5),
]
# non-causal flash at phase 7c's whisper-small shapes (12/12 heads of 64
# over its 1,500 encoder frames, no multiple of the tiles): name, batch,
# query length, key length, query heads, KV heads, head dim, iterations
FLASH_NONCAUSAL_CASES = [
    ("whisper-small encoder self-attention", 8, 1500, 1500, 12, 12, 64, 20),
    ("whisper-small cross-attention, 16-token prompt", 8, 16, 1500, 12, 12, 64, 20),
]
# the llama4-scout shape in f32 (TF32 off), held whole at FLASH_F32_ATOL
MOE_FLASH_F32 = dict(b=1, s=12_000, h=40, n_kv=8, hd=128)


def flash_inputs(torch, *, b, s, h, n_kv, hd, dtype, seed, sk=None):
    """Model-layout (B, S, H, d) q and (B, Sk, Kv, d) k, v (Sk = S unless
    given), N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sk = s if sk is None else sk

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return randn(b, s, h, hd), randn(b, sk, n_kv, hd), randn(b, sk, n_kv, hd)


def flash_plain(torch, ops, q, k, v, window: int, by_group: bool, causal: bool = True):
    """The plain version (`impl="ref"`), whole or one batch row and KV
    group at a time."""
    if not by_group:
        return ops.mha(q, k, v, causal=causal, window=window, impl="ref")
    n_kv = k.shape[2]
    rep = q.shape[2] // n_kv
    return torch.cat([torch.cat([ops.mha(q[i:i + 1, :, g * rep:(g + 1) * rep],
                                         k[i:i + 1, :, g:g + 1], v[i:i + 1, :, g:g + 1],
                                         causal=causal, window=window, impl="ref")
                                 for g in range(n_kv)], dim=2)
                      for i in range(q.shape[0])])


def live_pairs(np, sq: int, sk: int, window: int, causal: bool = True) -> int:
    """Live (query, key) pairs, start-aligned: every pair when not causal,
    else the causal (and windowed) ones."""
    if not causal:
        return sq * sk
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


# phase 7c's shapes in f32: (name, batch, query length, key length, query
# heads, KV heads, head dim, window, causal)
FAMILY_FLASH_F32 = [
    ("whisper-small encoder", 2, 1500, 1500, 12, 12, 64, 0, False),
    ("whisper-small cross-attention", 2, 16, 1500, 12, 12, 64, 0, False),
    ("hymba-1.5b, window 1024", 1, 4096, 4096, 25, 5, 64, 1024, True),
]


def check_flash_f32(torch, np, seed: int) -> None:
    """The kernel's logic at f32 precision: S=1000 (not a multiple of the
    64-row and 64-key tiles), windows 0 and 256, groups of 8 (hd 64 and
    hd 128: qwen2.5-3b, the f32 spec parity run's target and draft), 12
    (hd 128) and 1 (hd 64: the qwen1.5-0.5b draft's MHA); phase 7c's
    non-causal whisper shapes and hymba's group of 5."""
    from repro_torch.kernels.flash_attention import ops

    geometries = [(f"S=1000, {h}/{n_kv} x {hd}", 2, 1000, 1000, h, n_kv, hd, window, True)
                  for h, n_kv, hd in ((32, 4, 64), (48, 4, 128), (16, 2, 128), (16, 16, 64))
                  for window in (0, 256)]
    for name, b, sq, sk, h, n_kv, hd, window, causal in geometries + FAMILY_FLASH_F32:
        q, k, v = flash_inputs(torch, b=b, s=sq, sk=sk, h=h, n_kv=n_kv, hd=hd,
                               dtype=torch.float32, seed=seed)
        out = ops.mha(q, k, v, causal=causal, window=window)
        ref = ops.mha(q, k, v, causal=causal, window=window, impl="ref")
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        case = {"phase": "kernels", "kernel": "flash_attention", "dtype": "f32", "case": name,
                "shape": [b, sq, sk, h, n_kv, hd], "window": window, "causal": causal,
                "max_abs_err": err, "atol": FLASH_F32_ATOL,
                "finite": bool(torch.isfinite(out).all().item())}
        emit(case)
        if not case["finite"] or not err <= FLASH_F32_ATOL:
            raise AssertionError(f"flash kernel disagrees with its plain version: {case}")
        del q, k, v, out, ref
    for window in (8192, 0):
        q, k, v = flash_inputs(torch, **MOE_FLASH_F32, dtype=torch.float32, seed=seed)
        out = ops.mha(q, k, v, window=window)
        ref = flash_plain(torch, ops, q, k, v, window, by_group=True)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        case = {"phase": "kernels", "kernel": "flash_attention", "dtype": "f32",
                "case": "llama4-scout", "shape": [1, 12_000, 40, 8, 128], "window": window,
                "max_abs_err": err, "atol": FLASH_F32_ATOL,
                "finite": bool(torch.isfinite(out).all().item())}
        emit(case)
        if not case["finite"] or not err <= FLASH_F32_ATOL:
            raise AssertionError(f"flash kernel disagrees with its plain version: {case}")
        del q, k, v, out, ref
        torch.cuda.empty_cache()


def flash_case(torch, np, *, name: str, b: int, sq: int, sk: int, h: int, n_kv: int,
               hd: int, window: int, causal: bool, by_group: bool, iters: int,
               seed: int) -> dict:
    """One bf16 shape: the kernel against its plain version (`FLASH_REL`),
    both timed, the bound, and SDPA where one call computes the same
    function (no window). Returns the emitted case line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    q, k, v = flash_inputs(torch, b=b, s=sq, sk=sk, h=h, n_kv=n_kv, hd=hd,
                           dtype=torch.bfloat16, seed=seed)
    out = ops.mha(q, k, v, causal=causal, window=window)
    ref = flash_plain(torch, ops, q, k, v, window, by_group, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    finite = bool(torch.isfinite(out).all().item())
    del out, ref
    torch.cuda.empty_cache()
    pairs = live_pairs(np, sq, sk, window, causal)
    flops = 4.0 * b * h * hd * pairs
    b_ms, b_by = bound_ms((2 * b * sq * h * hd + 2 * b * sk * n_kv * hd) * 2, flops)
    kern = [lambda: ops.mha(q, k, v, causal=causal, window=window)]
    case = {"phase": "kernels", "kernel": "flash_attention", "case": name, "dtype": "bf16",
            "shape": [b, sq, h, n_kv, hd] if sq == sk else [b, sq, sk, h, n_kv, hd],
            "causal": causal, "window": window, "live_pairs": pairs,
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
        plain = [lambda: ops.mha(q, k, v, causal=causal, window=window, impl="ref")]
        case.update(plain_ms=cuda_ms(torch, plain, iters, warmup=1),
                    plain_device_ms=device_ms(torch, plain, iters))
    if window == 0:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = [lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
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
    del q, k, v, kern
    torch.cuda.empty_cache()
    return case


def check_flash(torch, np, seed: int) -> dict:
    check_flash_f32(torch, np, seed)
    cases = [flash_case(torch, np, name=name, b=b, sq=s, sk=s, h=h, n_kv=n_kv, hd=hd,
                        window=window, causal=True, by_group=by_group, iters=iters, seed=seed)
             for name, b, s, h, n_kv, hd, window, by_group, iters in FLASH_CASES]
    cases += [flash_case(torch, np, name=name, b=b, sq=sq, sk=sk, h=h, n_kv=n_kv, hd=hd,
                         window=0, causal=False, by_group=False, iters=iters, seed=seed)
              for name, b, sq, sk, h, n_kv, hd, iters in FLASH_NONCAUSAL_CASES]
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


def ssd_f64(torch, x, dt, A, Bm, Cm):
    """The SSD recurrence position by position in f64 (h <- exp(dt A) h +
    dt x B^T, y = h C), which the chunked form equals exactly: -> (y,
    final state)."""
    b, s, h, p = x.shape
    st = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].double()
        st = (torch.exp(dtt * A.double())[..., None, None] * st
              + torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, t].double(), Bm[:, t].double()))
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, t].double()))
    return torch.stack(ys, 1), st


def ssd_work(*, b, s, h, p, n, q, elem) -> tuple[float, float]:
    """(bytes, flops) of one scan: x, B, C, dt and A read once, y and the
    final state written once; the chunked form's operations, C B^T once
    per (batch row, chunk) and 2 Q^2 P + 4 Q P N per head and chunk."""
    nc = -(-s // q)
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * elem + (b * s * h + h + b * h * p * n) * 4
    flops = b * nc * (2.0 * q * q * n + h * (2.0 * q * q * p + 4.0 * q * p * n))
    return nbytes, flops


# the scan at mamba2-130m's widths (24 heads of 64, state 128) and at
# hymba-1.5b's (50 heads of 64, state 16): (case, sequence length, timing
# iterations, heads, head dim, state)
SSD_CASES = [("the mamba arm's shortest prompts", 2048, 40, 24, 64, 128),
             ("mamba2-130m prefill, 8192 tokens", 8192, 20, 24, 64, 128),
             ("the mamba arm's largest prompt", 16000, 10, 24, 64, 128),
             ("hymba-1.5b prefill, 8192 tokens", 8192, 20, 50, 64, 16)]
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

    q = 256
    # f32: the kernel's logic at S=1000 (three whole chunks and a ragged
    # tail): the reference test's dt, the model's dt, and A = -16, dt ~ 1,
    # where the masked exponent differences reach +4,000 (exp overflows);
    # then the model's dt at hymba-1.5b's widths
    s_f32 = 1000
    for name, (h, p, n), kw in (
            ("model's dt", (24, 64, 128), {}),
            ("reference test's dt", (24, 64, 128), dict(dt_range=(0.01, 0.2))),
            ("A=-16, dt~1", (24, 64, 128), dict(a=16.0, dt_range=(0.9, 1.1))),
            ("hymba-1.5b widths, model's dt", (50, 64, 16), {})):
        args = ssd_inputs(torch, b=1, s=s_f32, h=h, p=p, n=n, dtype=torch.float32, seed=seed,
                          **kw)
        y, fin = ops.ssd(*args, chunk=q)
        ry, rfin = ops.ssd(*args, chunk=q, impl="ref")
        y64, fin64 = ssd_f64(torch, *args)
        torch.cuda.synchronize()
        err, state_err = (y - ry).abs().max().item(), (fin - rfin).abs().max().item()
        y_max, state_max = ry.abs().max().item(), rfin.abs().max().item()
        scaled = name in SSD_F32_SCALED
        case = {"phase": "kernels", "kernel": "ssd_scan", "dtype": "f32", "inputs": name,
                "shape": [1, s_f32, h, p, n, q], "max_abs_err": err,
                "state_max_abs_err": state_err, "y_max_abs": y_max, "state_max_abs": state_max,
                "kernel_vs_f64": (y.double() - y64).abs().max().item(),
                "plain_vs_f64": (ry.double() - y64).abs().max().item(),
                "state_kernel_vs_f64": (fin.double() - fin64).abs().max().item(),
                "state_plain_vs_f64": (rfin.double() - fin64).abs().max().item(),
                "atol": SSD_F32_ATOL, "atol_scaled_by_max_abs": scaled,
                "finite": bool(torch.isfinite(y).all() and torch.isfinite(fin).all())}
        emit(case)
        y_tol = SSD_F32_ATOL * (max(1.0, y_max) if scaled else 1.0)
        state_tol = SSD_F32_ATOL * (max(1.0, state_max) if scaled else 1.0)
        if not case["finite"] or not (err <= y_tol and state_err <= state_tol):
            raise AssertionError(f"SSD kernel disagrees with its plain version: {case}")
    cases = []
    for name, s_len, iters, h, p, n in SSD_CASES:
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
    main = cases[1]  # the mamba arm's 8,192-token prefill
    return {"name": "ssd_scan", "route": "cuda", "source": SSD_SRC, "replaces": SSD_TPU,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["kernel_device_ms"], "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "library_device_ms": None}


# the stream channel's call at the train phases' widths: the reducer folds
# phase 8's qwen1.5-0.5b (2 layers) 181,283,840 f32 gradients, packed into
# 44 wire chunks of 16 MiB (184,549,376 values), and in phase 8d (c) each
# column's reducer folds its column of mixtral-8x7b (1 layer), packed into
# 205 chunks (`MOE_AXIS_FOLD`, which 8d (c) holds its reducers' received
# bytes to), and in phase 8d (d2) its column of mamba2-130m, packed into 16
# chunks (`SSM_AXIS_FOLD`), each wave staged below its accumulator and summed back into
# the accumulator's row (``out=``); then a ragged S, and n > 2 in f32 and
# bf16. (case, n, S, dtype, timing iterations, into the first row)
MOE_AXIS_FOLD = 859_832_320
# the f32 values each column's reducer receives in phase 8d (d2): a column
# of mamba2-130m (64,519,776 elements) packed into 16 wire chunks of 16 MiB
SSM_AXIS_FOLD = 67_108_864
ACC_CASES = [("train fold: accumulator + one wave, in place", 2, 184_549_376, "f32", 10, True),
             ("phase 8d (c) mixtral-8x7b column fold, in place", 2, MOE_AXIS_FOLD, "f32", 3,
              True),
             ("phase 8d (d2) mamba2-130m column fold, in place", 2, SSM_AXIS_FOLD,
              "f32", 10, True),
             ("ragged S", 2, 1_000_003, "f32", 20, False),
             ("7 rows", 7, 2_500_000, "f32", 20, False),
             ("16 rows, bf16 input", 16, 4_194_304, "bf16", 20, False)]


def check_accumulate(torch, np, seed: int) -> dict:
    from repro_torch.kernels.stream_reduce import ops

    cases = []
    for name, n, s, dt, iters, inplace in ACC_CASES:
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(seed + n)
        x = torch.randn((n, s), generator=gen, device="cuda").to(dtype)
        # the plain version and the scale first: an in-place call overwrites row 0
        ref = ops.accumulate(x, impl="ref")
        scale = x.float().abs().sum(0).max().item()
        exact = not (n == 2 and dt == "f32") or bool(torch.equal(ref, x[0] + x[1]))
        out = ops.accumulate(x, out=x[0]) if inplace else ops.accumulate(x)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        exact = exact and bool(torch.equal(out, ref))
        nbytes = n * s * x.element_size() + s * 4
        b_ms, b_by = bound_ms(nbytes, float((n - 1) * s), F32_FLOPS)
        kern = [lambda: ops.accumulate(x, out=x[0])] if inplace else [lambda: ops.accumulate(x)]
        plain = [lambda: ops.accumulate(x, impl="ref")]
        lib = [lambda: torch.sum(x, 0, dtype=torch.float32)]
        case = {"phase": "kernels", "kernel": "chunk_accumulate", "case": name,
                "shape": [n, s], "dtype": dt, "into_row_0": inplace, "max_abs_err": err,
                "bit_identical": exact,
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


def zipf_bins(torch, n: int, bins: int, s: float, gen):
    """``n`` Zipf(``s``) word ids folded into ``bins`` (id mod bins), drawn
    on the card by inverse CDF: bin b holds the ids b, b + bins, b +
    2 bins, ..., so its mass is bins^-s times the Hurwitz zeta(s, b / bins)
    (bin 0 holds the multiples of bins: zeta(s, 1)), as numpy's
    ``zipf(s) % bins`` draws them on the host."""
    q = torch.arange(bins, dtype=torch.float64, device="cuda") / bins
    q[0] = 1.0
    cdf = torch.cumsum(torch.special.zeta(torch.full_like(q, s), q), 0)
    cdf /= cdf[-1].item()
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=bins - 1).to(torch.int32)


def histogram_inputs(torch, seed: int, edges=None):
    """The histogram cases, one at a time, as (name, keys, counts, bins,
    exact, timing iterations) on the card: 2^26 keys into qwen's 151,936
    bins, Zipf(1.3) word ids (5 % padding, `zipf_bins`) with counts of 1,
    the same keys through a seeded permutation of the bins (hot keys no
    longer small ids), uniform keys with counts of 1 and with bf16 counts;
    4,096 bins; then 2^24 uniform keys (some past the last bin) at each of
    ``edges`` bins (default: one on each side of the plan's path boundary,
    what one block's shared memory holds). Each case's tensors are freed
    once the next is asked for."""
    from repro_torch.kernels.stream_reduce.stream_reduce import CTA_BINS

    n, bins = 1 << 26, 151_936
    zgen = torch.Generator(device="cuda").manual_seed(seed + 7)
    zipf = zipf_bins(torch, n, bins, 1.3, zgen)
    pad = torch.rand(n, generator=zgen, device="cuda") < 0.05
    zipf[pad] = -1
    perm = torch.randperm(bins, generator=zgen, device="cuda").to(torch.int32)
    permuted = torch.where(pad, -1, perm[zipf.clamp(min=0).long()])
    del pad, perm
    ones = torch.ones(n, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    uniform = torch.randint(-1, bins, (n,), generator=gen, device="cuda", dtype=torch.int32)
    yield "2^26 zipf keys", zipf, ones, bins, True, 10
    del zipf
    yield "2^26 zipf keys, permuted bins", permuted, ones, bins, True, 10
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


def check_histogram(torch, seed: int) -> dict:
    """Every case of `histogram_inputs` through `histogram_case`."""
    from repro_torch.kernels.stream_reduce import ops
    from repro_torch.kernels.stream_reduce.stream_reduce import CTA_BINS, histogram_plan

    if histogram_plan(CTA_BINS)[0] == histogram_plan(CTA_BINS + 1)[0]:
        raise AssertionError(f"the plan's path boundary moved from {CTA_BINS} bins")
    cases = [histogram_case(torch, ops, name, keys, counts, bins, exact=exact, iters=iters)
             for name, keys, counts, bins, exact, iters in histogram_inputs(torch, seed)]
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


def zero_counters() -> dict:
    """Every kernel wrapper of the port, its launch count set to 0."""
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    return counters


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
              max_len: int = 2048, budget: tuple | None = None, tape=None) -> dict:
    """Drain ``reqs`` through `make_engine` (continuous batching over
    ``kv``) with every kernel count set to 0 just before and read just
    after. Times each prefill call and each tick on the host clock, ended
    by `torch.cuda.synchronize()`, and each request's first token. Holds
    the first decode tick's logits against the plain path (inside the
    run; its time is taken out of the run's times) and, after the run,
    the first prefill call's last-position logits against the plain
    route. ``budget``: (decode, prefill) logit budgets as fractions of the
    plain logits' largest magnitude; by default the model's absolute
    `LOGIT_BUDGET` and `PREFILL_BUDGET`. An MoE model passes its
    `RouteTape` (installed over `moe.route`): each plain check then takes
    the kernel call's expert choices, and the line reports the share of
    routed tokens whose own choice differs (``*_route_differ_share``)."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel as fk
    from repro_torch.kernels.paged_attention import paged_decode_attention_kernel as pk
    from repro_torch.serve import EngineConfig, make_engine

    cfg = model.cfg
    relative = budget is not None
    decode_budget, budget = budget or (LOGIT_BUDGET[cfg.name], PREFILL_BUDGET[cfg.name])
    first, first_prefill, prefill_ms, prefill_rows = {}, {}, [], []
    check_s = 0.0  # host time of the check inside the run, left out of its times

    def decode_and_check(params_, pview, token, *, impl=None):
        nonlocal check_s
        if tape is not None and not first:
            tape.record()
        out = model.decode_step_paged(params_, pview, token, impl=impl)
        if not first:  # hold the first decode tick against the plain path
            torch.cuda.synchronize()
            ts = time.perf_counter()
            launches = pk.launches
            if tape is not None:
                tape.replay(tape.stop())
            ref = model.decode_step_paged(params_, pview, token, impl="ref")
            if tape is not None:
                tape.stop()
                first.update(decode_route_differ_share=tape.share())
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
        if tape is not None and not first_prefill:
            tape.record()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = model.prefill(params_, tokens, cache, length, impl=impl)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - ts) * 1e3)
        prefill_rows.append(list(tokens.shape))
        if not first_prefill:  # kept for the check after the run
            first_prefill.update(tokens=tokens, length=length, logits=out[0][:, -1].clone(),
                                 routes=tape.stop() if tape is not None else None)
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
    counters = zero_counters()
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
    torch.cuda.synchronize()
    ts = time.perf_counter()
    if tape is not None:
        tape.replay(first_prefill["routes"])
    ref, _ = model.prefill(params, first_prefill["tokens"], None, first_prefill["length"],
                           impl="ref")
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - ts) * 1e3
    if fk.launches != flash_n:
        raise AssertionError("the plain prefill route launched the flash kernel")
    got, want = first_prefill["logits"].float(), ref[:, -1].float()
    best = want.max(-1).values
    picked = want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
    route_check = {}
    if tape is not None:
        tape.stop()
        route_check = {"prefill_route_differ_share": tape.share(),
                       "prefill_routed_tokens": tape.tokens}
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
    del ref, first_prefill["tokens"], first_prefill["routes"]
    ref_max = {"decode": first.get("logit_ref_max_abs", 0.0) if relative else 1.0,
               "prefill": prefill_check["prefill_logit_ref_max_abs"] if relative else 1.0}

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
           "peak_mem_gib": peak_gib, "logit_budget": decode_budget,
           "budget_relative_to_max_logit": relative, **first, **prefill_check, **route_check,
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
    if argmax_n != decode_ticks + engine.stats["prefills"]:
        raise AssertionError(f"{arm}: argmax kernel ran {argmax_n} times, want "
                             f"{decode_ticks} ticks + {engine.stats['prefills']} admissions")
    if not first.get("logit_max_abs_err", math.inf) <= decode_budget * ref_max["decode"]:
        raise AssertionError(f"{arm}: first decode tick off the plain path: {first}")
    if not prefill_check["prefill_logit_max_abs_err"] <= budget * ref_max["prefill"]:
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

    out = {"phase": "profile", "model": model.cfg.name, "mode": mode, "ticks": ticks,
           "batch": len(prompt_lens), "context_tokens": list(prompt_lens),
           **profile_window(torch, run_ticks, ticks)}
    emit(out)
    return out


def profile_window(torch, run_ticks, ticks: int) -> dict:
    """``run_ticks()`` (wall ms per tick of ``ticks`` ticks, ended by a
    synchronisation) once on the host clock, then once more under
    `torch.profiler`: the wall time per tick without and with the profiler,
    the device time per tick, the device's idle share of the unprofiled
    tick, device time by kernel class and the top kernels, and the
    profiled window's seconds with the trace's reading. It records device
    activity alone: nothing reads the host's operator events, which made
    most of a long trace's reading time. A profiler that sees no device
    activity leaves the device numbers as None ("not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = run_ticks()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    return {"wall_ms_per_tick": wall_ms, "profiled_wall_ms_per_tick": profiled_wall_ms,
            "profile_s": time.perf_counter() - t0,
            "device_ms_per_tick": dev_ms,
            "idle_share": None if dev_ms is None else 1.0 - dev_ms / wall_ms,
            "device_launches_per_tick": sum(n for _, n, _ in kernels),
            "device_ms_per_tick_by_class": classes if kernels else None,
            "top_kernels": [{"ms_per_tick": ms, "launches_per_tick": n, "name": name}
                            for ms, n, name in kernels[:10]]}


# -- phase 6b: traffic scenarios through the serving example -----------------

SCENARIO = "bursty-prefix"
# phase 6b replays `SCENARIO` cut to its first 40 arrival ticks (68 of its
# 145 requests, the three tenants and the rag surge kept), twice (traced,
# untraced): the whole 56-tick scenario took ~12 s a replay on the card
SCENARIO_HORIZON = 40
FIFO_SCENARIO = "single-fifo"


def cut_scenario(horizon: int, base: str = SCENARIO) -> str:
    """Register scenario ``base`` cut to its first ``horizon`` arrival ticks
    in the port's scenario table, under its own name, and return the name."""
    from repro_torch.serve import traffic

    name = f"{base}-{horizon}"
    traffic.SCENARIOS[name] = lambda: dataclasses.replace(
        traffic.scenario(base), name=name, horizon=horizon)
    return name


class DequeShim:
    """The submit-order admission path written apart from the port's
    scheduler, as the reference's FIFO test writes it
    (`tests/test_fleet.py`, `_DequeShim`): the bit-identity reference for
    `FleetScheduler.fifo()`."""

    def __init__(self):
        self.q = collections.deque()

    def submit(self, req, now=0):
        self.q.append(req)
        return True

    def take(self, now, max_n=None, inflight_tokens=0):
        out = []
        while self.q and (max_n is None or len(out) < max_n):
            out.append(self.q.popleft())
        return out

    def pending(self):
        return len(self.q)

    def slo(self, tenant):
        from repro_torch.serve.traffic import SLOClass

        return SLOClass()


def tracer_emit_ms(events, repeats: int = 21) -> float:
    """Host ms to make again, through the tracer's own methods on a fresh
    tracer, the calls that recorded ``events`` (a traced run's buffer):
    the median of ``repeats`` passes. The tracer's host cost of that run,
    measured apart from the run's own tick-to-tick spread."""
    from repro_torch.obs.trace import REQUESTS_PROCESS, Tracer

    def calls(t):
        for ev in events:
            ph, track, args = ev["ph"], ev["track"], dict(ev.get("args", {}))
            if track[0] == REQUESTS_PROCESS and ph in ("B", "E"):
                uid = int(track[1][3:])
                yield (t.request_begin if ph == "B" else t.request_end), (uid,), args
            elif ph == "X" and ev["dur"] == 0 and "uid" in args:
                uid = args.pop("uid")
                yield t.request_mark, (uid, ev["name"], track), args
            elif ph == "B":
                yield t.begin, (ev["name"], track), args
            elif ph == "E":
                yield t.end, (track,), args
            elif ph == "C":
                yield t.counter, (ev["name"], args, track), {}
            elif ph == "i":
                yield t.instant, (ev["name"], track), args
            # s/t/f: made by request_begin/request_mark/request_end

    times = []
    for _ in range(repeats):
        t = Tracer()
        todo = list(calls(t))
        ts = time.perf_counter()
        for fn, a, kw in todo:
            fn(*a, **kw)
        times.append((time.perf_counter() - ts) * 1e3)
        if len(t.events) != len(events):
            raise AssertionError(f"tracer re-emit made {len(t.events)} events, "
                                 f"not {len(events)}")
    return statistics.median(times)


def scenario_replay(torch, model, params, *, trace: str | None) -> dict:
    """One replay of `SCENARIO` cut to `SCENARIO_HORIZON` arrival ticks
    through `examples.serve_lm.serve` (the paged engine under the
    multi-tenant scheduler, the example's settings), with every kernel
    count set to 0 just before and read just
    after. A per-tick hook hashes each decode tick's logits on the host
    (so no logits are held) and its host time is left out of the run's
    time; prefill calls are counted through the model."""
    import hashlib

    from repro_torch.examples import serve_lm

    calls = []

    def counted_prefill(*a, **kw):
        calls.append(1)
        return model.prefill(*a, **kw)

    hashes, hook_s, tick_ms, last = [], 0.0, [], None

    def on_tick(engine):
        nonlocal hook_s, last
        ts = time.perf_counter()
        if last is not None:  # the tick between the previous hook's end and now
            tick_ms.append((ts - last) * 1e3)
        logits = engine.last_logits if engine.last_tick["decode_batch"] else None
        hashes.append(None if logits is None else hashlib.sha256(
            logits.contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest())
        last = time.perf_counter()
        hook_s += last - ts

    counters = kernel_counters()
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    out = serve_lm.serve(dataclasses.replace(model, prefill=counted_prefill), params,
                         scenario_name=cut_scenario(SCENARIO_HORIZON), paged=True, trace=trace,
                         on_tick=on_tick)
    launches = {name: k.launches for name, k in counters.items()}
    eng = out["engine"]
    wall = out["seconds"] - hook_s
    return {"out": out, "engine": eng, "launches": launches, "prefill_calls": len(calls),
            "decode_ticks": sum(h is not None for h in hashes), "hashes": hashes,
            "wall_s": wall, "hook_s": hook_s, "ms_per_tick": wall * 1e3 / eng.tick,
            "median_tick_ms": statistics.median(tick_ms),
            "streams": {r.uid: (tuple(r.out_tokens), r.first_token_tick, r.done_tick)
                        for r in eng.finished},
            "ledger": eng.ledger.snapshot()}


def scenario_phase(torch, np, model, params, smi: str) -> dict:
    """Phase 6b: the serving user's path, `python -m
    repro_torch.examples.serve_lm --scenario bursty-prefix --paged --trace
    PATH`, through the example's own `serve` at qwen2.5-3b's full width and
    depth. (1) The replay with the tracer on: a valid Chrome trace, one
    closed lifecycle per accepted request, the registry's counts against
    the engine's, and the launch counts. (2) The same replay with the
    tracer off: identical streams, ticks and ledger, and every decode
    tick's logits bit for bit (a hash per tick). (3) `single-fifo` through
    two aligned engines in lockstep, one under `FleetScheduler.fifo()` and
    one under `DequeShim`: every decode tick's logits bit for bit, the same
    streams."""
    import tempfile

    from repro_torch.obs.export import validate_chrome_trace
    from repro_torch.serve import EngineConfig, make_engine
    from repro_torch.serve.traffic import scenario

    cfg = model.cfg
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scenario_trace.json")
        on = scenario_replay(torch, model, params, trace=path)
        with open(path) as fh:
            obj = json.load(fh)
    errors = validate_chrome_trace(obj)
    eng = on["engine"]
    tr = on["out"]["trace"]
    life, metrics = tr["lifecycle"], on["out"]["metrics"]
    requests = on["out"]["requests"]
    accepted = requests - eng.sched.rejected
    snap = on["ledger"]
    n = on["launches"]
    emit_ms = tracer_emit_ms(list(tr["tracer"].events))
    line = {"phase": "scenario", "run": "traced", "scenario": SCENARIO,
            "horizon": SCENARIO_HORIZON, "model": cfg.name,
            "nvidia_smi": smi, "requests": requests, "accepted": accepted,
            "ticks": eng.tick, "decode_ticks": on["decode_ticks"],
            "prefill_calls": on["prefill_calls"], "cold_admissions": eng.stats["prefills"],
            "tokens_out": eng.stats["tokens_out"],
            "prompt_tokens": int(sum(r.prompt.shape[0] for r in eng.finished)),
            "wall_s": on["wall_s"], "tokens_per_s": eng.stats["tokens_out"] / on["wall_s"],
            "ms_per_tick": on["ms_per_tick"], "median_tick_ms": on["median_tick_ms"],
            "hook_s": on["hook_s"],
            "prefix_hit_tokens": eng.stats["prefix_hit_tokens"],
            "prefill_skips": eng.stats["prefill_skips"],
            "ttft_p50": snap["ttft_p50"], "ttft_p99": snap["ttft_p99"],
            "latency_p99": snap["latency_p99"], "good_tokens": snap["good_tokens"],
            "by_tenant": snap["by_tenant"], "trace_events": tr["events"],
            "trace_bytes": tr["bytes"], "trace_dropped": tr["dropped"], "lifecycle": life,
            "tracer_emit_ms": emit_ms, "tracer_emit_ms_per_tick": emit_ms / eng.tick,
            "trace_errors": errors[:5], "launches": n,
            "registry": {k: metrics.get(k) for k in ("sched.submitted", "sched.admitted",
                                                     "serve.completions", "serve.tokens_out",
                                                     "serve.good_tokens")}}
    emit(line)
    if errors:
        raise AssertionError(f"scenario: invalid Chrome trace: {errors[:5]}")
    if not (life["begins"] == life["ends"] == accepted) or life["open"] \
            or life["double_begins"] or life["double_ends"]:
        raise AssertionError(f"scenario: lifecycle {life} against {accepted} accepted")
    if len(eng.finished) != accepted or any(len(r.out_tokens) != r.max_new_tokens
                                           for r in eng.finished):
        raise AssertionError("scenario: not every accepted request finished with its tokens")
    if (metrics.get("sched.submitted"), metrics.get("serve.completions"),
            metrics.get("serve.tokens_out")) != (accepted, len(eng.finished),
                                                  eng.stats["tokens_out"]):
        raise AssertionError(f"scenario: registry {line['registry']} against the engine's")
    if n["paged_decode_attention"] != cfg.n_layers * on["decode_ticks"]:
        raise AssertionError(f"scenario: paged kernel ran {n['paged_decode_attention']} "
                             f"times, want {cfg.n_layers} x {on['decode_ticks']} ticks")
    if not on["prefill_calls"] or n["flash_attention"] != cfg.n_layers * on["prefill_calls"]:
        raise AssertionError(f"scenario: flash kernel ran {n['flash_attention']} times, want "
                             f"{cfg.n_layers} x {on['prefill_calls']} prefill calls")
    if n["argmax_last"] < on["decode_ticks"] + eng.stats["prefills"]:
        raise AssertionError(f"scenario: argmax kernel ran {n['argmax_last']} times, want >= "
                             f"{on['decode_ticks']} ticks + {eng.stats['prefills']} admissions")
    if eng.last_logits is None or not bool(torch.isfinite(eng.last_logits).all()):
        raise AssertionError("scenario: non-finite logits")
    del on["out"], on["engine"], eng
    gc.collect()

    off = scenario_replay(torch, model, params, trace=None)
    same = {k: off[k] == on[k] for k in ("streams", "ledger", "hashes")}
    emit({"phase": "scenario", "run": "untraced", "ticks": off["engine"].tick,
          "decode_ticks": off["decode_ticks"], "wall_s": off["wall_s"],
          "tokens_per_s": off["engine"].stats["tokens_out"] / off["wall_s"],
          "ms_per_tick": off["ms_per_tick"], "median_tick_ms": off["median_tick_ms"],
          "tracer_host_ms_per_tick": on["ms_per_tick"] - off["ms_per_tick"],
          "tracer_host_median_ms_per_tick": on["median_tick_ms"] - off["median_tick_ms"],
          "identical_to_traced": same, "launches": off["launches"]})
    if not all(same.values()):
        raise AssertionError(f"scenario: tracing changed the run: {same}")
    del off["out"], off["engine"]
    gc.collect()

    # single-fifo: the FIFO scheduler against the bare deque, in lockstep
    sc = scenario(FIFO_SCENARIO)
    ecfg = EngineConfig(max_batch=4, max_len=160)
    a = make_engine(model, params, ecfg)
    b = make_engine(model, params, ecfg, sched=DequeShim())
    for _, r in sc.requests(cfg.vocab_size):
        a.submit(dataclasses.replace(r, out_tokens=[]))
        b.submit(dataclasses.replace(r, out_tokens=[]))
    ticks, compared = 0, 0
    t0 = time.perf_counter()
    while not a.idle():
        a.step()
        b.step()
        ticks += 1
        if ticks > 500:
            raise AssertionError("single-fifo: the engines did not drain")
        if a.last_tick["decode_batch"]:
            if not torch.equal(a.last_logits, b.last_logits):
                raise AssertionError(f"single-fifo: logits differ at tick {a.tick}")
            compared += 1
    fifo_s = time.perf_counter() - t0
    streams = [[r.out_tokens for r in e.finished] for e in (a, b)]
    fifo = {"phase": "scenario", "run": FIFO_SCENARIO, "requests": len(a.finished),
            "ticks": ticks, "decode_ticks_compared": compared, "wall_s": fifo_s,
            "deque_idle": b.idle(), "streams_identical": streams[0] == streams[1]}
    emit(fifo)
    if not b.idle() or streams[0] != streams[1] or len(a.finished) != len(sc.generate()):
        raise AssertionError(f"single-fifo: the FIFO scheduler differs from the deque: {fifo}")
    return {"launches": line["launches"], "traced": line, "fifo": fifo}


# -- phase 6c: speculative decoding ---------------------------------------------

SPEC_K = 4
# the draft of the parity and speed runs: the target's weights plus
# SPEC_EPS * N(0, 1) per float leaf (fig17's acceptance dial), chosen so
# that acceptance lies between SPEC_ACCEPT_BAND's ends in f32 (the sweep of
# scripts/torch_spec_eps.py; PERF.md §6)
SPEC_EPS = 3e-4
SPEC_ACCEPT_BAND = (0.3, 0.95)
# greedy spec against target-only, f32 with TF32 off: the verify attends a
# dense view with plain attention, target-only decode runs the paged
# kernel, and both keep K/V in bf16, so a K/V row can round one bf16 ulp
# apart between the routes. Every stream must equal target-only up to the
# first step whose target-only top-2 logit margin is under SPEC_MARGIN
# (the prefill's margin counts for the first step)
SPEC_MARGIN = 1e-3
# fig17's parity settings: every rollback meets a partial block
SPEC_PARITY = dict(max_batch=4, max_len=96, block_size=8, n_req=12, new_tokens=14)
SPEC_PROFILE_TICKS = 4
SPEC_DRAFT = "qwen1.5-0.5b"  # the reference's pair for qwen2.5-3b
# the multi-tenant spec replay: `SCENARIO`'s traffic cut to its first 24
# arrival ticks (25 requests of its 145: chat, rag and background, shared
# prefixes), registered under its own name for `serve_lm.serve`
SPEC_SCENARIO = "bursty-prefix-24"
SPEC_SCENARIO_HORIZON = 24


def noised_params(torch, params, eps: float, seed: int, dtype=None):
    """A draft: every float leaf of ``params`` plus ``eps`` * N(0, 1) drawn
    in f32 on the leaf's device from ``seed``, cast to ``dtype`` (the
    leaf's own by default)."""
    gen = None

    def walk(t):
        nonlocal gen
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if gen is None:
            gen = torch.Generator(device=t.device).manual_seed(seed)
        noise = torch.randn(t.shape, generator=gen, dtype=torch.float32, device=t.device)
        out = (t.float() + eps * noise).to(dtype or t.dtype)
        del noise
        return out

    return walk(params)


def spec_requests(np, vocab: int, *, n_req: int, new_tokens: int, seed: int) -> list:
    """fig17's traffic: prompts of 4-15 tokens, ``new_tokens`` each."""
    from repro_torch.serve import Request

    rng = np.random.RandomState(seed)
    return [Request(uid=u, prompt=rng.randint(1, vocab, rng.randint(4, 16)).astype(np.int32),
                    max_new_tokens=new_tokens) for u in range(n_req)]


def top2_margins(torch, rows) -> list:
    """Top-1 minus top-2 of each (V,) row of ``rows`` (n, V), on the host."""
    top = rows.float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def target_only_margins(torch, model, params, reqs: list, kv, *, max_batch: int,
                        max_len: int) -> dict:
    """The target-only continuous engine over ``reqs``: its streams, and per
    uid the top-2 logit margin of every emitted token (decode step ``s``
    gives token ``s``; the prefill's margin is kept at -1, since it picks
    the first fed token)."""
    from repro_torch.serve import EngineConfig, make_engine

    margins = {r.uid: {} for r in reqs}
    by_prompt = {r.prompt.tobytes(): r.uid for r in reqs}
    holder = {}

    def decode(params_, pview, token, *, impl=None):
        out = model.decode_step_paged(params_, pview, token, impl=impl)
        eng = holder["engine"]
        live = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
        got = top2_margins(torch, out[0][[i for i, _ in live], -1])
        for (_, r), m in zip(live, got):
            margins[r.uid][len(r.out_tokens)] = m
        return out

    eng = make_engine(dataclasses.replace(model, decode_step_paged=decode), params,
                      EngineConfig(mode="continuous", max_batch=max_batch, max_len=max_len,
                                   kv=kv))
    holder["engine"] = eng
    run_batch = eng._prefill.run_batch

    def prefill(prompts):
        logits, batch = run_batch(prompts)
        for p, m in zip(prompts, top2_margins(torch, logits[:, -1])):
            margins[by_prompt[p.tobytes()]][-1] = m
        return logits, batch

    eng._prefill.run_batch = prefill
    for r in reqs:
        eng.submit(dataclasses.replace(r, out_tokens=[]))
    eng.drain()
    return {"streams": {r.uid: list(r.out_tokens) for r in eng.finished},
            "margins": margins, "ticks": eng.tick}


def margin_rule(spec_streams: dict, base: dict) -> dict:
    """Hold each spec stream to the target-only one up to its first step with
    a top-2 margin under `SPEC_MARGIN`; raises on a mismatch before it.
    Returns uid -> the step the rule cut the stream at (-1: the prefill)."""
    cut = {}
    for uid, want in base["streams"].items():
        low = sorted(s for s, m in base["margins"][uid].items() if m < SPEC_MARGIN)
        upto = len(want) if not low else max(low[0], 0)
        got = spec_streams.get(uid)
        if got is None or len(got) != len(want) or got[:upto] != want[:upto]:
            raise AssertionError(f"spec: uid {uid} stream {got} != target-only {want} "
                                 f"before step {upto} (margins {base['margins'][uid]})")
        if low:
            cut[uid] = low[0]
    return cut


def check_spec_stores(eng) -> int:
    """A spec engine's stores after a tick: the draft store's lengths equal
    the target store's for every live slot; in a paged store (both) the
    slots' block references equal the live-token block demand, and the
    private blocks in use equal it too, or, once prefix-cache hits let
    slots share blocks, do not exceed it. Returns 1 when the blocks were
    checked."""
    live = [i for i, r in enumerate(eng.slots) if r is not None]
    if [int(eng.draft_kv.lens[i]) for i in live] != [int(eng.kv.lens[i]) for i in live]:
        raise AssertionError(f"spec: draft lens {eng.draft_kv.lens} != target lens "
                             f"{eng.kv.lens} at tick {eng.tick}")
    if eng.kv.kind != "paged":
        return 0
    for store in (eng.kv, eng.draft_kv):
        st = store.stats
        private = st["blocks_in_use"] - st["evictable_blocks"]
        shared = st.get("prefix_hits", 0) > 0
        if st["ref_total"] - st["prefix_ref_total"] != st["live_block_demand"] or \
                private > st["live_block_demand"] or \
                (not shared and private != st["live_block_demand"]):
            raise AssertionError(f"spec: block accounting off at tick {eng.tick}: {st}")
    return 1


def check_spec_drained(eng) -> None:
    """No private block in use in either store of a drained spec engine."""
    leaked = [st.stats.get("blocks_in_use", 0) - st.stats.get("evictable_blocks", 0)
              for st in (eng.kv, eng.draft_kv)]
    if any(leaked):
        raise AssertionError(f"spec: blocks in use after the drain: {leaked}")


def spec_engine_run(torch, np, model, params, draft, reqs: list, kv, *, max_batch: int,
                    max_len: int, spec_mode: str = "greedy", seed: int = 0) -> dict:
    """Drain ``reqs`` through `make_engine(..., SpecConfig(...), draft=)` with
    every kernel count set to 0 just before and read just after. Checks at
    every tick: the draft store's lengths equal the target store's for
    every live slot, and in a paged store the private blocks in use equal
    the live-token block demand (both stores); after the drain no block is
    in use. Counts the target's and the draft's prefill calls."""
    from repro_torch.serve import SpecConfig, make_engine

    calls = {"target": 0, "draft": 0}

    def counted(m, who):
        def prefill(*a, **kw):
            calls[who] += 1
            return m.prefill(*a, **kw)
        return dataclasses.replace(m, prefill=prefill)

    dmodel, dparams = draft
    eng = make_engine(counted(model, "target"), params,
                      SpecConfig(max_batch=max_batch, max_len=max_len, kv=kv, spec_k=SPEC_K,
                                 spec_mode=spec_mode, seed=seed),
                      draft=(counted(dmodel, "draft"), dparams))
    counters = kernel_counters()
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    for r in reqs:
        eng.submit(dataclasses.replace(r, out_tokens=[]))
    blocks_checked = 0
    while not eng.idle():
        eng.step()
        blocks_checked += check_spec_stores(eng)
        if eng.tick > 1000:
            raise AssertionError("spec: the engine did not drain")
    launches = {name: k.launches for name, k in counters.items()}
    check_spec_drained(eng)
    return {"engine": eng, "streams": {r.uid: list(r.out_tokens) for r in eng.finished},
            "launches": launches, "prefill_calls": calls, "blocks_checked": blocks_checked,
            "acceptance": eng.stats["accepted"] / max(1, eng.stats["drafted"])}


def check_spec_launches(name: str, run: dict, target_layers: int, draft_layers: int) -> dict:
    """argmax = target admissions + draft steps + verify calls; flash =
    layers x prefill calls of each model; the paged kernel never."""
    st, n, calls = run["engine"].stats, run["launches"], run["prefill_calls"]
    want = {"argmax_last": st["prefills"] + st["draft_steps"] + st["verify_calls"],
            "flash_attention": target_layers * calls["target"] + draft_layers * calls["draft"],
            "paged_decode_attention": 0}
    got = {k: n[k] for k in want}
    if got != want or not calls["target"] or not calls["draft"]:
        raise AssertionError(f"spec {name}: launches {got}, want {want} "
                             f"(prefill calls {calls})")
    return want


def spec_parity(torch, np, cfg, seed: int, smi: str) -> dict:
    """Phase 6c (a) and (c): qwen2.5-3b at full width and depth in f32 (TF32
    off) from ``seed``, the draft its copy noised by `SPEC_EPS`; fig17's
    settings over the dense store and the paged store. The margin rule
    against the target-only engine, the store checks, exact launch counts;
    then sampled mode: seed 3 twice (identical streams), seed 4 (different)."""
    from repro_torch.models.model_zoo import build
    from repro_torch.serve import KVSpec

    s = SPEC_PARITY
    model = build(dataclasses.replace(cfg, dtype=torch.float32))
    params = model.init(seed)
    draft = (model, noised_params(torch, params, SPEC_EPS, seed + 100))
    reqs = spec_requests(np, cfg.vocab_size, n_req=s["n_req"], new_tokens=s["new_tokens"],
                         seed=seed)
    geo = dict(max_batch=s["max_batch"], max_len=s["max_len"])
    paged = KVSpec(kind="paged", block_size=s["block_size"])
    t0 = time.perf_counter()
    base = target_only_margins(torch, model, params, reqs, paged, **geo)
    base_s = time.perf_counter() - t0
    runs, lines = {}, []
    for store, kv in (("dense", KVSpec()), ("paged", paged)):
        t0 = time.perf_counter()
        run = spec_engine_run(torch, np, model, params, draft, reqs, kv, **geo)
        wall = time.perf_counter() - t0
        cut = margin_rule(run["streams"], base)
        want = check_spec_launches(store, run, cfg.n_layers, cfg.n_layers)
        st = run["engine"].stats
        line = {"phase": "spec", "run": f"parity {store}", "model": cfg.name, "dtype": "f32",
                "nvidia_smi": smi, "eps": SPEC_EPS, "spec_k": SPEC_K, **geo,
                "block_size": s["block_size"] if store == "paged" else None,
                "requests": len(reqs), "ticks": run["engine"].tick,
                "target_only_ticks": base["ticks"], "acceptance": run["acceptance"],
                "tokens_per_verify": st["tokens_out"] / st["verify_calls"],
                **{k: st[k] for k in ("accepted", "drafted", "verify_calls", "draft_steps",
                                      "prefills")},
                "identical_streams": sum(run["streams"][u] == base["streams"][u]
                                         for u in base["streams"]),
                "cut_by_margin_rule": cut, "spec_margin": SPEC_MARGIN,
                "min_target_only_margin": min(min(m.values()) for m in base["margins"].values()),
                "blocks_checked_ticks": run["blocks_checked"], "launches": run["launches"],
                "launches_expected": want, "prefill_calls": run["prefill_calls"],
                "wall_s": wall, "target_only_wall_s": base_s}
        emit(line)
        lines.append(line)
        lo, hi = SPEC_ACCEPT_BAND
        if not lo <= run["acceptance"] <= hi:
            raise AssertionError(f"spec parity {store}: acceptance {run['acceptance']} at eps "
                                 f"{SPEC_EPS} outside {SPEC_ACCEPT_BAND}")
        runs[store] = run
    del runs
    gc.collect()
    sampled = {}
    for sd in (3, 3, 4):
        run = spec_engine_run(torch, np, model, params, draft, reqs[:4], KVSpec(), **geo,
                              spec_mode="sampled", seed=sd)
        if any(len(v) != s["new_tokens"] for v in run["streams"].values()):
            raise AssertionError("spec sampled: a request ended short")
        sampled.setdefault(sd, []).append(run["streams"])
    replay = sampled[3][0] == sampled[3][1]
    differs = sampled[3][0] != sampled[4][0]
    emit({"phase": "spec", "run": "sampled", "dtype": "f32", "requests": 4, "seeds": [3, 3, 4],
          "replays": replay, "differs_across_seeds": differs})
    if not (replay and differs):
        raise AssertionError(f"spec sampled: replay {replay}, differs across seeds {differs}")
    del model, params, draft
    gc.collect()
    torch.cuda.empty_cache()
    return {"parity": lines}


class _SpecTimers:
    """Component times of speculative ticks, each call ended by
    `torch.cuda.synchronize()` (it starts after one too), while ``on``:
    the draft's decode steps (catch-up steps included), the verify
    forwards, and per tick the rollback (the target store's `absorb_span`
    and both stores' `truncate` calls, patched on the store class while
    the window lasts)."""

    def __init__(self, torch):
        self.torch = torch
        self.on = False
        self.ms = {"draft_step": [], "verify": [], "rollback": []}
        self._rollback = 0.0
        self._saved = []

    def timed(self, fn, key):
        torch = self.torch

        def call(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if key == "rollback":
                self._rollback += ms
            else:
                self.ms[key].append(ms)
            return out
        return call

    def patch_stores(self, cls):
        for name in ("absorb_span", "truncate"):
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self.timed(fn, "rollback"))

    def restore(self):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self._saved = []

    def end_tick(self, verified: bool):
        if verified:
            self.ms["rollback"].append(self._rollback)
        self._rollback = 0.0

    def summary(self) -> dict:
        return {f"{k}_ms": {"mean": statistics.fmean(v), "median": statistics.median(v),
                            "n": len(v)} if v else None for k, v in self.ms.items()}


def spec_speed_run(torch, np, model, params, draft, *, name: str, spec: bool = True) -> dict:
    """One run of `examples.serve_lm.serve` at the example's settings (4
    slots, max_len 160, the paged store with 16-token blocks and the prefix
    cache), speculative with ``draft`` (k = 4) or target-only, with every
    kernel count set to 0 just before and read just after. Times each tick
    on the host clock (a hook's own time left out) with no synchronisation
    added, so spec and target-only are timed alike; peak device memory.
    The component times come from `spec_window`."""
    from repro_torch.examples import serve_lm

    calls = {"target": 0, "draft": 0}

    def counted(m, who):
        def prefill(*a, **kw):
            calls[who] += 1
            return m.prefill(*a, **kw)
        return dataclasses.replace(m, prefill=prefill)

    tick_ms, hook_s, last = [], 0.0, None

    def on_tick(engine):
        nonlocal hook_s, last
        ts = time.perf_counter()
        if last is not None:
            tick_ms.append((ts - last) * 1e3)
        last = time.perf_counter()
        hook_s += last - ts

    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    out = serve_lm.serve(counted(model, "target"), params, paged=True, on_tick=on_tick,
                         spec=spec, spec_k=SPEC_K,
                         draft=(counted(draft[0], "draft"), draft[1]) if spec else None)
    launches = {k: c.launches for k, c in counters.items()}
    eng = out["engine"]
    wall = out["seconds"] - hook_s
    st = eng.stats
    line = {"phase": "spec", "run": name, "scenario": "legacy",
            "model": model.cfg.name, "draft": draft[0].cfg.name if spec else None,
            "requests": out["requests"], "ticks": eng.tick, "tokens_out": st["tokens_out"],
            "wall_s": wall, "tokens_per_s": st["tokens_out"] / wall,
            "ms_per_tick": wall * 1e3 / eng.tick,
            "median_tick_ms": statistics.median(tick_ms) if tick_ms else None,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "prefill_calls": calls}
    if spec:
        line.update(acceptance=eng.ledger.acceptance_rate(),
                    tokens_per_verify=st["tokens_out"] / max(1, st["verify_calls"]),
                    **{k: st[k] for k in ("accepted", "drafted", "verify_calls", "draft_steps",
                                          "prefills")})
    emit(line)
    if len(eng.finished) != out["requests"] - eng.sched.rejected or \
            any(len(r.out_tokens) != r.max_new_tokens for r in eng.finished):
        raise AssertionError(f"spec {name}: not every request finished with its tokens")
    if spec:
        check_spec_launches(name, {"engine": eng, "launches": launches, "prefill_calls": calls},
                            model.cfg.n_layers, draft[0].cfg.n_layers)
    if eng.last_logits is None or not bool(torch.isfinite(eng.last_logits).all()):
        raise AssertionError(f"spec {name}: non-finite logits")
    line["streams"] = {r.uid: list(r.out_tokens) for r in eng.finished}
    return line


def spec_scenario_run(torch, model, params, draft) -> dict:
    """`SPEC_SCENARIO` through `examples.serve_lm.serve(scenario_name=...,
    spec=True)` with ``draft``: the multi-tenant `FleetScheduler` feeds the
    `SpecEngine` (paged store, prefix cache shared across tenants), every
    kernel count set to 0 just before and read just after. Checks the
    stores after every tick (`check_spec_stores`) and after the drain,
    every admitted request finished with its tokens, prefix-cache hits,
    finite logits, and the launches (`check_spec_launches`)."""
    from repro_torch.examples import serve_lm
    from repro_torch.serve import traffic

    cut_scenario(SPEC_SCENARIO_HORIZON)
    calls = {"target": 0, "draft": 0}

    def counted(m, who):
        def prefill(*a, **kw):
            calls[who] += 1
            return m.prefill(*a, **kw)
        return dataclasses.replace(m, prefill=prefill)

    checked = []

    def on_tick(engine):
        checked.append(check_spec_stores(engine))

    counters = kernel_counters()
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    out = serve_lm.serve(counted(model, "target"), params, scenario_name=SPEC_SCENARIO,
                         paged=True, on_tick=on_tick, spec=True, spec_k=SPEC_K,
                         draft=(counted(draft[0], "draft"), draft[1]))
    launches = {k: c.launches for k, c in counters.items()}
    eng = out["engine"]
    st = eng.stats
    line = {"phase": "spec", "run": "spec bursty-prefix, noised target draft",
            "scenario": SPEC_SCENARIO, "horizon": SPEC_SCENARIO_HORIZON,
            "model": model.cfg.name, "requests": out["requests"],
            "rejected": eng.sched.rejected, "ticks": eng.tick, "ticks_checked": sum(checked),
            "tokens_out": st["tokens_out"], "wall_s": out["seconds"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "acceptance": eng.ledger.acceptance_rate(), "launches": launches,
            "prefill_calls": calls,
            **{k: st[k] for k in ("accepted", "drafted", "verify_calls", "draft_steps")}}
    emit(line)
    check_spec_drained(eng)
    if len(eng.finished) != out["requests"] - eng.sched.rejected or not eng.finished or \
            any(len(r.out_tokens) != r.max_new_tokens for r in eng.finished):
        raise AssertionError(f"spec {SPEC_SCENARIO}: not every request finished with its tokens")
    if len(checked) != eng.tick or not all(checked):
        raise AssertionError(f"spec {SPEC_SCENARIO}: {sum(checked)} of {eng.tick} ticks checked")
    if st["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"spec {SPEC_SCENARIO}: no prefix-cache hit")
    if eng.last_logits is None or not bool(torch.isfinite(eng.last_logits).all()):
        raise AssertionError(f"spec {SPEC_SCENARIO}: non-finite logits")
    check_spec_launches(SPEC_SCENARIO, {"engine": eng, "launches": launches,
                                        "prefill_calls": calls},
                        model.cfg.n_layers, draft[0].cfg.n_layers)
    return line


def spec_window(torch, np, model, params, draft, *, seed: int, profile: bool) -> dict:
    """Where a speculative tick's time goes, at a fixed load: a fresh
    `SpecEngine` at the example's settings with 4 slots of 16-token
    prompts, after its admission tick, `SPEC_PROFILE_TICKS` ticks on the
    host clock (and, with ``profile``, as many under `torch.profiler`:
    `profile_window`), then as many with every
    draft step, verify forward and rollback timed (`_SpecTimers`)."""
    from repro_torch.serve import KVSpec, Request, SpecConfig, make_engine
    from repro_torch.serve.kvstore import PagedKVStore

    timers = _SpecTimers(torch)
    target = dataclasses.replace(model, verify_step=timers.timed(model.verify_step, "verify"))
    dmodel = dataclasses.replace(draft[0],
                                 decode_step=timers.timed(draft[0].decode_step, "draft_step"))
    eng = make_engine(target, params, SpecConfig(
        max_batch=4, max_len=160, kv=KVSpec(kind="paged", block_size=16, prefix_cache=True),
        spec_k=SPEC_K), draft=(dmodel, draft[1]))
    rng = np.random.default_rng(seed)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(0, model.cfg.vocab_size, 16)
                           .astype(np.int32), max_new_tokens=120))
    eng.step()
    ticks = SPEC_PROFILE_TICKS

    def run_ticks() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / ticks

    out = {"phase": "spec", "run": "window", "draft": draft[0].cfg.name, "ticks": ticks}
    if profile:
        out.update(profile_window(torch, run_ticks, ticks))
    else:
        out["wall_ms_per_tick"] = run_ticks()
    st0 = dict(eng.stats)
    timers.on = True
    timers.patch_stores(PagedKVStore)
    try:
        for _ in range(ticks):
            eng.step()
            timers.end_tick(bool(eng.last_tick.get("verify")))
    finally:
        timers.restore()
        timers.on = False
    st = eng.stats
    out.update(timers.summary(),
               timed_acceptance=(st["accepted"] - st0["accepted"])
               / max(1, st["drafted"] - st0["drafted"]),
               live_slots_after=sum(r is not None for r in eng.slots))
    emit(out)
    return out


def spec_phase(torch, np, model, params, smi: str, seed: int) -> dict:
    """Phase 6c: speculative decoding on qwen2.5-3b at full width and depth.
    (a) and (c) in f32 (`spec_parity`); (b) the speed runs in bf16 on
    ``params`` through `examples.serve_lm.serve`: the reference's pair (a
    full-width qwen1.5-0.5b draft with random bf16 weights from ``seed`` +
    1) and the noised bf16 target, each beside the target-only engine on
    the example's requests (their streams reported, not checked: bf16);
    the first ticks of `bursty-prefix` with the noised draft through the
    multi-tenant scheduler (`spec_scenario_run`); a window of spec ticks at
    a fixed load for the pair, profiled. Returns the launches
    of the reference pair's run, the user's ``serve_lm --spec --paged``."""
    from repro_torch.configs import get
    from repro_torch.models.model_zoo import build

    cfg = model.cfg
    part_s, t0 = {}, time.perf_counter()
    parity = spec_parity(torch, np, cfg, seed, smi)
    part_s["parity_and_sampled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = build(get(SPEC_DRAFT))
    pair = (small, small.init(seed + 1))
    noised = (model, noised_params(torch, params, SPEC_EPS, seed + 100))
    base = spec_speed_run(torch, np, model, params, None, name="target-only legacy",
                          spec=False)
    runs = {}
    for name, draft in (("spec legacy, qwen1.5-0.5b draft", pair),
                        ("spec legacy, noised target draft", noised)):
        runs[name] = spec_speed_run(torch, np, model, params, draft, name=name)
        same = sum(runs[name]["streams"].get(u) == v for u, v in base["streams"].items())
        emit({"phase": "spec", "run": name, "streams_equal_target_only": same,
              "of": len(base["streams"]),
              "speed_vs_target_only": runs[name]["tokens_per_s"] / base["tokens_per_s"]})
    part_s["legacy_speed_runs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec_scenario_run(torch, model, params, noised)
    part_s["bursty_prefix_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    windows = [spec_window(torch, np, model, params, pair, seed=seed + 9, profile=True)]
    part_s["windows"] = time.perf_counter() - t0
    emit({"phase": "spec", "run": "phase seconds", **part_s})
    main_run = runs["spec legacy, qwen1.5-0.5b draft"]
    del pair, noised, small
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": main_run["launches"], "parity": parity, "windows": windows}


# -- phase 6d: disaggregated serving and the serving fleet ---------------------------

# (a) the aligned handoff against the colocated engine, qwen2.5-3b in f32
DISAGG_PARITY = dict(n_req=4, lo=64, hi=512, new_tokens=16, max_len=1024)
# (b) the serving example's adaptive fleet under faults: `bursty-multitenant`
# cut to its first 44 of 56 arrival ticks (for the smoke's time since phase
# 8c: 75 requests drained in 123 ticks on the CPU dry run, against 145 in
# 257 whole, the same faults, recoveries, regrow and replans), the rag surge
# at tick 28; the ticks are picked from the scenario's load (the CPU dry run
# keeps every decode slot live from tick 23 on, whatever walls the planner
# sees, with a queue of 9-21 requests at 32-36)
FLEET_BASE = "bursty-multitenant"
FLEET_HORIZON = 44
FLEET_PREEMPT_AT = 32
FLEET_FAIL_AT = 36
# (c) checkpoint recovery: phase 6c's 12 requests through a 4-row fleet
# (1 prefill row, 6 decode slots), a snapshot every 4 ticks, a device loss on
# the tick after the snapshot at tick 8
CKPT_FLEET = dict(mode="continuous", n_rows=4, prefill_rows=1, slots_per_row=2, max_len=96,
                  prefill_chunk=16, min_rows=2, recovery="checkpoint", ckpt_cadence=4)
CKPT_BLOCK = 8
CKPT_SNAPSHOT_TICK = 8
# (d) the SPMD step in a four-row world: tinyllama-1.1b (bf16), 2 prefill rows
# and 2 decode rows, 2 slots a row, 4 ticks; 4 MiB stream elements
SPMD_ARCH = "tinyllama-1.1b"
SPMD_ROWS = 4
SPMD_ALPHA = 0.5
SPMD = dict(slots_per_row=2, max_prompt=512, max_len=640, chunk_elems=1 << 20, decode_steps=2)
SPMD_TICKS = 4


def disagg_requests(np, vocab: int, *, n_req: int, lo: int, hi: int, new_tokens: int,
                    seed: int) -> list:
    """Prompts of ``lo``-``hi`` tokens, ``new_tokens`` each."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=u, prompt=rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
                    .astype(np.int32), max_new_tokens=new_tokens) for u in range(n_req)]


def disagg_aligned_parity(torch, np, model, params, reqs: list, *, max_len: int) -> dict:
    """(a): `DisaggEngine` (aligned, dense store, one prefill row per request,
    as many decode slots) against the colocated aligned `Engine` on the same
    requests, ticked in lockstep: every decode tick's logits `torch.equal`,
    the streams and the slot caches equal. Should the card break bit
    identity, the largest difference is reported and every stream is held to
    the colocated one up to its first step with a top-2 margin under
    `SPEC_MARGIN` (`margin_rule`; the prefill's margin counts for step 0)."""
    from repro_torch.serve import DisaggConfig, EngineConfig, make_engine

    margins = {r.uid: {} for r in reqs}
    by_prompt = {r.prompt.tobytes(): r.uid for r in reqs}
    holder = {}

    def decode(params_, cache, token):
        out = model.decode_step(params_, cache, token)
        live = [(i, r) for i, r in enumerate(holder["eng"].slots) if r is not None]
        got = top2_margins(torch, out[0][[i for i, _ in live], -1])
        for (_, r), m in zip(live, got):
            margins[r.uid][len(r.out_tokens)] = m
        return out

    def prefill(params_, tokens, cache=None, length=None, *, impl=None):
        out = model.prefill(params_, tokens, cache, length, impl=impl)
        n = int(length) if length is not None else tokens.shape[1]
        uid = by_prompt[tokens[0, :n].to(torch.int32).cpu().numpy().tobytes()]
        margins[uid][-1] = top2_margins(torch, out[0][:, -1])[0]
        return out

    n = len(reqs)
    eng = make_engine(dataclasses.replace(model, decode_step=decode, prefill=prefill), params,
                      EngineConfig(max_batch=n, max_len=max_len))
    holder["eng"] = eng
    dis = make_engine(model, params, DisaggConfig(n_prefill_rows=n, decode_slots=n,
                                                  max_len=max_len))
    for r in reqs:
        eng.submit(dataclasses.replace(r, out_tokens=[]))
        dis.submit(dataclasses.replace(r, out_tokens=[]))
    ticks, equal_ticks, max_diff = 0, 0, 0.0
    while not (eng.idle() and dis.idle()):
        eng.step()
        dis.step()
        ticks += 1
        if eng.last_tick["decode_batch"]:
            a, b = eng.last_logits, dis.last_logits
            if torch.equal(a, b):
                equal_ticks += 1
            else:
                max_diff = max(max_diff, (a.float() - b.float()).abs().max().item())
        if ticks > 1000:
            raise AssertionError("disagg parity: the engines did not drain")
    decode_ticks = dis.stats["steps"]
    streams = {r.uid: list(r.out_tokens) for r in eng.finished}
    dstreams = {r.uid: list(r.out_tokens) for r in dis.finished}
    caches = all(torch.equal(eng.cache[k], dis.cache[k]) for k in ("k", "v"))
    identical = equal_ticks == decode_ticks and max_diff == 0.0 and streams == dstreams \
        and caches
    out = {"ticks": ticks, "decode_ticks": decode_ticks, "bit_identical_ticks": equal_ticks,
           "logit_max_abs_diff": max_diff, "streams_equal": streams == dstreams,
           "caches_equal": caches, "bit_identical": identical,
           "handoffs": dis.stats["handoffs"],
           "min_colocated_margin": min(min(m.values()) for m in margins.values())}
    if not identical:
        out["cut_by_margin_rule"] = margin_rule(dstreams, {"streams": streams,
                                                           "margins": margins})
    if len(dstreams) != len(reqs) or eng.tick != dis.tick:
        raise AssertionError(f"disagg parity: {len(dstreams)} of {len(reqs)} finished, "
                             f"ticks {eng.tick} / {dis.tick}")
    return out


def check_fleet_blocks(fe) -> int:
    """A paged fleet's store after a tick: the slots' block references equal
    the live block demand, and the private blocks in use do not exceed it
    (prefix-cache hits share blocks). Returns 1 when checked."""
    st = fe.eng.kv.stats
    if st.get("kind") != "paged":
        return 0
    private = st["blocks_in_use"] - st["evictable_blocks"]
    if st["ref_total"] - st["prefix_ref_total"] != st["live_block_demand"] or \
            private > st["live_block_demand"]:
        raise AssertionError(f"fleet: block accounting off at tick {fe.eng.tick}: {st}")
    return 1


def fleet_fault_run(torch, np, model, params, *, fail_at: int = FLEET_FAIL_AT,
                    preempt_at: int = FLEET_PREEMPT_AT) -> dict:
    """(b): `serve_lm.serve(scenario_name=, adapt=True, paged=True,
    fail_at=, preempt_at=)` over `FLEET_BASE` cut to `FLEET_HORIZON`
    arrival ticks, the user's ``serve_lm --scenario bursty-multitenant
    --adapt --paged --fail-at --preempt-at`` on fewer arrivals, with every
    kernel count set to 0 just before and read just after. Checks: every
    accepted request finishes; the fault log holds a device loss, a
    preemption and a regrow; staged >= 1 and retried >= 1; at least one
    replan; block references = the live demand after every tick and no
    block in use after the drain; launches exact: flash = layers x prefill
    calls, paged = layers x decode ticks with a live slot (``steps``),
    argmax = first tokens sampled (``prefills``) + decode ticks."""
    from repro_torch.examples import serve_lm

    scenario = cut_scenario(FLEET_HORIZON, FLEET_BASE)
    calls = []

    def counted_prefill(*a, **kw):
        calls.append(1)
        return model.prefill(*a, **kw)

    checked, walls, regroups = [], [], []

    def on_tick(fe):
        checked.append(check_fleet_blocks(fe))
        rec = fe.report[-1]
        walls.append(rec["wall_s"])
        if rec["regrouped"]:
            applied = [d for d in fe.controller.history if d.regroup][-1]
            regroups.append({"tick": rec["tick"], "prefill_rows": rec["prefill_rows"],
                             "decode_slots": rec["decode_slots"],
                             "predicted_speedup": applied.predicted_speedup,
                             "at": len(walls) - 1})

    counters = kernel_counters()
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    out = serve_lm.serve(dataclasses.replace(model, prefill=counted_prefill), params,
                         scenario_name=scenario, adapt=True, paged=True, fail_at=fail_at,
                         preempt_at=preempt_at, on_tick=on_tick)
    # the planner's serving instance: the measured tick before and after
    # each regroup (the policy's window of ticks on each side) beside the
    # speedup it predicted; the loads on the two sides differ, as served
    w = serve_lm.ADAPT["window"]
    for g in regroups:
        at = g.pop("at")
        before, after = walls[max(0, at - w + 1):at + 1], walls[at + 1:at + 1 + w]
        g.update(ms_before=1e3 * statistics.fmean(before),
                 ms_after=1e3 * statistics.fmean(after) if after else None)
    launches = {name: k.launches for name, k in counters.items()}
    fe, st = out["engine"], out["engine"].stats
    layers = model.cfg.n_layers
    want = {"flash_attention": layers * len(calls), "paged_decode_attention": layers * st["steps"],
            "argmax_last": st["prefills"] + st["steps"], "ssd_scan": 0, "chunk_accumulate": 0,
            "histogram": 0}
    kinds = [r["kind"] for r in fe.fault_log]
    accepted = out["requests"] - fe.sched.rejected
    finished = {r.uid for r in fe.finished}
    kv = fe.eng.kv.stats
    leaked = kv["blocks_in_use"] - kv["evictable_blocks"]
    snap = fe.ledger.snapshot()
    res = {"scenario": scenario, "fail_at": fail_at, "preempt_at": preempt_at,
           "requests": out["requests"], "accepted": accepted, "finished": len(finished),
           "ticks": fe.eng.tick, "decode_ticks": st["steps"], "prefills": st["prefills"],
           "prefill_calls": len(calls), "handoffs": st["handoffs"],
           "restores": st["restores"], "prefix_hit_tokens": st["prefix_hit_tokens"],
           "prefill_skips": st["prefill_skips"], "tokens_out": st["tokens_out"],
           "regroups": fe.regroups, "deferrals": fe.deferrals, "discarded": fe.discarded,
           "replans": out["metrics"].get("fleet.replans", 0), "fault_log": list(fe.fault_log),
           "recoveries": dict(fe.recoveries), "regrows": fe.regrows,
           "rows": [fe.n_rows, fe.cfg.n_rows], "final_prefill_rows": fe.prefill_rows,
           "ttft_p50": snap["ttft_p50"], "ttft_p99": snap["ttft_p99"],
           "latency_p99": snap["latency_p99"], "seconds": out["seconds"],
           "tokens_per_s": st["tokens_out"] / out["seconds"],
           "ms_per_tick": out["seconds"] * 1e3 / fe.eng.tick,
           "regroup_walls": regroups,
           "block_checked_ticks": sum(checked), "blocks_in_use_after_drain": leaked,
           "launches": launches, "launches_expected": want}
    if accepted != len(finished) or len(fe.finished) != len(finished):
        raise AssertionError(f"fleet: {len(finished)} of {accepted} accepted requests finished")
    if not {"device_loss", "preempt", "regrow"} <= set(kinds):
        raise AssertionError(f"fleet: fault log {kinds} lacks a loss, a preemption or a regrow")
    if fe.recoveries["staged"] < 1 or fe.recoveries["retried"] < 1:
        raise AssertionError(f"fleet: recoveries {fe.recoveries}: the faults met no live slot")
    if res["replans"] < 1:
        raise AssertionError("fleet: no replan decision was logged")
    if leaked or not sum(checked):
        raise AssertionError(f"fleet: {leaked} blocks in use after the drain "
                             f"({sum(checked)} ticks checked)")
    if launches != want or not calls:
        raise AssertionError(f"fleet: launches {launches}, want {want}")
    return res


def fleet_checkpoint_run(torch, np, model, params, *, seed: int) -> dict:
    """(c): f32, a `FleetEngine` with ``recovery="checkpoint"`` snapshotting
    every `CKPT_CADENCE` ticks (continuous, paged) on phase 6c's 12
    requests; a device loss on the tick after the snapshot at tick
    `CKPT_SNAPSHOT_TICK`, when every slot is live. Checks: ``restored`` >= 1
    and every stream equal to the colocated continuous engine's on the same
    requests under `margin_rule`. Reports the snapshot's bytes and the
    seconds `save()` blocked the tick."""
    import tempfile

    from repro_torch.serve import FleetConfig, KVSpec, make_engine
    from repro_torch.serve.faults import FaultEvent

    s = SPEC_PARITY
    kv = KVSpec(kind="paged", block_size=CKPT_BLOCK)
    reqs = spec_requests(np, model.cfg.vocab_size, n_req=s["n_req"],
                         new_tokens=s["new_tokens"], seed=seed)
    slots = (CKPT_FLEET["n_rows"] - CKPT_FLEET["prefill_rows"]) * CKPT_FLEET["slots_per_row"]
    base = target_only_margins(torch, model, params, reqs, kv, max_batch=slots,
                               max_len=CKPT_FLEET["max_len"])
    with tempfile.TemporaryDirectory(prefix="serving_ckpt_") as tmp:
        fe = make_engine(model, params, FleetConfig(**CKPT_FLEET, kv=kv, ckpt_dir=tmp))
        for r in reqs:
            fe.submit(dataclasses.replace(r, out_tokens=[]))
        while fe.eng.tick < CKPT_SNAPSHOT_TICK:
            fe.step()
        live_at_save = [r.uid if r else None for r in fe.eng.slots]
        fe.inject_fault(FaultEvent(fe.eng.tick + 1, "device_loss", rows=1))
        t0 = time.perf_counter()
        fe.drain()
        drain_s = time.perf_counter() - t0
        fe.ckpt.close()
        log = list(fe.ckpt.log)
    streams = {r.uid: list(r.out_tokens) for r in fe.finished}
    cut = margin_rule(streams, base)
    res = {"requests": len(reqs), "decode_slots": slots, "cadence": CKPT_FLEET["ckpt_cadence"],
           "fault_tick": CKPT_SNAPSHOT_TICK + 1, "live_at_snapshot": live_at_save,
           "fault_log": list(fe.fault_log), "recoveries": dict(fe.recoveries),
           "ticks": fe.eng.tick, "identical_streams": sum(
               streams.get(u) == v for u, v in base["streams"].items()),
           "cut_by_margin_rule": cut, "saves": len(log),
           "snapshot_bytes": [e["bytes"] for e in log],
           "save_blocking_s": [e["snapshot_s"] + e["wait_s"] for e in log],
           "write_s": [e.get("write_s") for e in log], "drain_s": drain_s}
    if fe.recoveries["restored"] < 1:
        raise AssertionError(f"fleet checkpoint: nothing restored: {res['fault_log']}")
    return res


def spmd_inputs(np, seed: int, vocab: int) -> dict:
    """Per tick and row: right-padded prompts, true lengths (decode rows 0;
    one prefill row idles at tick 2) and each decode row's slot for the
    wave (-1 at tick 2 on row 1: no handoff; tick 3 overwrites slot 0)."""
    rng = np.random.default_rng(seed)
    n_dec = SPMD_ROWS - max(1, round(SPMD_ALPHA * SPMD_ROWS))
    prompts = rng.integers(0, vocab, (SPMD_TICKS, SPMD_ROWS, SPMD["max_prompt"]))
    plen = rng.integers(SPMD["max_prompt"] // 8, SPMD["max_prompt"] + 1,
                        (SPMD_TICKS, SPMD_ROWS)).astype(np.int32)
    plen[:, :n_dec] = 0
    plen[2, SPMD_ROWS - 1] = 0
    dst = np.array([[0, 0], [1, 1], [1, -1], [0, 0]], np.int32)
    dst = np.concatenate([dst, np.full((SPMD_TICKS, SPMD_ROWS - n_dec), -1, np.int32)],
                         axis=1)[:, :, None]
    return {"prompts": prompts.astype(np.int64), "plen": plen, "dst": dst}


def _slot_hashes(torch, cache: dict) -> list:
    """sha256 of each slot's K and V bytes (bf16), in slot order."""
    import hashlib

    out = []
    for s in range(cache["k"].shape[1]):
        h = hashlib.sha256()
        for key in ("k", "v"):
            h.update(cache[key][:, s].contiguous().view(torch.int16).cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def disagg_spmd_rank(mesh, seed: int, inputs: dict) -> dict:
    """One rank of phase 6d (d)'s four-row world (run by `spawn`): the SPMD
    step for `SPMD_TICKS` ticks on this rank's row, each tick synchronised
    and timed, the row's outputs, stats, tokens, cursor and slot hashes, its
    `WireStats` over the ticks; then `reshard_serving_state` 2 + 2 -> 1 + 3
    rows inside the world and the new row's hashes and tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.launch.mesh import WireStats
    from repro_torch.models.model_zoo import build
    from repro_torch.serve.disagg import (
        PREFILL,
        build_disagg_spmd_step,
        disagg_row_state,
        init_disagg_state,
        serving_mesh,
    )
    from repro_torch.serve.fleet import reshard_serving_state

    dev = mesh.device
    model = build(get(SPMD_ARCH), device=dev)
    params = model.init(seed)
    gmesh = serving_mesh(mesh, SPMD_ALPHA)
    step, plan = build_disagg_spmd_step(model, gmesh, **SPMD)
    spr = SPMD["slots_per_row"]
    cache, tokens = init_disagg_state(model, gmesh, slots_per_row=spr, max_len=SPMD["max_len"])
    rc, rt = disagg_row_state(cache, tokens, gmesh, slots_per_row=spr)
    r = mesh.row
    mesh.barrier()
    mesh.stats = WireStats()
    outs, stats, tick_s = [], [], []
    for t in range(SPMD_TICKS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rc, rt, o, s = step(params, torch.as_tensor(inputs["prompts"][t, r:r + 1], device=dev),
                            torch.as_tensor(inputs["plen"][t, r:r + 1], device=dev),
                            torch.as_tensor(inputs["dst"][t, r:r + 1], device=dev), rc, rt)
        outs.append(o.cpu().numpy())
        stats.append(s.cpu().numpy())
        tick_s.append(time.perf_counter() - t0)
    wire = mesh.stats.as_dict()
    out = {"row": r, "outs": np.stack(outs), "stats": np.stack(stats), "tick_s": tick_s,
           "tokens": rt.cpu().numpy(), "pos": rc["pos"].cpu().numpy(),
           "hashes": _slot_hashes(torch, rc), "wire": wire, "n_chunks": plan.n_chunks,
           "chunk_bytes": plan.element_bytes}
    new = GroupedMesh.build_rows(mesh, rows={PREFILL: 1})
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    nc, nt = reshard_serving_state(rc, rt, gmesh, new, slots_per_row=spr)
    torch.cuda.synchronize(dev)
    out.update(reshard_s=time.perf_counter() - t0, reshard_hashes=_slot_hashes(torch, nc),
               reshard_tokens=nt.cpu().numpy(), reshard_pos=nc["pos"].cpu().numpy())
    return out


def spmd_replay(torch, np, model, params, inputs: dict) -> dict:
    """The SPMD ticks in one process on the card: per wave pair, the same
    batch-1 length-masked prefill, `pack_cache` -> `plan.unpack`, the
    migration into the decode row's slot, then `decode_steps` greedy steps
    per decode row. Returns each decode row's outputs, tokens, cursor and
    slot hashes."""
    from repro_torch.core.operators import cache_stream_plan, migrate_cache_into_slot, \
        pack_cache
    from repro_torch.kernels.sample import sample_last

    spr = SPMD["slots_per_row"]
    n_dec = SPMD_ROWS - max(1, round(SPMD_ALPHA * SPMD_ROWS))
    pre = list(range(n_dec, SPMD_ROWS))
    plan = cache_stream_plan(model.init_cache(1, SPMD["max_prompt"]), SPMD["chunk_elems"])
    rows = []
    for _ in range(n_dec):
        c = model.init_cache(spr, SPMD["max_len"])
        rows.append({"cache": c, "tokens": torch.zeros((spr, 1), dtype=torch.int32,
                                                       device=model.device), "outs": []})
    for t in range(SPMD_TICKS):
        for j, src in enumerate(pre[:n_dec]):  # one wave: prefill row j+n_dec -> decode row j
            slot, n = int(inputs["dst"][t, j, 0]), int(inputs["plen"][t, src])
            if slot < 0 or n <= 0:
                continue
            prompt = torch.as_tensor(inputs["prompts"][t, src:src + 1], device=model.device)
            logits, c1 = model.prefill(params, prompt,
                                       length=torch.tensor(n, dtype=torch.int32,
                                                           device=model.device))
            first = sample_last(logits)[0]
            src_cache = plan.unpack(pack_cache(c1, plan))
            src_cache["pos"] = torch.tensor(n, dtype=torch.int32, device=model.device)
            migrate_cache_into_slot(rows[j]["cache"], src_cache, slot)
            rows[j]["tokens"][slot, 0] = first
        for row in rows:
            toks, outs = row["tokens"], []
            for _ in range(SPMD["decode_steps"]):
                logits, row["cache"] = model.decode_step(params, row["cache"], toks)
                toks = sample_last(logits)[:, None]
                outs.append(toks[:, 0])
            row["tokens"] = toks
            row["outs"].append(torch.stack(outs, dim=1).cpu().numpy())
    return {"outs": [np.stack(r["outs"]) for r in rows],
            "tokens": [r["tokens"].cpu().numpy() for r in rows],
            "pos": [int(r["cache"]["pos"]) for r in rows],
            "hashes": [_slot_hashes(torch, r["cache"]) for r in rows]}


def disagg_spmd_run(torch, np, seed: int, smi: str) -> dict:
    """(d): the SPMD step in a four-row gloo world on this card against its
    one-process replay (decode rows' tokens, cursors and KV hashes bit for
    bit), the stats against the arithmetic, and the in-world reshard 2 + 2
    -> 1 + 3 rows keeping every kept slot's KV and token bit for bit; the
    handoff's wire bytes and seconds from `WireStats`."""
    from repro_torch.configs import get
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model_zoo import build

    cfg = get(SPMD_ARCH)
    inputs = spmd_inputs(np, seed, cfg.vocab_size)
    t0 = time.perf_counter()
    ranks = spawn(disagg_spmd_rank, SPMD_ROWS, args=(seed, inputs), timeout_s=600)
    world_s = time.perf_counter() - t0
    model = build(cfg)
    params = model.init(seed)
    rep = spmd_replay(torch, np, model, params, inputs)
    del model, params
    n_dec = SPMD_ROWS - max(1, round(SPMD_ALPHA * SPMD_ROWS))
    spr = SPMD["slots_per_row"]
    for j in range(n_dec):
        got = ranks[j]
        if not (np.array_equal(got["outs"][:, :, :], rep["outs"][j])
                and np.array_equal(got["tokens"], rep["tokens"][j])
                and int(got["pos"][0]) == rep["pos"][j] and got["hashes"] == rep["hashes"][j]):
            raise AssertionError(f"spmd: decode row {j} differs from the one-process replay")
    handoffs = [int(((inputs["dst"][t, :n_dec, 0] >= 0)
                     & (inputs["plen"][t, n_dec:] > 0)).sum()) for t in range(SPMD_TICKS)]
    emitted = n_dec * spr * SPMD["decode_steps"]
    for j in range(n_dec):
        want = np.array([[[h, emitted]] for h in handoffs], np.int32)
        if not np.array_equal(ranks[j]["stats"], want):
            raise AssertionError(f"spmd: stats {ranks[j]['stats'].tolist()} != {want.tolist()}")
    old = [h for r in ranks[:n_dec] for h in r["hashes"]]
    old_tok = np.concatenate([r["tokens"] for r in ranks[:n_dec]])
    new = [h for r in ranks for h in r["reshard_hashes"]]
    new_tok = np.concatenate([r["reshard_tokens"] for r in ranks])
    kept = len(old)
    new_pos = {int(r["reshard_pos"][0]) for r in ranks[:SPMD_ROWS - 1]}
    if new[:kept] != old or not np.array_equal(new_tok[:kept], old_tok) or \
            new_tok[kept:].any() or new_pos != {max(rep["pos"])}:
        raise AssertionError("spmd: the in-world reshard lost a kept slot's KV or token")
    producers = ranks[n_dec:]
    line = {"phase": "disagg", "run": "spmd", "model": SPMD_ARCH, "dtype": "bf16",
            "nvidia_smi": smi, "rows": SPMD_ROWS, "prefill_rows": SPMD_ROWS - n_dec,
            **SPMD, "ticks": SPMD_TICKS, "handoffs_per_tick": handoffs,
            "n_chunks": ranks[0]["n_chunks"], "chunk_bytes": ranks[0]["chunk_bytes"],
            "replay_bit_identical": True, "stats_as_arithmetic": True,
            "reshard_kept_bit_identical": kept,
            "tick_s_by_rank": [r["tick_s"] for r in ranks],
            "wire_by_rank": [{k: r["wire"][k] for k in ("sent_bytes", "recv_bytes", "d2h_bytes",
                                                        "d2h_s", "h2d_bytes", "h2d_s", "wait_s",
                                                        "collective_bytes", "collective_s")}
                             for r in ranks],
            "handoff_bytes_sent": sum(r["wire"]["sent_bytes"] for r in producers),
            "reshard_s_by_rank": [r["reshard_s"] for r in ranks], "world_s": world_s}
    emit(line)
    return line


def disagg_phase(torch, np, model, params, smi: str, seed: int) -> dict:
    """Phase 6d: disaggregated serving and the serving fleet. (a) and (c) on
    qwen2.5-3b in f32 (TF32 off) from ``seed``; (b) on ``params`` (bf16)
    through `serve_lm.serve`; (d) a four-row world of tinyllama-1.1b.
    Returns (b)'s launches (``launches_disagg``)."""
    from repro_torch.models.model_zoo import build

    part_s, t0 = {}, time.perf_counter()
    f32 = build(dataclasses.replace(model.cfg, dtype=torch.float32))
    f32_params = f32.init(seed)
    p = DISAGG_PARITY
    reqs = disagg_requests(np, model.cfg.vocab_size, n_req=p["n_req"], lo=p["lo"], hi=p["hi"],
                           new_tokens=p["new_tokens"], seed=seed + 11)
    par = disagg_aligned_parity(torch, np, f32, f32_params, reqs, max_len=p["max_len"])
    emit({"phase": "disagg", "run": "aligned handoff vs colocated", "model": model.cfg.name,
          "dtype": "f32", "nvidia_smi": smi, "requests": len(reqs),
          "prompt_tokens": [int(r.prompt.shape[0]) for r in reqs], **par,
          "seconds_run": time.perf_counter() - t0})
    part_s["aligned_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = fleet_checkpoint_run(torch, np, f32, f32_params, seed=seed)
    emit({"phase": "disagg", "run": "checkpoint recovery", "model": model.cfg.name,
          "dtype": "f32", "nvidia_smi": smi, **ck})
    part_s["checkpoint_recovery"] = time.perf_counter() - t0
    del f32, f32_params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet = fleet_fault_run(torch, np, model, params)
    emit({"phase": "disagg", "run": "adaptive fleet under faults", "model": model.cfg.name,
          "dtype": "bf16", "nvidia_smi": smi, **fleet})
    part_s["fleet_faults"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    disagg_spmd_run(torch, np, seed, smi)
    part_s["spmd_world"] = time.perf_counter() - t0
    emit({"phase": "disagg", "run": "phase seconds", **part_s})
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": fleet["launches"], "fleet": fleet, "parity": par, "checkpoint": ck}


# -- phase 7: mamba2-130m in aligned mode ------------------------------------


def mamba_requests(np, cfg, *, n_req: int, seed: int) -> list:
    """The mamba arm's traffic: prompts of 1,000-16,000 tokens (uniform,
    from the seed), 64 new tokens each."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(1000, 16001))).astype(np.int32),
                    max_new_tokens=64) for i in range(n_req)]


def aligned_arm(torch, np, model, params, *, reqs: list, arm: str = "mamba",
                max_batch: int = 8, max_len: int = 16384,
                budget: float = MAMBA_LOGIT_BUDGET, relative: bool = False) -> dict:
    """Drain ``reqs`` through `make_engine` in aligned mode over the dense
    store, with every kernel count set to 0 just before and read just
    after. Times each prefill call and each tick on the host clock, ended
    by `torch.cuda.synchronize()`, and each request's first token. After
    the run, holds the first prefill call's last-position logits, and the
    first decode tick's logits of slot 0 (whose cache that prefill made),
    against the plain route: request 0 prefilled with ``impl="ref"``,
    migrated into a one-slot cache at the run's shared cursor, then one
    decode step on it with the run's token. ``budget``: absolute, or a
    fraction of the plain logits' largest magnitude with ``relative``.
    Launches exact: the SSD scan in every SSM layer and flash in every
    attention layer of each prefill call, no paged decode, the argmax
    once per admission and tick."""
    from repro_torch.core.operators import migrate_cache_into_slot
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
        pos = cache["pos"].clone()
        out = model.decode_step(params_, cache, token)
        if not first_decode:
            first_decode.update(token=token[:1].clone(), logits=out[0][:1, -1].clone(), pos=pos)
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
    counters = zero_counters()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.drain()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the plain route for request 0: prefill, then slot 0's first decode
    # step at the run's shared cursor
    torch.cuda.synchronize()
    ts = time.perf_counter()
    ref_logits, ref_cache1 = model.prefill(params, first_prefill["tokens"], impl="ref")
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - ts) * 1e3
    ref_cache = migrate_cache_into_slot(model.init_cache(1, max_len), ref_cache1, 0)
    ref_cache["pos"] = first_decode["pos"]
    ref_dec, _ = model.decode_step(params, ref_cache, first_decode["token"])
    torch.cuda.synchronize()
    if any(k.launches != launches[name] for name, k in counters.items()):
        raise AssertionError("the plain prefill route launched a kernel")
    got_p, want_p = first_prefill["logits"].float(), ref_logits[:, -1].float()
    got_d, want_d = first_decode["logits"].float(), ref_dec[:, -1].float()
    check = {
        "prefill_logit_max_abs_err": (got_p - want_p).abs().max().item(),
        "prefill_logit_ref_max_abs": want_p.abs().max().item(),
        "decode_logit_max_abs_err": (got_d - want_d).abs().max().item(),
        "decode_logit_ref_max_abs": want_d.abs().max().item(),
        "logit_budget": budget, "budget_relative_to_max_logit": relative,
        "first_prefill_plain_route_ms": ref_ms,
        "greedy_agree": [bool(got_p.argmax(-1).eq(want_p.argmax(-1)).all()),
                         bool(got_d.argmax(-1).eq(want_d.argmax(-1)).all())],
    }
    del ref_cache, ref_cache1, first_prefill["tokens"]

    done = {r.uid: len(r.out_tokens) for r in engine.finished}
    prompt_tokens = int(sum(r.prompt.shape[0] for r in reqs))
    out = {"phase": "serve", "arm": arm, "model": cfg.name, "mode": "aligned",
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
           "ssd_launches": launches["ssd_scan"], "flash_launches": launches["flash_attention"],
           "argmax_launches": launches["argmax_last"],
           "launches": launches, "wall_s": wall,
           "tokens_per_s": engine.stats["tokens_out"] / wall,
           "median_decode_tick_ms": float(np.median(decode_only_ms)) if decode_only_ms
           else None, "decode_only_ticks": len(decode_only_ms),
           "peak_mem_gib": peak_gib, "mem_at_start_gib": start_gib, **check}
    emit(out)
    if len(done) != len(reqs) or any(done[r.uid] != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{arm}: not every request finished with its tokens: {done}")
    calls = len(prefill_ms)
    want = {"ssd_scan": cfg.n_layers * calls if cfg.family == "ssm" or cfg.hybrid else 0,
            "flash_attention": cfg.n_layers * calls if cfg.family != "ssm" else 0,
            "paged_decode_attention": 0,
            "argmax_last": decode_ticks + engine.stats["prefills"]}
    if not calls or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{arm}: launches {launches}, want {want} ({calls} prefill calls, "
                             f"{decode_ticks} ticks, {engine.stats['prefills']} admissions)")
    for part in ("prefill", "decode"):
        scale = check[f"{part}_logit_ref_max_abs"] if relative else 1.0
        if not check[f"{part}_logit_max_abs_err"] <= budget * scale:
            raise AssertionError(f"{arm}: {part} logits off the plain route: {check}")
    if engine.last_logits is None or not bool(torch.isfinite(engine.last_logits).all()):
        raise AssertionError(f"{arm}: non-finite logits")
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


# -- phase 7b: the MoE family, through make_engine ---------------------------------

# cuts of depth, full width (neither model fits one 80 GB card whole: 93.4
# and 215.5 GB of bf16 weights): (a) mixtral-8x7b, 2 of 32 layers in f32
# (~12.7 GB); (b) 8 of 32 in bf16 (~23.8 GB); (c) llama4-scout, 4 of 48
# in bf16 (~21.8 GB): layers 0-2 chunked-local (window 8,192), layer 3
# global, and 4.14 GB of embedding and head at the 202,048 vocabulary
MOE_ARMS = {"a": ("mixtral-8x7b", 2), "b": ("mixtral-8x7b", 8), "c": ("llama4-scout-17b-a16e", 4)}
# (a) f32, TF32 off: the first prefill call's logits against the plain
# route within 1e-4 of their largest magnitude (the port's f32 budget
# through a whole model: another summation order in attention), every
# token's expert choice identical between the routes
MOE_F32_REL = 1e-4
# (a)'s first decode tick: 1e-3 of the largest logit. The engine's f32
# model keeps K/V in a bf16 pool, and the two routes attend the step's own
# K/V row differently, as the reference's two do: the kernel (like the
# Pallas kernel) in q's f32, the plain version (like the reference's
# ref.py) rounded to the pool's bf16 first. Under diffuse attention over
# ~1,500 positions that row carries ~2.5 % of a layer-0 output, and its
# rounding (2^-9) moves the output, and through the experts the logits,
# by ~1e-4 relative (1.6e-4 measured on the card). A dropped or
# extra live position moves the output by ~1/1,500 of v, ~2.5 % of it.
MOE_F32_DECODE_REL = 1e-3
# (b), (c) bf16: phase 6's prefill budget (0.25 on logits reaching ~4,
# where one bf16 ulp is 0.03) as a fraction of the largest logit
# magnitude, 1/16. The router's choice is a discontinuous function of its
# input: a token whose top choices lie within the routes' bf16 difference
# (~1e-3 of a router logit) flips, and its row then moves by the size of
# an expert's output, which is not a kernel fault. So the plain check
# takes the kernel call's expert choices (`RouteTape`), and the share of
# tokens whose own choice differs is reported beside it.
MOE_BF16_REL = 2.0 ** -4


class RouteTape:
    """Stands over `models.moe.route` while phase 7b runs. `record()` keeps
    the routes of the calls that follow and `stop()` returns them;
    `replay(routes)` hands them back in order instead of the calls' own,
    so that a plain-route run takes the kernel run's expert choices, and
    counts the routed tokens whose own choice (a round's expert, or
    whether it was kept) differs."""

    def __init__(self, real):
        self.real, self.mode, self.routes, self.queue = real, None, [], []
        self.differ = self.tokens = 0

    def record(self) -> None:
        self.mode, self.routes = "record", []

    def replay(self, routes: list) -> None:
        self.mode, self.queue, self.differ, self.tokens = "replay", list(routes), 0, 0

    def stop(self) -> list:
        if self.mode == "replay" and self.queue:
            raise AssertionError(f"the plain run routed {len(self.queue)} calls fewer")
        self.mode = None
        return self.routes

    def share(self) -> float:
        return self.differ / max(self.tokens, 1)

    def __call__(self, p, xg, cfg, dtype, **kw):
        r = self.real(p, xg, cfg, dtype, **kw)
        if self.mode == "record":
            self.routes.append(r)
        elif self.mode == "replay":
            want = self.queue.pop(0)
            self.differ += int(((r.choice != want.choice) | (r.keep != want.keep)).any(0).sum())
            self.tokens += r.choice[0].numel()
            return want
        return r


def moe_requests(np, vocab: int, *, lens: list, new_tokens: int, seed: int,
                 shared: tuple = (), prefix: int = 0) -> list:
    """One request per prompt length in ``lens``, ``new_tokens`` each; the
    requests at the indices ``shared`` begin with one ``prefix``-token
    document (their lengths include it)."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    doc = rng.integers(0, vocab, prefix)
    reqs = []
    for i, n in enumerate(lens):
        head = doc if i in shared else doc[:0]
        prompt = np.concatenate([head, rng.integers(0, vocab, n - len(head))])
        reqs.append(Request(uid=i, prompt=prompt.astype(np.int32), max_new_tokens=new_tokens))
    return reqs


def plain_route_model(model):
    """``model`` with its prefill and paged decode on the plain route."""
    def prefill(params_, tokens, cache=None, length=None, *, impl=None):
        return model.prefill(params_, tokens, cache, length, impl="ref")

    def decode(params_, pview, token, *, impl=None):
        return model.decode_step_paged(params_, pview, token, impl="ref")

    return dataclasses.replace(model, prefill=prefill, decode_step_paged=decode)


def moe_arm_model(torch, arm: str, seed: int, dtype=None):
    """Arm ``arm``'s cut config, built on the card with random weights
    from ``seed``."""
    from repro_torch.configs import get
    from repro_torch.models.model_zoo import build

    name, layers = MOE_ARMS[arm]
    cfg = dataclasses.replace(get(name), n_layers=layers, dtype=dtype or get(name).dtype)
    model = build(cfg)
    return model, model.init(seed)


def moe_phase(torch, np, seed: int, smi: str) -> dict:
    """Phase 7b: the MoE family at full width, cut depth, through
    `make_engine` (continuous, paged store of 16-token blocks, prefix
    cache), one model at a time, freed before the next. (a) f32
    mixtral-8x7b: the plain-route engine's streams beside the kernel
    engine's under the margin rule; (b) bf16 mixtral-8x7b; (c) bf16
    llama4-scout. Each through `serve_arm`: exact launch counts, prefix
    hits, times, the first calls against the plain route."""
    from repro_torch.models import moe, transformer
    from repro_torch.serve import KVSpec

    tape = RouteTape(moe.route)
    moe.route = tape
    lines, part_s = {}, {}
    try:
        # (a) f32, 2 layers: 8 requests of 64-1,500 tokens, 4 slots
        t0 = time.perf_counter()
        model, params = moe_arm_model(torch, "a", seed, torch.float32)
        rng = np.random.default_rng(seed + 20)
        reqs = moe_requests(np, model.cfg.vocab_size, new_tokens=16, seed=seed + 21,
                            lens=[int(n) for n in rng.integers(64, 1501, 8)])
        kv = KVSpec(kind="paged", block_size=16, prefix_cache=True)
        served = [dataclasses.replace(r, out_tokens=[]) for r in reqs]
        a = serve_arm(torch, np, model, params, kv=kv, arm="moe f32 mixtral-8x7b", reqs=served,
                      max_batch=4, budget=(MOE_F32_DECODE_REL, MOE_F32_REL), tape=tape)
        kernel_streams = {r.uid: list(r.out_tokens) for r in served}
        plain = target_only_margins(torch, plain_route_model(model), params, reqs, kv,
                                    max_batch=4, max_len=2048)
        cut = margin_rule(kernel_streams, plain)
        lines["a"] = a
        emit({"phase": "moe", "run": "(a) streams against the plain-route engine",
              "model": model.cfg.name, "dtype": "f32", "requests": len(reqs),
              "streams_equal": kernel_streams == plain["streams"],
              "cut_by_margin_rule": cut, "plain_ticks": plain["ticks"],
              "min_plain_margin": min(min(m.values()) for m in plain["margins"].values())})
        if a["decode_route_differ_share"] or a["prefill_route_differ_share"]:
            raise AssertionError(f"moe (a): an expert choice differs between the routes "
                                 f"in f32: {a}")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        part_s["a"] = time.perf_counter() - t0

        # (b) bf16, 8 layers, 8 slots, max_len 8,192: 16 requests, the
        # first 8 of 64-2,048 tokens (the first prefill call, held against
        # the plain route whole, stays at a 2,048 bucket), then two over
        # one 3,000-token document and two of 5,000-6,000 tokens
        t0 = time.perf_counter()
        model, params = moe_arm_model(torch, "b", seed)
        rng = np.random.default_rng(seed + 22)
        lens = [int(n) for n in rng.integers(64, 2049, 12)]
        lens[8:8] = [int(rng.integers(3200, 3600)), int(rng.integers(5000, 6001))]
        lens[11:11] = [int(rng.integers(3200, 3600)), int(rng.integers(5000, 6001))]
        reqs = moe_requests(np, model.cfg.vocab_size, lens=lens, new_tokens=32,
                            seed=seed + 23, shared=(8, 11), prefix=3000)
        b = serve_arm(torch, np, model, params, arm="moe bf16 mixtral-8x7b", reqs=reqs,
                      max_batch=8, max_len=8192, budget=(MOE_BF16_REL, MOE_BF16_REL), tape=tape,
                      kv=KVSpec(kind="paged", block_size=16, prefix_cache=True,
                                prefix_capacity=2 * (8192 // 16 + 1)))
        _, aux, _, _ = transformer.forward_lm(
            model.cfg, params, torch.as_tensor(reqs[0].prompt[None], device=model.device))
        b["one_forward_aux"] = {k: v.item() for k, v in aux.items()}
        emit({"phase": "moe", "run": "(b) one forward's aux", "tokens": int(len(reqs[0].prompt)),
              **b["one_forward_aux"]})
        lines["b"] = b
        if b["prefix_hit_tokens"] <= 0:
            raise AssertionError("moe (b): the shared document never hit the prefix cache")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        part_s["b"] = time.perf_counter() - t0

        # (c) bf16 llama4-scout, 4 layers, 2 slots, max_len 16,384: three
        # prompts of 9,000-14,000 tokens, the first and the third over one
        # 8,000-token document
        t0 = time.perf_counter()
        model, params = moe_arm_model(torch, "c", seed)
        reqs = moe_requests(np, model.cfg.vocab_size, lens=[12_500, 14_000, 9_000],
                            new_tokens=16, seed=seed + 24, shared=(0, 2), prefix=8000)
        c = serve_arm(torch, np, model, params, arm="moe bf16 llama4-scout-17b-a16e",
                      reqs=reqs, max_batch=2, max_len=16384, tape=tape,
                      budget=(MOE_BF16_REL, MOE_BF16_REL),
                      kv=KVSpec(kind="paged", block_size=16, prefix_cache=True,
                                prefix_capacity=2 * (16384 // 16 + 1)))
        lines["c"] = c
        if c["prefix_hit_tokens"] <= 0:
            raise AssertionError("moe (c): the shared document never hit the prefix cache")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        part_s["c"] = time.perf_counter() - t0
    finally:
        moe.route = tape.real
    emit({"phase": "moe", "run": "phase seconds", **part_s, "nvidia_smi": smi})
    return {"lines": lines, "launches": lines["b"]["launches"],
            "launches_by_arm": {k: v["launches"] for k, v in lines.items()}}


# -- phase 7c: the last model families (pixtral-12b, hymba-1.5b, whisper-small) ---

# bf16 arms: the first calls, kernel route vs the plain route
# (`impl="ref"`), within 1/16 of the plain logits' largest magnitude:
# phase 6's qwen2.5-3b prefill budget (0.25 on logits reaching ~4 over 36
# layers) as a fraction of the largest logit, for pixtral-12b's 40 layers,
# hymba-1.5b's 32 (its SSD scan beside flash in every layer) and
# whisper-small's 12 + 12 (flash in the encoder and in both decoder
# attentions). The plain route rounds scores and probabilities to bf16
# where the kernels keep f32; a wrong mask, head or chunk moves logits by
# O(1) of their largest magnitude.
FAMILY_BF16_REL = 2.0 ** -4
# (d) f32, TF32 off: the first prefill call's logits and the first decode
# tick's within 1e-4 of their largest magnitude of the plain route's (phase
# 7b (a)'s f32 prefill budget: another summation order in attention and
# in the scan, through a whole model); the greedy streams of
# `FAMILY_F32_TICKS` ticks equal under the margin rule (`SPEC_MARGIN`).
# The caches are f32 too: with the models' default bf16 caches (K/V, the
# conv window, whisper's cross-attention cache) an f32 value that differs
# by ~1e-6 between the routes now and then rounds to another bf16 value,
# 2^-8 of it apart, and hymba-1.5b's first tick then moved 3.1e-4 of the
# largest logit over 32 layers (measured on the card, NVIDIA H100 80GB
# HBM3, 700.00 W; its prefill logits: 1.1e-5). The served bf16 caches are
# arms (a)-(c)'s, at their bf16 budget.
FAMILY_F32_REL = 1e-4
FAMILY_F32_TICKS = 16
# (a) pixtral-12b: image prompts (256 patch embeddings before 768-2,048
# text tokens) through `model.prefill(patches=)` and aligned decode ticks;
# then text requests through the continuous paged engine
PIXTRAL_IMAGES = dict(n_req=4, lo=768, hi=2048, ticks=32)
PIXTRAL_TEXT = dict(n_req=8, lo=64, hi=2048, new_tokens=32, max_len=2080)
# (b) hymba-1.5b through `make_engine` in aligned mode: 16 prompts of
# 500-8,000 tokens (all but the shortest past the 1,024-token window), 64
# new tokens each, 8 slots; two waves of 64 ticks keep the shared cursor
# under 8,000 + 128
HYMBA_ARM = dict(n_req=16, lo=500, hi=8000, new_tokens=64, max_batch=8, max_len=8192)
# (c) whisper-small: 8 requests of 1,500 frames (30 s of audio at the
# stub's frame rate), a 16-token prompt, 128 new tokens (16 + 128 within
# the decoder's 448-token horizon)
WHISPER_ARM = dict(batch=8, frames=1500, prompt=16, new_tokens=128)
# (d): pixtral-12b at 2 of its 40 layers (the f32 embedding and head alone
# are 5.4 GB), hymba-1.5b and whisper-small whole; 2 requests each
FAMILY_F32 = {"pixtral-12b": dict(layers=2, text=1000),
              "hymba-1.5b": dict(layers=None, text=3000),
              "whisper-small": dict(layers=None, text=16)}


def frontend_input(torch, cfg, batch: int, seed: int, n: int | None = None):
    """(B, n, d) f32 frontend embeddings N(0, 0.02^2) on the card (n: the
    config's frontend tokens unless given)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, n or cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                       device="cuda") * 0.02


def family_model(torch, name: str, seed: int, *, layers: int | None = None, dtype=None):
    """The full config of ``name`` (depth cut to ``layers`` if given),
    built on the card with random weights from ``seed``."""
    from repro_torch.configs import get
    from repro_torch.models.model_zoo import build

    cfg = get(name)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, dtype=dtype or cfg.dtype)
    model = build(cfg)
    return model, model.init(seed)


def family_launches(cfg) -> dict:
    """Flash and SSD launches of one prefill call of ``cfg``'s model."""
    attn = cfg.encoder_layers + 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    return {"flash_attention": attn, "ssd_scan": cfg.n_layers if cfg.hybrid else 0}


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) of two logit tensors."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def pixtral_images(torch, np, model, params, *, seed: int, n_req: int, lo: int, hi: int,
                   ticks: int) -> dict:
    """Image prompts through `model.prefill(patches=)`, one call each,
    migrated into an aligned cache of ``n_req`` slots as the aligned engine
    migrates a prompt (`migrate_cache_into_slot`: the shared cursor at the
    longest), each first token and every tick's tokens from the argmax
    kernel, ``ticks`` `decode_step` ticks; every kernel count set to 0
    just before and read just after. Then the same prompts on the plain
    route into a second aligned cache and one decode tick on it with the
    run's first tokens: the first call's logits and the first tick's
    against them (`FAMILY_BF16_REL`)."""
    from repro_torch.core.operators import migrate_cache_into_slot
    from repro_torch.kernels.sample import sample_last

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(lo, hi + 1, n_req)]
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)), device="cuda")
               for n in lens]
    patches = [frontend_input(torch, cfg, 1, seed + i) for i in range(n_req)]
    max_len = max(lens) + cfg.n_frontend_tokens + ticks

    def prefill_all(impl, times: list | None = None):
        cache, logits = model.init_cache(n_req, max_len), []
        for i, (toks, p) in enumerate(zip(prompts, patches)):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out, cache1 = model.prefill(params, toks, patches=p, impl=impl)
            torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter() - ts) * 1e3)
            migrate_cache_into_slot(cache, cache1, i)
            logits.append(out)
        return cache, torch.cat(logits)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    prefill_ms, tick_ms = [], []
    cache, first_logits = prefill_all(None, prefill_ms)
    tokens = torch.stack([sample_last(first_logits[i:i + 1])[0] for i in range(n_req)])[:, None]
    first_tokens, first_tick = tokens.clone(), None
    for _ in range(ticks):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tokens)
        tokens = sample_last(logits)[:, None]
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - ts) * 1e3)
        if first_tick is None:
            first_tick = logits[:, -1].clone()
    launches = {name: k.launches for name, k in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(logits).all())
    del cache

    ts = time.perf_counter()
    ref_cache, ref_logits = prefill_all("ref")
    ref_tick, _ = model.decode_step(params, ref_cache, first_tokens)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - ts
    if any(k.launches != launches[name] for name, k in counters.items()):
        raise AssertionError("pixtral images: the plain route launched a kernel")
    del ref_cache
    p_err, p_max = rel_err(first_logits[:, -1], ref_logits[:, -1])
    d_err, d_max = rel_err(first_tick, ref_tick[:, -1])
    tokens_in = sum(lens) + n_req * cfg.n_frontend_tokens
    out = {"phase": "families", "run": "(a) pixtral-12b image prompts", "model": cfg.name,
           "dtype": "bf16", "requests": n_req, "text_tokens": lens,
           "patches": cfg.n_frontend_tokens, "prefill_calls": n_req, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": tokens_in / (sum(prefill_ms) / 1e3),
           "decode_ticks": ticks, "median_decode_tick_ms": float(np.median(tick_ms)),
           "tokens_per_s": n_req * ticks / (sum(tick_ms) / 1e3), "peak_mem_gib": peak_gib,
           "launches": launches, "prefill_logit_max_abs_err": p_err,
           "prefill_logit_ref_max_abs": p_max, "decode_logit_max_abs_err": d_err,
           "decode_logit_ref_max_abs": d_max, "logit_budget": FAMILY_BF16_REL,
           "budget_relative_to_max_logit": True, "plain_route_check_s": plain_s}
    emit(out)
    want = {"flash_attention": cfg.n_layers * n_req, "argmax_last": n_req + ticks,
            "paged_decode_attention": 0, "ssd_scan": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"pixtral images: launches {launches}, want {want}")
    if not finite or not p_err <= FAMILY_BF16_REL * p_max or not d_err <= FAMILY_BF16_REL * d_max:
        raise AssertionError(f"pixtral images: logits off the plain route: {out}")
    return out


def whisper_arm(torch, np, model, params, *, seed: int, batch: int, frames: int, prompt: int,
                new_tokens: int) -> dict:
    """``batch`` requests of ``frames`` frame embeddings and a ``prompt``-token
    prompt through `model.prefill(frames=)` (one call: the encoder, the
    cross-attention cache, the teacher-forced decoder) and ``new_tokens``
    - 1 `decode_step` ticks, every token from the argmax kernel; every
    kernel count set to 0 just before and read just after. Then the plain
    route's prefill and one decode tick on its cache with the run's first
    tokens: the first call's and the first tick's logits against them."""
    from repro_torch.kernels.sample import sample_last

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt)), device="cuda")
    mem = frontend_input(torch, cfg, batch, seed, n=frames)
    max_len = prompt + new_tokens - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    ts = time.perf_counter()
    logits, cache = model.prefill(params, toks, model.init_cache(batch, max_len, frames),
                                  frames=mem)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - ts) * 1e3
    first_logits = logits[:, -1].clone()
    tokens = sample_last(logits)[:, None]
    first_tokens, first_tick, tick_ms = tokens.clone(), None, []
    for _ in range(new_tokens - 1):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tokens)
        tokens = sample_last(logits)[:, None]
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - ts) * 1e3)
        if first_tick is None:
            first_tick = logits[:, -1].clone()
    launches = {name: k.launches for name, k in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(logits).all())
    pos = int(cache["pos"])
    del cache

    ref_logits, ref_cache = model.prefill(params, toks, model.init_cache(batch, max_len, frames),
                                          frames=mem, impl="ref")
    ref_tick, _ = model.decode_step(params, ref_cache, first_tokens)
    torch.cuda.synchronize()
    if any(k.launches != launches[name] for name, k in counters.items()):
        raise AssertionError("whisper: the plain route launched a kernel")
    del ref_cache
    p_err, p_max = rel_err(first_logits, ref_logits[:, -1])
    d_err, d_max = rel_err(first_tick, ref_tick[:, -1])
    out = {"phase": "families", "run": "(c) whisper-small", "model": cfg.name, "dtype": "bf16",
           "requests": batch, "frames": frames, "prompt_tokens": prompt,
           "new_tokens": new_tokens, "prefill_calls": 1, "prefill_ms": [prefill_ms],
           "prefill_tokens_per_s": batch * (frames + prompt) / (prefill_ms / 1e3),
           "prefill_tokens_counted": "frames + prompt tokens",
           "decode_ticks": len(tick_ms), "median_decode_tick_ms": float(np.median(tick_ms)),
           "tokens_per_s": batch * len(tick_ms) / (sum(tick_ms) / 1e3),
           "peak_mem_gib": peak_gib, "final_pos": pos, "launches": launches,
           "prefill_logit_max_abs_err": p_err, "prefill_logit_ref_max_abs": p_max,
           "decode_logit_max_abs_err": d_err, "decode_logit_ref_max_abs": d_max,
           "logit_budget": FAMILY_BF16_REL, "budget_relative_to_max_logit": True}
    emit(out)
    want = {**family_launches(cfg), "argmax_last": 1 + len(tick_ms), "paged_decode_attention": 0}
    if any(launches[k] != n for k, n in want.items()) or pos != max_len:
        raise AssertionError(f"whisper: launches {launches}, want {want}; pos {pos}")
    if not finite or not p_err <= FAMILY_BF16_REL * p_max or not d_err <= FAMILY_BF16_REL * d_max:
        raise AssertionError(f"whisper: logits off the plain route: {out}")
    return out


def f32_cache(torch, model, batch: int, max_len: int) -> dict:
    """A zeroed cache of ``model`` on its device with every leaf in f32."""
    from repro_torch.models import encdec, transformer

    cfg = model.cfg
    if cfg.family == "encdec":
        return encdec.init_encdec_cache(cfg, batch, max_len, cfg.n_frontend_tokens,
                                        torch.float32, model.device)
    return transformer.init_cache(cfg, batch, max_len, torch.float32, model.device)


def greedy_f32(torch, model, params, toks, inputs: dict, max_len: int, impl, ticks: int):
    """One prefill on route ``impl`` into an f32 cache and ``ticks`` greedy
    decode ticks -> (logits (B, ticks + 1, V): the prefill's last
    position, then each tick's; the prefill's flash and SSD launches)."""
    counters = zero_counters()
    logits, cache = model.prefill(params, toks, f32_cache(torch, model, toks.shape[0], max_len),
                                  impl=impl, **inputs)
    launches = {k: counters[k].launches for k in ("flash_attention", "ssd_scan")}
    out = [logits[:, -1]]
    for _ in range(ticks):
        logits, cache = model.decode_step(params, cache, out[-1].argmax(-1)[:, None])
        out.append(logits[:, -1])
    return torch.stack(out, 1).float(), launches


def family_f32_check(torch, np, name: str, seed: int, *, layers, text: int) -> dict:
    """(d): ``name`` in f32 (TF32 off, f32 caches) at full width, 2
    requests: the first prefill call on the kernel route against the
    plain route, the first decode tick likewise (each within `FAMILY_F32_REL` of the plain
    logits' largest magnitude), and `FAMILY_F32_TICKS` greedy tokens of
    each route held under the margin rule; the kernel route launches flash
    in every attention layer (and hymba's SSD scan in every layer), the
    plain route nothing."""
    model, params = family_model(torch, name, seed, layers=layers, dtype=torch.float32)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, text)), device="cuda")
    inputs, max_len = {}, text + FAMILY_F32_TICKS
    if cfg.frontend == "vision":
        inputs["patches"] = frontend_input(torch, cfg, 2, seed)
        max_len += cfg.n_frontend_tokens
    elif cfg.frontend == "audio":
        inputs["frames"] = frontend_input(torch, cfg, 2, seed)
    got, launched = greedy_f32(torch, model, params, toks, inputs, max_len, None,
                               FAMILY_F32_TICKS)
    want, plain_launched = greedy_f32(torch, model, params, toks, inputs, max_len, "ref",
                                      FAMILY_F32_TICKS)
    streams = {r: got[r].argmax(-1).tolist() for r in range(2)}
    base = {"streams": {r: want[r].argmax(-1).tolist() for r in range(2)},
            "margins": {r: dict(enumerate(top2_margins(torch, want[r]))) for r in range(2)}}
    cut = margin_rule(streams, base)
    p_err, p_max = rel_err(got[:, 0], want[:, 0])
    same_first = streams[0][0] == base["streams"][0][0] and streams[1][0] == base["streams"][1][0]
    d_err, d_max = rel_err(got[:, 1], want[:, 1]) if same_first else (None, None)
    out = {"phase": "families", "run": f"(d) f32 {name}", "model": cfg.name, "dtype": "f32",
           "layers": cfg.n_layers, "requests": 2, "text_tokens": text,
           "frontend_tokens": cfg.n_frontend_tokens if cfg.frontend else 0,
           "prefill_logit_max_abs_err": p_err, "prefill_logit_ref_max_abs": p_max,
           "decode_logit_max_abs_err": d_err, "decode_logit_ref_max_abs": d_max,
           "logit_budget": FAMILY_F32_REL, "budget_relative_to_max_logit": True,
           "streams_equal": streams == base["streams"], "cut_by_margin_rule": cut,
           "min_plain_margin": min(min(m.values()) for m in base["margins"].values()),
           "kernel_route_launches": launched, "plain_route_launches": plain_launched}
    emit(out)
    if launched != family_launches(cfg) or any(plain_launched.values()):
        raise AssertionError(f"f32 {name}: launches {launched} (plain {plain_launched}), "
                             f"want {family_launches(cfg)}")
    if not p_err <= FAMILY_F32_REL * p_max or (same_first and not d_err <= FAMILY_F32_REL * d_max):
        raise AssertionError(f"f32 {name}: logits off the plain route: {out}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"f32 {name}: non-finite logits")
    return out


def families_phase(torch, np, seed: int, smi: str) -> dict:
    """Phase 7c: pixtral-12b, hymba-1.5b and whisper-small at full width and
    depth, random weights from ``seed``, one model at a time, freed before
    the next. (a) pixtral bf16: image prompts (`pixtral_images`), then
    text requests through `make_engine` in continuous mode (paged store of
    16-token blocks, prefix cache; `serve_arm`); (b) hymba bf16 through
    `make_engine` in aligned mode (`aligned_arm`); (c) whisper bf16
    (`whisper_arm`); (d) the f32 checks (`family_f32_check`)."""
    from repro_torch.serve import KVSpec, Request

    lines, launches, part_s = {}, {}, {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, params = family_model(torch, "pixtral-12b", seed)
    images = pixtral_images(torch, np, model, params, seed=seed + 30, **PIXTRAL_IMAGES)
    txt = PIXTRAL_TEXT
    rng = np.random.default_rng(seed + 31)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=txt["new_tokens"])
            for i, n in enumerate(rng.integers(txt["lo"], txt["hi"] + 1, txt["n_req"]))]
    text = serve_arm(torch, np, model, params, arm="families (a) pixtral-12b text", reqs=reqs,
                     max_batch=txt["n_req"], max_len=txt["max_len"],
                     budget=(FAMILY_BF16_REL, FAMILY_BF16_REL),
                     kv=KVSpec(kind="paged", block_size=16, prefix_cache=True))
    lines["a"] = {"images": images, "text": text}
    launches["a"] = {k: images["launches"][k] + text["launches"][k] for k in text["launches"]}
    del model, params
    free()
    part_s["a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model, params = family_model(torch, "hymba-1.5b", seed)
    hy = HYMBA_ARM
    rng = np.random.default_rng(seed + 32)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=hy["new_tokens"])
            for i, n in enumerate(rng.integers(hy["lo"], hy["hi"] + 1, hy["n_req"]))]
    lines["b"] = aligned_arm(torch, np, model, params, reqs=reqs, arm="families (b) hymba-1.5b",
                             max_batch=hy["max_batch"], max_len=hy["max_len"],
                             budget=FAMILY_BF16_REL, relative=True)
    launches["b"] = lines["b"]["launches"]
    del model, params
    free()
    part_s["b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model, params = family_model(torch, "whisper-small", seed)
    lines["c"] = whisper_arm(torch, np, model, params, seed=seed + 33, **WHISPER_ARM)
    launches["c"] = lines["c"]["launches"]
    del model, params
    free()
    part_s["c"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lines["d"] = {}
    for i, (name, kw) in enumerate(FAMILY_F32.items()):
        lines["d"][name] = family_f32_check(torch, np, name, seed + 34 + i, **kw)
        free()
    part_s["d"] = time.perf_counter() - t0
    emit({"phase": "families", "run": "phase seconds", **part_s, "nvidia_smi": smi})
    return {"lines": lines, "launches_by_arm": launches,
            "launches": {k: sum(arm[k] for arm in launches.values()) for k in launches["a"]}}


# -- the rank processes of phases 8-11 ---------------------------------------------

POOL_SIZE = 8  # the largest world of phases 8-11: MapReduce's, CG's and PIC's eight rows


def _pool_worker(tasks, results, parent: int, device: str) -> None:
    """One rank process of `RankPool`: torch imported, its CUDA context
    made and the training modules imported once; then each task is one
    rank of one world, run as `launch.mesh.spawn` runs it (a fresh gloo
    process group, `fn(mesh, *args)`, the result or the traceback on
    ``results``), with this process's peak memory statistics reset before
    and its cached device memory returned after. Exits on None, or when
    the parent is gone."""
    import torch

    import repro_torch.train.trainer  # noqa: F401  (the ranks' imports, paid before a world)
    from repro_torch.launch.mesh import _rank_main

    cuda = device == "cuda"
    if cuda:
        torch.zeros(1, device=device)
    while True:
        try:
            task = tasks.get(timeout=5.0)
        except queue.Empty:
            if os.getppid() != parent:
                return
            continue
        if task is None:
            return
        fn, rank, n_rows, model, init_method, args, timeout_s = task
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _rank_main(fn, rank, n_rows, model, device, init_method, args, results, timeout_s)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


class RankPool:
    """``size`` rank processes started once, in the background (the
    ``spawn`` start method, as `launch.mesh.spawn` starts its own), and
    reused by every world of phases 8-11: a world of n ranks runs on the
    first n, each a fresh gloo process group through the port's own rank
    entry (`launch.mesh._rank_main`), so a world costs no new process,
    torch import or CUDA context. `run` returns what `spawn` returns and
    fails as it fails (a rank's traceback, a dead rank, `TimeoutError`).
    Each world meets at a file of its own in a directory that lives as
    long as the pool: a rank sends its result before it destroys its
    process group, whose file store still reads the file then, so a
    world's file must outlive the world's return."""

    def __init__(self, size: int, device: str = "cuda"):
        import tempfile

        ctx = multiprocessing.get_context("spawn")
        self.rendezvous = tempfile.mkdtemp(prefix="chip_smoke_worlds_")
        self.worlds = 0
        self.tasks = [ctx.Queue() for _ in range(size)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_pool_worker, daemon=True,
                                  args=(self.tasks[slot], self.results, os.getpid(), device))
                      for slot in range(size)]
        for p in self.procs:
            p.start()

    def run(self, fn, n_rows: int, *, model: int = 1, args: tuple = (),
            timeout_s: float = 120.0) -> list:
        return self.wait(self.start(fn, n_rows, model=model, args=args, timeout_s=timeout_s))

    def start(self, fn, n_rows: int, *, model: int = 1, args: tuple = (),
              timeout_s: float = 120.0) -> tuple:
        """Hand every rank of the world its task and return at once, so
        that the parent works on the card beside the world; `wait` takes
        its results. One world at a time: the ranks share one result
        queue."""
        n_ranks = n_rows * model
        self.worlds += 1
        init_method = "file://" + os.path.join(self.rendezvous, f"world_{self.worlds}")
        for rank in range(n_ranks):
            self.tasks[rank].put((fn, rank, n_rows, model, init_method, args, timeout_s))
        return n_rows, model, timeout_s, time.monotonic() + timeout_s

    def wait(self, world: tuple) -> list:
        n_rows, model, timeout_s, deadline = world
        n_ranks = n_rows * model
        out = {}
        while len(out) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the {n_rows}x{model} world did not finish in "
                                   f"{timeout_s} s; ranks done: {sorted(out)}")
            try:
                rank, ok, payload = self.results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r in range(n_ranks)
                        if r not in out and self.procs[r].exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{self.procs[dead[0]].exitcode}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        return [out[r] for r in range(n_ranks)]

    def close(self) -> None:
        if any(p.is_alive() for p in self.procs):
            for q in self.tasks:
                q.put(None)
            for p in self.procs:
                p.join(timeout=10)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(self.rendezvous, ignore_errors=True)


WORLDS: RankPool | None = None  # started by `main` before phase 7b


# -- phase 8: training, in every step mode, with checkpoints ------------------------

TRAIN_ROWS = 4
# qwen1.5-0.5b at full width, 2 of its 24 layers (cut from its full depth
# for the smoke's time: to 12 when phase 8b came, to 6 and then 2 when
# phase 8d came; every run's wire, checkpoint and forward scale with it)
TRAIN_LAYERS = 2
TRAIN_STEPS = 3
TRAIN_CHUNK_BYTES = 16 << 20
TRAIN_SEQ = 2048
DECOUPLED_BATCH = 6  # two sequences for each of the three compute rows
DATA_PARALLEL_BATCH = 8  # two sequences for each of the four rows
DATA_PARALLEL_STEPS = 2  # the conventional and overlap runs (COMPARE_STEP is their last)
TRAIN_CKPT_EVERY = 2  # the decoupled run saves at steps 2 and 3 (the last)
RESUME_STEP = 2
# the decoupled trainer under the adaptive loop (`TrainerConfig.adapt`):
# 4 steps from the same initial state; the first sample after a (re)build
# is skipped, so the planner's first chance is after step 3, and step 4
# updates on the new partition. Step 5's loss, taken by one forward on the
# parameters the run left (`next_loss`), is the first to follow that update
ADAPT_TRAIN_STEPS = 4
ADAPT_POLICY = dict(window=2, cooldown=1, speedup_threshold=1.05)
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
    """One rank of the train phase's four-row world (run by `WORLDS`), at
    qwen1.5-0.5b's full width: 3 AdamW steps through `Trainer` in
    decoupled mode, saving at steps 2 and 3; a fresh overlap `Trainer`
    resuming from step 2 (step 3's commit marker removed, as a crash
    before it would leave it) and taking step 3; 2 steps each of the
    conventional and the overlap step on 8 sequences; each run with this
    rank's kernel counts set to 0 just before and read just after, and row
    0 reading the files of its last step back against the live state, so
    every checkpoint written is read. Then one SGD step of each mode
    against the conventional step in one process, in f32."""

    import torch

    from repro_torch.configs import get
    from repro_torch.core.adapt import AdaptPolicy
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
    from repro_torch.utils.treeutil import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mem = []  # (where, GiB allocated, GiB reserved) on this rank

    def snap(where: str) -> None:
        mem.append((where, torch.cuda.memory_allocated() / 2 ** 30,
                    torch.cuda.memory_reserved() / 2 ** 30))

    cfg = dataclasses.replace(get("qwen1.5-0.5b"), n_layers=TRAIN_LAYERS)
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
               "log": trainer.metrics_log, "timings": list(trainer.step_fn.timings),
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

    def decoupled_batch(index: int) -> dict:
        """This row's part of the decoupled run's batch ``index`` (step
        ``index + 1``), laid out over its TRAIN_ROWS - 1 compute rows."""
        return row_shard(pipe6.padded_for_groups(index, TRAIN_ROWS - 1, TRAIN_ROWS), mesh.row,
                         TRAIN_ROWS, model.device)

    def next_loss(params, index: int) -> float:
        """The decoupled trainer's logged loss of step ``index + 1`` on
        ``params``: every compute row's loss sum and token count, one sum
        over the world."""
        batch = decoupled_batch(index)
        tot, cnt = 0.0, float(batch["mask"].sum())
        if mesh.row < TRAIN_ROWS - 1:
            with torch.no_grad():
                tot = float(model.loss(params, batch)[0] * batch["mask"].sum())
        else:
            cnt = 0.0
        sums = mesh.all_reduce(torch.tensor([tot, cnt], dtype=torch.float32))
        return float(sums[0]) / max(float(sums[1]), 1.0)

    # the decoupled run, checkpointing
    dec_dir = os.path.join(ckpt_root, "decoupled")
    trainer = Trainer(model, mesh, pipe6, adamw, decoupled_cfg,
                      TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                    ckpt_every=TRAIN_CKPT_EVERY, keep=2, ckpt_dir=dec_dir))
    state = trainer.init_state(seed)
    snap("adamw state")
    out["params"] = sum(p.numel() for p in tree_leaves(state["params"]))
    drive("decoupled", trainer, state, resume=False)
    # the state step 3 left, from which the adaptive run's update on a new
    # partition is taken again after that run (below)
    at_step3 = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                        {"params": state["params"], "opt": state["opt"]})
    # the adaptive run's losses on the old partition are held to the
    # static run carried on by its own step once more (in place, after its
    # counts and timings were read; the overlap run below resumes from the
    # files): its logged loss, and step 5's loss on the parameters it left
    _, _, metrics = trainer.step_fn(state["params"], state["opt"], decoupled_batch(TRAIN_STEPS))
    out["static_next_losses"] = [float(metrics["loss"]),
                                 next_loss(state["params"], TRAIN_STEPS + 1)]
    del metrics
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
                          TrainerConfig(total_steps=DATA_PARALLEL_STEPS, log_every=1, keep=1,
                                        ckpt_dir=d))
        state = trainer.init_state(seed)
        drive(mode, trainer, state, resume=False)
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        if mesh.row == 0:
            shutil.rmtree(d, ignore_errors=True)
        mesh.barrier()

    # the decoupled trainer under the adaptive loop, from the same initial
    # state; it saves only at its last step, which row 0 reads back
    d = os.path.join(ckpt_root, "decoupled_adaptive")
    trainer = Trainer(model, mesh, pipe6, adamw, decoupled_cfg,
                      TrainerConfig(total_steps=ADAPT_TRAIN_STEPS, log_every=1, keep=1,
                                    ckpt_every=ADAPT_TRAIN_STEPS, ckpt_dir=d,
                                    adapt=AdaptPolicy(**ADAPT_POLICY)))
    state = trainer.init_state(seed)
    run = drive("decoupled_adaptive", trainer, state, resume=False)
    run["next_loss"] = next_loss(state["params"], ADAPT_TRAIN_STEPS)
    run["adapt_log"] = trainer.adapt_log
    run["decisions"] = [(d.reason, d.predicted_speedup)
                        for d in trainer.adaptive_graph.history]
    run["reduce_rows_final"] = reduce_rows = round(trainer.ts_cfg.reduce_alpha * TRAIN_ROWS)
    del state, trainer
    # what a regroup after step 3 is held to: step 4 taken again from the
    # state step 3 left by a decoupled step built on the new partition, its
    # loss and step 5's loss on the parameters it leaves (the same sums in
    # the same order, so bit for bit the adaptive run's)
    out["repartitioned_losses"] = None
    if run["adapt_log"] and run["adapt_log"][0]["step"] == TRAIN_STEPS:
        step = make_step(model, mesh, adamw,
                         dataclasses.replace(decoupled_cfg, reduce_alpha=reduce_rows / TRAIN_ROWS),
                         inplace=True)
        batch = row_shard(pipe6.padded_for_groups(TRAIN_STEPS, TRAIN_ROWS - reduce_rows,
                                                  TRAIN_ROWS), mesh.row, TRAIN_ROWS, model.device)
        _, _, metrics = step(at_step3["params"], at_step3["opt"], batch)
        out["repartitioned_losses"] = [float(metrics["loss"]),
                                       next_loss(at_step3["params"], TRAIN_STEPS + 1)]
        del step, batch, metrics
    del at_step3
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
    for name, dtype in (("f32", torch.float32),):
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
            "layers": TRAIN_LAYERS,
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


def adaptive_train_line(ranks: list, dec: dict, smi: str) -> dict:
    """The adaptive decoupled run's line and its checks: its regroups (the
    same on every rank), the reduce rows of each step, chunk_accumulate's
    launches against the schedule (each step folds every compute row's
    gradient once, one launch a wave), its losses against the static
    decoupled run's (carried on by one more step): bit for bit up to the
    first regroup, within `OVERLAP_LOSS_REL` on every set of parameters
    that no update on a new partition made; after a regroup (after step 3), step 4's loss
    and step 5's loss on the run's last parameters bit for bit those of a
    decoupled step built on the new partition from the state step 3 left
    (step 5's loss holds the update made on the new partition, and a
    regroup that no such loss follows fails; its distance to the static
    run's, a different summation order, is reported), and the seconds of
    the steps on the new partition."""
    runs = [r["runs"]["decoupled_adaptive"] for r in ranks]
    log = runs[0]["adapt_log"]
    if any(run["adapt_log"] != log for run in runs):
        raise AssertionError("train adaptive: the rows disagree on the regroups")
    rows, by_step = 1, []  # decoupled_cfg's reduce_alpha 1/4 of TRAIN_ROWS
    events = {e["step"]: e["regroup"]["reduce"] for e in log}
    for step in range(1, ADAPT_TRAIN_STEPS + 1):
        by_step.append(rows)
        rows = events.get(step, rows)
    expected = sum(TRAIN_ROWS - r for r in by_step)
    first = log[0]["step"] if log else ADAPT_TRAIN_STEPS
    static = [x["loss"] for x in dec["steps"]] + ranks[0]["static_next_losses"]
    losses = [x["loss"] for x in runs[0]["log"]] + [runs[0]["next_loss"]]
    # a regroup after step `first`: step first + 1 updates on the new
    # partition, and step first + 2's loss is the first to follow it
    after_update = list(range(first + 2, ADAPT_TRAIN_STEPS + 2)) if log else []
    repartitioned = ranks[0]["repartitioned_losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, static)]
    same = [a == b for a, b in zip(losses, static)]
    # the losses on parameters that no update on a new partition made
    held_to_static = first + 1 if log else len(losses)
    line = train_run_line("decoupled_adaptive", "decoupled", ranks, smi,
                          policy=ADAPT_POLICY, adapt_log=log, reduce_rows_by_step=by_step,
                          chunk_accumulate_expected=expected,
                          static_losses=static, loss_rel_to_static=rel,
                          bit_identical_to_static=same, first_regroup_step=first if log else None,
                          loss_budget=OVERLAP_LOSS_REL, steps_held_to_static=held_to_static,
                          repartitioned_losses=repartitioned,
                          steps_after_a_regrouped_update=after_update)
    emit({"phase": "train", "run": "decoupled_adaptive summary", "adapt_log": log,
          "decisions": runs[0]["decisions"],
          "step_wall_s": [x["wall_s"] for x in line["steps"]],
          "new_partition_step_wall_s": [x["wall_s"] for x, r in zip(line["steps"], by_step)
                                        if r != by_step[0]],
          "static_step_wall_s": [x["wall_s"] for x in dec["steps"]], "nvidia_smi": smi})
    if line["launches"]["chunk_accumulate"] != expected:
        raise AssertionError(f"train adaptive: chunk_accumulate launched "
                             f"{line['launches']['chunk_accumulate']} times, the schedule "
                             f"{by_step} says {expected}")
    if len(losses) != ADAPT_TRAIN_STEPS + 1 or len(static) != ADAPT_TRAIN_STEPS + 1:
        raise AssertionError(f"train adaptive: {len(losses)} losses and {len(static)} static "
                             f"losses, want {ADAPT_TRAIN_STEPS} steps' and step "
                             f"{ADAPT_TRAIN_STEPS + 1}'s")
    if log and not after_update:
        raise AssertionError(f"train adaptive: the regroup after step {first} is followed by "
                             f"no loss of an update made on the new partition")
    if log and (first != TRAIN_STEPS or losses[first:] != repartitioned):
        raise AssertionError(f"train adaptive: losses {losses[first:]} after the regroup after "
                             f"step {first} are not the new partition's step from step "
                             f"{TRAIN_STEPS}'s state: {repartitioned}")
    if not all(same[:min(first, TRAIN_STEPS)]):
        raise AssertionError(f"train adaptive: losses before the first regroup differ from the "
                             f"static run's: {losses} against {static}")
    if not all(r <= OVERLAP_LOSS_REL for r in rel[:held_to_static]):
        raise AssertionError(f"train adaptive: losses {losses} off the static run's {static}: "
                             f"{rel}, budget {OVERLAP_LOSS_REL}")
    return line


def train_phase(torch, np, seed: int, smi: str) -> dict:
    """The four-row world on the card (every kernel already built by the
    parent), its train lines, and the checks. Checkpoints go to a fresh
    temporary directory, removed at the end."""
    import tempfile

    parent_gib = torch.cuda.memory_reserved() / 2 ** 30
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gib = shutil.disk_usage(ckpt_root).free / 2 ** 30
        t0 = time.perf_counter()
        ranks = WORLDS.run(train_rank, TRAIN_ROWS, args=(seed, ckpt_root), timeout_s=1000)
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
    adaptive = adaptive_train_line(ranks, dec, smi)
    launches = {name: line["launches"] for name, line in
                (("decoupled", dec), ("overlap_resume", resume), ("conventional", conv),
                 ("overlap", over), ("decoupled_adaptive", adaptive))}
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
    if len(dec["steps"]) != TRAIN_STEPS or len(conv["steps"]) != DATA_PARALLEL_STEPS \
            or len(over["steps"]) != DATA_PARALLEL_STEPS:
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


# -- phase 8b: training the MoE, VLM, hybrid and encoder-decoder families ------------

FAMILY_TRAIN_ROWS = 2
# (arm, config, layers (None: whole), text tokens a sequence, global batch,
# [(run, mode, steps)], compute dtype): full width, cut depth, f32 weights.
# mixtral's overlap run goes first: a rank's first f32 forward and backward
# pays ~10 s of one-time set-up on the card, which the overlap run's two
# ranks pay at once. One step a run: a second step would repeat the
# first's shapes and checks. Mixtral runs no decoupled step here: phase
# 8d (c)'s one process on the same weights and batch is the reference of
# the overlap step's routing, and 8d (c)'s steps on two columns (the
# decoupled one under FSDP, an AdamW update) are held to that one process.
# Hymba runs no conventional step here: phase 8d (d1) takes it at the same
# width, depth and batch on two columns, held to one process
FAMILY_TRAIN = [
    ("a", "mixtral-8x7b", 1, 1536, 2, [("overlap", "overlap", 1)], "f32"),
    ("b", "pixtral-12b", 1, 1024, 2, [("decoupled", "decoupled", 1)], None),
    ("c", "hymba-1.5b", 8, 2048, 2, [("decoupled", "decoupled", 1)], None),
    ("d", "whisper-small", None, 256, 2, [("decoupled", "decoupled", 1),
                                          ("overlap", "overlap", 1)], None),
]
# whether the reference's default rule (fsdp "auto", 6e9 f32 bytes) shards
# each arm: mixtral's one layer (1,713,418,240 parameters, 6.85 GB) and
# pixtral's (1,614,822,400, 6.46 GB) pass the threshold; hymba's 8 layers
# and whisper-small (1.11 GB) do not
FAMILY_FSDP = {"a": True, "b": True, "c": False, "d": False}
# (a): mixtral's overlap step (one sequence a row, the second routing group
# of 1,024 tokens straddling the rows) against phase 8d (c)'s one process
# holding the whole global batch, f32 with TF32 off: the loss, aux_loss and
# router_entropy from the same parameters and tokens in the same groups and
# slots, the rows' sums added in another order (and 8d (c)'s steps alike)
MOE_ROUTING_REL = 1e-5
# (d): the zero1=False step against the ZeRO-1 step, the same per-element
# AdamW arithmetic on whole tensors or on the flat part (same norm); bit
# for bit expected, 1e-7 of a parameter allowed
ZERO1_ATOL = 1e-7


def family_train_rank(mesh, seed: int) -> dict:
    """One rank of phase 8b's two-row world (run by `WORLDS`): each arm of
    `FAMILY_TRAIN` one after another, each run from the arm's parameters
    drawn from ``seed`` (f32) through `make_step` in place, the batches of
    the reference's pipeline (Zipf tokens, skewed lengths, the frontend's
    embeddings) as the trainer lays them out, with this rank's kernel
    counts set to 0 just before and read just after each run; then, on
    whisper-small, one step each with ``runtime_skip=False`` and
    ``zero1=False`` from the same parameters, against the first step of
    the default decoupled and overlap runs. Each model freed before the
    next."""
    import torch

    from repro_torch.configs import get
    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.utils.treeutil import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    adamw = OptConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    out = {"row": mesh.row, "arms": {}}

    def step_cfg(mode: str, **kw):
        return TrainStepConfig(mode=mode, reduce_alpha=0.5, wire_chunk_bytes=TRAIN_CHUNK_BYTES,
                               **kw)

    def batch_of(pipe, mode: str, index: int) -> dict:
        """This row's part of batch ``index`` as `Trainer` lays it out."""
        b = pipe.padded_for_groups(index, 1, mesh.n_rows) if mode == "decoupled" else \
            pipe.global_batch(index)
        return row_shard(b, mesh.row, mesh.n_rows, mesh.device)

    def fresh(model, ts, plan):
        """The arm's parameters and zero moments: under FSDP (``plan``)
        this row's parts, each unit drawn alone from ``seed``
        (`Model.init_unit`); else the whole tree drawn from ``seed``."""
        if plan is not None:
            parts = plan.shard_units(
                lambda u: model.init_unit(seed, u, param_dtype=torch.float32))
            return parts, init_opt_state(adamw, parts)
        params = model.init(seed, param_dtype=torch.float32)
        opt = init_opt_state(adamw, params)
        if ts.mode == "overlap" and ts.zero1:
            opt = sharding.shard_opt_state(sharding.zero1_plan(params, mesh.n_rows, mesh.row),
                                           opt)
        return params, opt

    def drive(model, pipe, ts, steps: int, keep_first: bool = False):
        """``steps`` steps of ``ts`` from the arm's parameters: (this rank's
        record of the run, a copy of the parameters after step 1 with
        ``keep_first``, else None)."""
        step = make_step(model, mesh, adamw, ts, inplace=True)
        plan = step.fsdp
        params, opt = fresh(model, ts, plan)
        n_params = sum(u.spec.total for u in plan.units) if plan is not None else \
            sum(p.numel() for p in tree_leaves(params))
        moment_bytes = sum(t.numel() * t.element_size() for k in sharding.MOMENTS
                           if k in opt for t in tree_leaves(opt[k]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        metrics, first = [], None
        t0 = time.perf_counter()
        for i in range(steps):
            params, opt, m = step(params, opt, batch_of(pipe, ts.mode, i))
            metrics.append({k: float(v) for k, v in m.items() if k != "work_rows"})
            if keep_first and i == 0:
                first = [p.clone() for p in tree_leaves(params)]
        torch.cuda.synchronize()
        run = {"wall_s": time.perf_counter() - t0, "metrics": metrics,
               "timings": list(step.timings),
               "launches": {k: fn.launches for k, fn in counters.items()},
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
               "host_peak_gib": _host_peak_gib(), "moment_bytes": moment_bytes,
               "params": n_params, "fsdp": plan is not None,
               "fsdp_stats": {k: sum(t.get(k, 0) for t in step.timings) for k in FSDP_KEYS},
               "finite": all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))}
        del params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
        return run, first

    def one_step(model, pipe, ts):
        """One step of ``ts`` from the arm's parameters (new tensors):
        (the new parameters, the launches)."""
        step = make_step(model, mesh, adamw, ts)
        params, opt = fresh(model, ts, step.fsdp)
        for fn in counters.values():
            fn.launches = 0
        new, _, _ = step(params, opt, batch_of(pipe, ts.mode, 0))
        torch.cuda.synchronize()
        del params, opt
        return new, counters["chunk_accumulate"].launches

    for arm, name, layers, seq, batch, runs, dtype in FAMILY_TRAIN:
        cfg = get(name)
        cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                  dtype=torch.float32 if dtype == "f32" else cfg.dtype)
        model = build(cfg)
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                   seed=seed, kind="zipf", skew=0.4, frontend=cfg.frontend,
                                   n_frontend_tokens=cfg.n_frontend_tokens,
                                   d_model=cfg.d_model))
        rec, firsts = {"runs": {}}, {}
        options = name == "whisper-small"
        for run, mode, steps in runs:
            rec["runs"][run], firsts[mode] = drive(model, pipe, step_cfg(mode), steps,
                                                   keep_first=options)
        if options:
            noskip, noskip_launches = one_step(model, pipe, step_cfg("decoupled",
                                                                     runtime_skip=False))
            same = all(torch.equal(a, b) for a, b in zip(firsts["decoupled"],
                                                        tree_leaves(noskip)))
            del noskip
            whole, _ = one_step(model, pipe, step_cfg("overlap", zero1=False))
            diff = max((a - b).abs().max().item()
                       for a, b in zip(firsts["overlap"], tree_leaves(whole)))
            del whole
            rec["options"] = {"runtime_skip_off_bit_identical": same,
                              "chunk_accumulate_runtime_skip_off": noskip_launches,
                              "zero1_off_max_abs_diff": diff}
            mesh.barrier()
        del firsts
        out["arms"][arm] = rec
        del model
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
    return out


FSDP_KEYS = ("fsdp_gathers", "fsdp_gather_bytes", "fsdp_gather_s", "fsdp_reduce_scatters",
             "fsdp_reduce_scatter_bytes", "fsdp_reduce_scatter_s")


def step_phases(timing: dict) -> list:
    """A step's phase keys (its laps): the step's seconds are their sum.
    An FSDP step's laps differ from its mode's without FSDP (a gather
    first in decoupled mode; forward and backward with the gathers and
    reduce-scatters in the others), so they are read from the step."""
    return [k for k in timing if k.endswith("_s") and not k.startswith(("wire_", "fsdp_"))]


def family_run_line(arm: str, name: str, layers, seq: int, batch: int, run: str, mode: str,
                    ranks: list, smi: str) -> dict:
    """One JSON line of a phase-8b run and its checks: finite losses the
    rows agree on; chunk_accumulate launched waves x f32 groups x steps
    on the reducer in decoupled mode (one compute row: one wave; every
    gradient leaf f32: one group), 0 in the others. The line says whether
    FSDP resolved on (the reference's ``"auto"``), and per rank the FSDP
    gathers' and reduce-scatters' bytes and seconds over the run."""
    runs = [r["arms"][arm]["runs"][run] for r in ranks]
    keys = step_phases(runs[0]["timings"][0])
    steps = [{"step": i + 1, **runs[0]["metrics"][i],
              "wall_s": max(sum(r["timings"][i][k] for k in keys) for r in runs),
              "phases_s": {k: max(r["timings"][i][k] for r in runs) for k in keys}}
             for i in range(len(runs[0]["metrics"]))]
    launches = [r["launches"]["chunk_accumulate"] for r in runs]
    expected = [0, len(steps)] if mode == "decoupled" else [0, 0]
    line = {"phase": "train_families", "arm": arm, "model": name, "layers": layers,
            "run": run, "mode": mode, "rows": FAMILY_TRAIN_ROWS, "seq_len": seq,
            "global_batch": batch, "params": runs[0]["params"], "fsdp": runs[0]["fsdp"],
            "steps": steps,
            "chunk_accumulate_by_row": launches, "chunk_accumulate_expected_by_row": expected,
            "per_rank": [{"row": r["row"], "wall_s": run_["wall_s"], "peak_gib": run_["peak_gib"],
                          "peak_reserved_gib": run_["peak_reserved_gib"],
                          "host_peak_gib": run_["host_peak_gib"],
                          "moment_bytes": run_["moment_bytes"], "fsdp": run_["fsdp_stats"],
                          "wire": {k: sum(t[k] for t in run_["timings"]) for k in WIRE_KEYS}}
                         for r, run_ in zip(ranks, runs)],
            "wire_chunk_bytes": TRAIN_CHUNK_BYTES, "nvidia_smi": smi}
    emit(line)
    losses = [s["loss"] for s in steps]
    if not all(math.isfinite(x) for x in losses) or not all(r["finite"] for r in runs):
        raise AssertionError(f"train_families {name} {run}: non-finite losses or parameters: "
                             f"{losses}")
    if any([m["loss"] for m in r["metrics"]] != losses for r in runs):
        raise AssertionError(f"train_families {name} {run}: the rows disagree on the loss")
    if launches != expected:
        raise AssertionError(f"train_families {name} {run}: chunk_accumulate launched "
                             f"{launches} times by row, want {expected}")
    return line


def family_train_phase(torch, np, seed: int, smi: str) -> dict:
    """Phase 8b: the two-row world on the card (every kernel already built
    by the parent), one line per arm and run, and the checks."""
    gc.collect()
    torch.cuda.empty_cache()
    parent_gib = torch.cuda.memory_reserved() / 2 ** 30
    t0 = time.perf_counter()
    ranks = WORLDS.run(family_train_rank, FAMILY_TRAIN_ROWS, args=(seed,), timeout_s=900)
    world_s = time.perf_counter() - t0
    lines, total = {}, collections.Counter()
    for arm, name, layers, seq, batch, runs, _ in FAMILY_TRAIN:
        for run, mode, _ in runs:
            line = family_run_line(arm, name, layers, seq, batch, run, mode, ranks, smi)
            lines[(arm, run)] = line
            total["chunk_accumulate"] += sum(line["chunk_accumulate_by_row"])
            if line["fsdp"] != FAMILY_FSDP[arm]:
                raise AssertionError(f"train_families {name} {run}: FSDP resolved "
                                     f"{line['fsdp']}, the reference's rule says "
                                     f"{FAMILY_FSDP[arm]}")
    options = [r["arms"]["d"]["options"] for r in ranks]
    option_launches = [o["chunk_accumulate_runtime_skip_off"] for o in options]
    total["chunk_accumulate"] += sum(option_launches)
    summary = {"phase": "train_families_summary", "world_s": world_s,
               "parent_reserved_gib": parent_gib,
               "whisper_runtime_skip_off_bit_identical": [o["runtime_skip_off_bit_identical"]
                                                          for o in options],
               "whisper_zero1_off_max_abs_diff": [o["zero1_off_max_abs_diff"] for o in options],
               "zero1_off_budget": ZERO1_ATOL,
               "whisper_option_chunk_accumulate_by_row": option_launches,
               "chunk_accumulate": total["chunk_accumulate"], "nvidia_smi": smi}
    emit(summary)
    if not all(o["runtime_skip_off_bit_identical"] for o in options):
        raise AssertionError("train_families: whisper's runtime_skip=False step differs from "
                             "the default step")
    if option_launches != [0, 1]:  # one wave of one f32 group, on the reducer
        raise AssertionError(f"train_families: whisper's runtime_skip=False step launched "
                             f"chunk_accumulate {option_launches} times by row")
    if not all(o["zero1_off_max_abs_diff"] <= ZERO1_ATOL for o in options):
        raise AssertionError(f"train_families: whisper's zero1=False step is off the ZeRO-1 "
                             f"step: {[o['zero1_off_max_abs_diff'] for o in options]}")
    launches = dict.fromkeys(kernel_counters(), 0)
    launches.update(total)
    mixtral = lines[("a", "overlap")]
    return {"launches": launches, "seconds": world_s,
            "mixtral_overlap": {"peak_reserved_gib": [r["peak_reserved_gib"]
                                                      for r in mixtral["per_rank"]],
                                **{k: mixtral["steps"][0][k]
                                   for k in ("loss", "aux_loss", "router_entropy")}}}


# -- phase 8c: FSDP training, qwen2.5-3b at full width and depth ------------------

FSDP_ARCH = "qwen2.5-3b"
FSDP_ROWS = 2
FSDP_SEQ = 512
FSDP_BATCH = 2  # one sequence a row
# the card's memory: the two rows' peaks (reserved, so the allocator's
# slack counts) must stay below it
CARD_BYTES = 80e9
# what a row of the data-parallel step without FSDP holds at its peak: f32
# parameters, momentum, the gradient and its flat copy for the all-reduce
# (`train_step.build_data_parallel_step`); AdamW at rest holds as much
REPLICATED_BYTES_PER_PARAM = 16


def fsdp_config():
    """qwen2.5-3b whole, computing in f32 (the parity step's dtype, as
    phase 8's)."""
    import torch

    from repro_torch.configs import get

    return dataclasses.replace(get(FSDP_ARCH), dtype=torch.float32)


def fsdp_pipeline(cfg, seed: int):
    from repro_torch.data.pipeline import DataConfig, Pipeline

    return Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=FSDP_SEQ,
                               global_batch=FSDP_BATCH, seed=seed, kind="zipf", skew=0.4))


def one_process_sgd_step(torch, cfg, pipe, seed: int) -> tuple:
    """A one-process step, in the parent alone: ``cfg`` whole from the
    per-unit draw (`Model.init_unit`), one conventional SGD step (lr 1, no
    momentum: the moment it leaves is the gradient) on ``pipe``'s global
    batch 0, in place: (the new parameters on the card, the step's record).
    Everything else it put on the card is freed before it returns."""
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import build_conventional_step
    from repro_torch.utils.treeutil import tree_leaves

    model = build(cfg)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    t0 = time.perf_counter()
    params = sharding.join_units(
        (u, model.init_unit(seed, u, param_dtype=torch.float32)) for u in model.units)
    opt = init_opt_state(sgd, params)
    batch = {k: v.to(model.device) for k, v in pipe.global_batch(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params, opt, metrics = build_conventional_step(model, sgd, inplace=True)(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    gmax = max(float(m.abs().max()) for m in tree_leaves(opt["m"]))
    peak = torch.cuda.max_memory_allocated()
    del opt, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    return params, {"loss": float(metrics["loss"]), "max_abs_grad": gmax,
                    "params": sum(p.numel() for p in tree_leaves(params)), "step_s": step_s,
                    "seconds": time.perf_counter() - t0, "peak_gib": peak / 2 ** 30,
                    **{k: float(metrics[k]) for k in ("aux_loss", "router_entropy")
                       if k in metrics}}


def write_units(np, params, path: str) -> float:
    """``params`` to ``path`` as one flat f32 ``.npy`` in unit order (each
    unit's leaves flattened in tree order), the order in which a row's
    parts cut them, leaf by leaf (no whole copy on the host); written
    beside the path and moved onto it whole, so that a rank that waits for
    it (`wait_for_file`) reads it complete. Its seconds."""
    from repro_torch.train import sharding
    from repro_torch.utils.treeutil import tree_leaves

    t0 = time.perf_counter()
    total = sum(p.numel() for p in tree_leaves(params))
    with open(path + ".part", "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": np.lib.format.dtype_to_descr(np.dtype(np.float32)),
                "fortran_order": False, "shape": (total,)})
        for _, unit in sharding.units_of(params):
            for leaf in tree_leaves(unit):
                leaf.detach().reshape(-1).cpu().numpy().tofile(f)
    os.replace(path + ".part", path)
    return time.perf_counter() - t0


def wait_for_file(path: str, timeout_s: float = 600.0) -> float:
    """Block until ``path`` exists (a one-process file that the parent
    writes while the world runs); the seconds waited."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def reference_sgd_step(torch, np, cfg, pipe, seed: int, path: str) -> dict:
    """`one_process_sgd_step`, its new parameters to ``path``
    (`write_units`), the card freed: the step's record."""
    params, ref = one_process_sgd_step(torch, cfg, pipe, seed)
    ref["write_s"] = write_units(np, params, path)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ref["seconds"] += ref["write_s"]
    return ref


def fsdp_train_rank(mesh, seed: int, ref_path: str) -> dict:
    """One rank of phase 8c's two-row world (run by `WORLDS`): qwen2.5-3b
    whole through `make_step` with the reference's default ``fsdp``
    ("auto", which must resolve on), this row's parts drawn unit by unit;
    one conventional SGD step (lr 1) on this row's sequence, with the
    kernel counts set to 0 just before and read just after; its phases,
    the FSDP gathers' and reduce-scatters' bytes and seconds, this rank's
    device peak (allocated and reserved), and every element of this row's
    parts against the one-process step's file, on the card."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    cfg = fsdp_config()
    model = build(cfg)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    # the reference's default: fsdp "auto", 6e9 bytes
    step = make_step(model, mesh, sgd, TrainStepConfig(), inplace=True)
    plan = step.fsdp
    out = {"row": mesh.row, "fsdp": plan is not None}
    if plan is None:
        return out
    parts = plan.shard_units(lambda u: model.init_unit(seed, u, param_dtype=torch.float32))
    opt = init_opt_state(sgd, parts)
    batch = row_shard(fsdp_pipeline(cfg, seed).global_batch(0), mesh.row, mesh.n_rows,
                      model.device)
    torch.cuda.synchronize()
    mesh.barrier()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    parts, opt, metrics = step(parts, opt, batch)
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0, loss=float(metrics["loss"]),
               launches={k: fn.launches for k, fn in counters.items()},
               timing=step.timings[-1], units=len(plan.units),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
               elements=[[u.spec.total, p.numel()] for p, u in zip(parts, plan.units)])
    del opt, batch
    # every element of this row's parts against the one-process step, on
    # the card (the file's slices read from its memory map, once the
    # parent has written it)
    out["ref_wait_s"] = wait_for_file(ref_path)
    ref = np.load(ref_path, mmap_mode="r")
    t0 = time.perf_counter()
    diff, off = 0.0, 0
    for part, unit in zip(parts, plan.units):
        lo = mesh.row * unit.part
        n = max(0, min(unit.part, unit.spec.total - lo))
        if n:
            want = torch.from_numpy(np.array(ref[off + lo:off + lo + n]))
            diff = max(diff, float((part[:n] - want.to(part.device)).abs().max()))
        off += unit.spec.total
    out.update(compare_s=time.perf_counter() - t0, max_abs_diff=diff,
               host_peak_gib=_host_peak_gib())
    del ref, parts
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    return out


def fsdp_phase(torch, np, seed: int, smi: str, tmp: str) -> dict:
    """Phase 8c: the one-process step in the parent, then the two-row
    world on the card, started while the parent writes the step's file (in
    ``tmp``; phase 8d reads it too); its line and checks: FSDP on by the
    default rule, the rows' losses equal and within 1e-5 relative of the
    one-process loss, every element of the world's step within `TRAIN_PARITY_REL` x
    max |gradient| of the one-process step, and the two ranks' peaks
    (reserved) below the card's 80 GB, printed beside the replicated
    two-row figure: the data-parallel step without FSDP holds the
    parameters, the momentum, the gradient and the gradient's flat copy
    for the all-reduce, 16 bytes a parameter a row."""
    gc.collect()
    torch.cuda.empty_cache()
    ref_path = os.path.join(tmp, "sgd_step.npy")
    cfg = fsdp_config()
    params, ref = one_process_sgd_step(torch, cfg, fsdp_pipeline(cfg, seed), seed)
    # the world starts on its parts while the parent writes the file,
    # which the ranks read only after their step (`wait_for_file`)
    t0 = time.perf_counter()
    world = WORLDS.start(fsdp_train_rank, FSDP_ROWS, args=(seed, ref_path), timeout_s=900)
    ref["write_s"] = write_units(np, params, ref_path)
    ref["seconds"] += ref["write_s"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_fsdp", "run": "one-process step", "model": FSDP_ARCH,
          "dtype": "f32", "seq_len": FSDP_SEQ, "global_batch": FSDP_BATCH, **ref,
          "written_beside_the_world": True,
          "parent_reserved_gib_after": torch.cuda.memory_reserved() / 2 ** 30,
          "nvidia_smi": smi})
    ranks = WORLDS.wait(world)
    world_s = time.perf_counter() - t0
    if not all(r["fsdp"] for r in ranks):
        raise AssertionError(f"train_fsdp: fsdp 'auto' did not resolve on for {FSDP_ARCH}")
    peaks = [r["peak_reserved_gib"] * 2 ** 30 for r in ranks]
    diff = max(r["max_abs_diff"] for r in ranks)
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    line = {"phase": "train_fsdp", "run": "sgd", "model": FSDP_ARCH, "rows": FSDP_ROWS,
            "mode": "conventional", "fsdp": True, "params": ref["params"],
            "units": ranks[0]["units"], "seq_len": FSDP_SEQ, "global_batch": FSDP_BATCH,
            "loss": ranks[0]["loss"], "one_process_loss": ref["loss"],
            "step_wall_s": max(r["wall_s"] for r in ranks),
            "per_rank": [{"row": r["row"], "wall_s": r["wall_s"], "peak_gib": r["peak_gib"],
                          "peak_reserved_gib": r["peak_reserved_gib"],
                          "phases_s": {k: r["timing"][k] for k in step_phases(r["timing"])},
                          "fsdp": {k: r["timing"][k] for k in FSDP_KEYS},
                          "wire": {k: r["timing"][k] for k in WIRE_KEYS},
                          "compare_s": r["compare_s"], "ref_wait_s": r["ref_wait_s"],
                          "host_peak_gib": r["host_peak_gib"]}
                         for r in ranks],
            "max_abs_diff": diff, "max_abs_grad": ref["max_abs_grad"],
            "rel": diff / ref["max_abs_grad"], "budget": TRAIN_PARITY_REL,
            "peak_reserved_sum_gb": sum(peaks) / 1e9, "card_gb": CARD_BYTES / 1e9,
            "replicated_gb": REPLICATED_BYTES_PER_PARAM * ref["params"] * FSDP_ROWS / 1e9,
            "world_s": world_s, "launches": dict(launches), "nvidia_smi": smi}
    emit(line)
    if any(r["loss"] != ranks[0]["loss"] for r in ranks):
        raise AssertionError("train_fsdp: the rows disagree on the loss")
    if not abs(line["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]):
        raise AssertionError(f"train_fsdp: the world's loss {line['loss']} is off the "
                             f"one-process loss {ref['loss']}")
    if not line["rel"] <= TRAIN_PARITY_REL:
        raise AssertionError(f"train_fsdp: the world's step is off the one-process step by "
                             f"{line['rel']} of max |gradient|, budget {TRAIN_PARITY_REL}")
    if not sum(peaks) < CARD_BYTES:
        raise AssertionError(f"train_fsdp: the two rows' peaks sum to {sum(peaks) / 1e9} GB, "
                             f"the card has {CARD_BYTES / 1e9}")
    out = dict.fromkeys(kernel_counters(), 0)
    out.update(launches)
    return {"launches": out, "seconds": world_s, "ref": ref, "ref_path": ref_path,
            "peak_reserved_sum_gb": line["peak_reserved_sum_gb"]}


# -- phase 8d: the model axis (tensor parallelism), on a (data, model) world --------

MODEL_WORLD = (2, 2)  # (data rows, model columns): four ranks on the card
MODEL_BATCH = 2  # (b): two sequences, both on the decoupled step's compute row
MODEL_KEYS = ("wire_model_collectives", "wire_model_collective_bytes",
              "wire_model_collective_s")


def column_diff(np, torch, ref_path: str, model, mesh, params, plan) -> float:
    """The largest difference, on the card, between this rank's parameters
    and the one-process file: each whole leaf's column slice (its spec),
    against the rank's leaf (``params`` a tree of the column's slices) or,
    under FSDP (``plan``), cut to this row's part of the column's flat unit
    (``params`` the parts)."""
    from repro_torch.train import sharding
    from repro_torch.train.train_step import param_shapes
    from repro_torch.utils.treeutil import tree_leaves

    ref = np.load(ref_path, mmap_mode="r")
    units = sharding.units_of(param_shapes(model, whole=True))
    held = params if plan is not None else [tree_leaves(u) for _, u in sharding.units_of(params)]
    diff, off = 0.0, 0
    for i, ((name, tree), part) in enumerate(zip(units, held)):
        specs = model.unit_specs(name, tree)
        span = plan.units[i].span if plan is not None else None
        loc = 0
        for j, (leaf, spec) in enumerate(zip(tree_leaves(tree), specs)):
            whole = ref[off:off + leaf.numel()].reshape(tuple(leaf.shape))
            local = sharding.model_shard(whole, spec, mesh.model_size, mesh.col).reshape(-1)
            if span is None:
                lo, hi, got = loc, loc + local.size, part[j].reshape(-1)
            else:
                lo, hi = max(loc, span.start), min(loc + local.size, span.stop)
                got = part[lo - span.start:hi - span.start] if lo < hi else None
            if lo < hi:
                want = torch.from_numpy(np.array(local[lo - loc:hi - loc])).to(got.device)
                diff = max(diff, float((got - want).abs().max()))
            loc += local.size
            off += leaf.numel()
    return diff


def model_fsdp_rank(mesh, seed: int, ref_path: str) -> dict:
    """One rank of phase 8d (a): qwen2.5-3b whole on the (2, 2) world,
    built for this rank's column (`build(tp=mesh)`), through `make_step`
    with the reference's default ``TrainStepConfig()``, whose FSDP
    ("auto", over the column's slices) must resolve on: 12.34e9 B / 2
    columns > 6e9. This rank's parts drawn unit by unit (each unit whole
    from the seed, its column slice kept, its row's part of that); one
    conventional SGD step (lr 1) on its row's sequence, with the kernel
    counts at 0 just before and read just after; its phases, the data
    axis's gathers and reduce-scatters and the model axis's collectives,
    its device peaks, and every element of its parts against the slice
    of phase 8c's one-process file that its spec and FSDP part name."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    cfg = fsdp_config()
    model = build(cfg, tp=mesh)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    step = make_step(model, mesh, sgd, TrainStepConfig(), inplace=True)
    plan = step.fsdp
    out = {"rank": mesh.rank, "row": mesh.row, "col": mesh.col, "fsdp": plan is not None}
    if plan is None:
        return out
    parts = plan.shard_units(lambda u: model.init_unit(seed, u, param_dtype=torch.float32))
    opt = init_opt_state(sgd, parts)
    batch = row_shard(fsdp_pipeline(cfg, seed).global_batch(0), mesh.row, mesh.n_rows,
                      model.device)
    torch.cuda.synchronize()
    mesh.barrier()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    parts, opt, metrics = step(parts, opt, batch)
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0, loss=float(metrics["loss"]),
               launches={k: fn.launches for k, fn in counters.items()},
               timing=step.timings[-1], units=len(plan.units),
               column_elements=sum(u.spec.total for u in plan.units),
               part_elements=sum(p.numel() for p in parts),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30)
    del opt, batch
    t0 = time.perf_counter()
    diff = column_diff(np, torch, ref_path, model, mesh, parts, plan)
    out.update(compare_s=time.perf_counter() - t0, max_abs_diff=diff,
               host_peak_gib=_host_peak_gib())
    del parts
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    return out


def model_modes_rank(mesh, seed: int) -> dict:
    """One rank of phase 8d (b): qwen1.5-0.5b at full width and phase 8's
    depth on the (2, 2) world, FSDP off by the default rule; one SGD step
    (lr 1, f32) of the decoupled (one reducer row a column: ``reduce_alpha``
    0.5), the conventional and the overlap step on the decoupled layout's
    batch, each with the kernel counts at 0 just before and read just
    after; row 0 gathers each step's parameters whole over the model axis,
    and rank 0 holds them against the conventional step of one process on
    the same global batch, as phase 8 does."""
    import torch

    from repro_torch.configs import get
    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (
        TrainStepConfig,
        build_conventional_step,
        make_step,
        param_shapes,
    )
    from repro_torch.utils.treeutil import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    cfg = dataclasses.replace(get("qwen1.5-0.5b"), n_layers=TRAIN_LAYERS, dtype=torch.float32)
    model = build(cfg, tp=mesh)
    specs = sharding.spec_list(param_shapes(model, whole=True), mesh.model_size)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=MODEL_BATCH, seed=seed, kind="zipf", skew=0.4))
    n = mesh.n_rows
    batch = row_shard(pipe.padded_for_groups(0, n - 1, n), mesh.row, n, model.device)
    params = model.init(seed, param_dtype=torch.float32)
    out = {"rank": mesh.rank, "row": mesh.row, "col": mesh.col, "runs": {},
           "params": sum(p.numel() for p in tree_leaves(params))}
    news = {}
    for mode, ts in (("decoupled", TrainStepConfig(mode="decoupled", reduce_alpha=0.5,
                                                   wire_chunk_bytes=TRAIN_CHUNK_BYTES)),
                     ("conventional", TrainStepConfig()),
                     ("overlap", TrainStepConfig(mode="overlap"))):
        step = make_step(model, mesh, sgd, ts)
        opt = init_opt_state(sgd, params)
        if mode == "overlap":
            opt = sharding.shard_opt_state(sharding.zero1_plan(params, n, mesh.row), opt)
        torch.cuda.synchronize()
        mesh.barrier()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        new, _, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        out["runs"][mode] = {"wall_s": time.perf_counter() - t0, "loss": float(metrics["loss"]),
                             "fsdp": step.fsdp is not None,
                             "launches": {k: fn.launches for k, fn in counters.items()},
                             "timing": step.timings[-1],
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del opt
        if mesh.row == 0:  # row 0's columns gather; rank 0 keeps the whole tree
            whole = sharding.gather_model(new, specs, mesh)
            if mesh.col == 0:
                news[mode] = whole
            del whole
        del new
        gc.collect()
        torch.cuda.empty_cache()
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    if mesh.rank == 0:  # the others leave the card to the one-process step
        pmodel = build(cfg)
        whole = pmodel.init(seed, param_dtype=torch.float32)
        t0 = time.perf_counter()
        conv, _, cmetrics = build_conventional_step(pmodel, sgd)(
            whole, init_opt_state(sgd, whole),
            {k: v.to(pmodel.device) for k, v in pipe.global_batch(0).items()})
        torch.cuda.synchronize()
        out["one_process_s"] = time.perf_counter() - t0
        gmax = max((a - b).abs().max().item()
                   for a, b in zip(tree_leaves(whole), tree_leaves(conv)))
        for mode, new in news.items():
            diff = max((a - b).abs().max().item()
                       for a, b in zip(tree_leaves(new), tree_leaves(conv)))
            out["runs"][mode].update(max_abs_diff=diff, max_abs_grad=gmax, rel=diff / gmax,
                                     one_process_loss=float(cmetrics["loss"]))
        del whole, conv, news, pmodel
        gc.collect()
        torch.cuda.empty_cache()
    mesh.barrier()
    return out


MOE_AXIS_ARCH = "mixtral-8x7b"
MOE_AXIS_LAYERS = 1  # of 32: 1,713,418,240 f32 parameters, 6.85 GB
MOE_AXIS_SEQ, MOE_AXIS_BATCH = 1536, 2  # phase 8b's: the second 1,024-token group straddles the rows
MOE_METRICS = ("loss", "aux_loss", "router_entropy")
# (run, step config, optimizer): one step each. The conventional step under
# the default config (FSDP "auto", off) and the decoupled step with FSDP
# over each column's expert slices, both SGD (lr 1) and held element by
# element; the overlap step (ZeRO-1, FSDP "auto", off) under phase 8b's
# AdamW, then the loss of global batch 1 on the parameters it left (one
# forward: step 2's loss, without step 2's gradient and update), held to
# one process's
MOE_AXIS_RUNS = (("conventional", dict(), "sgd"),
                 ("decoupled", dict(mode="decoupled", reduce_alpha=0.5,
                                    wire_chunk_bytes=TRAIN_CHUNK_BYTES, fsdp=True), "sgd"),
                 ("overlap", dict(mode="overlap"), "adamw"))


def moe_axis_config():
    """mixtral-8x7b at full width, 1 of its 32 layers, computing in f32."""
    import torch

    from repro_torch.configs import get

    return dataclasses.replace(get(MOE_AXIS_ARCH), n_layers=MOE_AXIS_LAYERS,
                               dtype=torch.float32)


def moe_axis_pipeline(cfg, seed: int):
    from repro_torch.data.pipeline import DataConfig, Pipeline

    return Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=MOE_AXIS_SEQ,
                               global_batch=MOE_AXIS_BATCH, seed=seed, kind="zipf", skew=0.4))


def moe_axis_opt(name: str):
    """8d (c)'s optimizers: SGD with lr 1 (the new parameters are the
    gradient's), and phase 8b's AdamW (warm-up, clip, decay)."""
    from repro_torch.train.optimizer import OptConfig

    if name == "sgd":
        return OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                         weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    return OptConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)


def reference_adamw_step(torch, cfg, pipe, seed: int) -> dict:
    """One process, in the parent alone: ``cfg`` whole from the per-unit
    draw, one conventional step of `moe_axis_opt`'s AdamW on ``pipe``'s
    global batch 0, then one forward of global batch 1 on the parameters it
    left: the step's metrics and the forward's. The card is freed before it
    returns."""
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import build_conventional_step

    model = build(cfg)
    adamw = moe_axis_opt("adamw")
    t0 = time.perf_counter()
    params = sharding.join_units(
        (u, model.init_unit(seed, u, param_dtype=torch.float32)) for u in model.units)
    opt = init_opt_state(adamw, params)
    step = build_conventional_step(model, adamw, inplace=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch = {k: v.to(model.device) for k, v in pipe.global_batch(0).items()}
    params, opt, metrics = step(params, opt, batch)
    out = {"step": {k: float(metrics[k]) for k in MOE_METRICS}}
    batch = {k: v.to(model.device) for k, v in pipe.global_batch(1).items()}
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
    out["next"] = {"loss": float(loss), **{k: float(metrics[k]) for k in MOE_METRICS[1:]}}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batch, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "seconds": time.perf_counter() - t0, "peak_gib": peak / 2 ** 30}


def world_loss(mesh, model, params, batch) -> dict:
    """The loss, aux_loss and router_entropy that a data-parallel step
    would report for ``batch`` (this row's part) at ``params``, by one
    forward without gradients: each row's tokens routed over its column's
    rows (`moe.RouteWorld`), the rows' cross-entropy sums added over the
    world (the aux metrics are the world's already)."""
    import torch

    from repro_torch.models import moe

    with torch.no_grad():
        _, metrics = model.loss(params, batch, route_world=moe.RouteWorld(mesh))
    cnt = batch["mask"].sum().float()
    sums = mesh.all_reduce(torch.stack([metrics["ce"].float() * cnt, cnt]).cpu())
    return {"loss": float(sums[0]) / max(float(sums[1]), 1.0) + 0.01 * float(metrics["aux_loss"]),
            **{k: float(metrics[k]) for k in MOE_METRICS[1:]}}


def model_moe_rank(mesh, seed: int, ref_path: str) -> dict:
    """One rank of phase 8d (c): mixtral-8x7b at full width and 1 layer on
    the (2, 2) world, built for this rank's column (its 4 of the 8 experts,
    the router's 4 columns of them, `build(tp=mesh)`). The steps of
    `MOE_AXIS_RUNS`, each from this rank's column slices drawn unit by unit
    from ``seed``, each row routing its part of global batch 0 over its
    column's rows (the decoupled step's one compute row holding both
    sequences, one reducer row a column). Each with the kernel counts at 0
    just before and read just after: its loss, aux_loss and
    router_entropy, its phases, the data axis's gathers and
    reduce-scatters, the model axis's collectives, its device peaks; after
    an SGD step every element against the column slice (and FSDP part) of
    the one-process file, after the AdamW step `world_loss` of global
    batch 1."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.utils.treeutil import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    cfg = moe_axis_config()
    model = build(cfg, tp=mesh)
    pipe = moe_axis_pipeline(cfg, seed)
    n = mesh.n_rows
    out = {"rank": mesh.rank, "row": mesh.row, "col": mesh.col, "runs": {}}
    for run, ts_kw, opt_name in MOE_AXIS_RUNS:
        ts, opt_cfg = TrainStepConfig(**ts_kw), moe_axis_opt(opt_name)
        step = make_step(model, mesh, opt_cfg, ts, inplace=True)
        plan = step.fsdp
        if plan is not None:
            params = plan.shard_units(
                lambda u: model.init_unit(seed, u, param_dtype=torch.float32))
        else:
            params = sharding.join_units(
                (u, model.init_unit(seed, u, param_dtype=torch.float32)) for u in model.units)
        opt = init_opt_state(opt_cfg, params)
        if ts.mode == "overlap" and plan is None:
            opt = sharding.shard_opt_state(sharding.zero1_plan(params, n, mesh.row), opt)
        batch = row_shard(pipe.padded_for_groups(0, 1, n) if ts.mode == "decoupled" else
                          pipe.global_batch(0), mesh.row, n, model.device)
        gc.collect()  # the whole units drawn for the slices go back to the card
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        mesh.barrier()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        held = params if plan is not None else tree_leaves(params)
        rec = {"wall_s": time.perf_counter() - t0, "fsdp": plan is not None,
               **{k: float(metrics[k]) for k in MOE_METRICS},
               "launches": {k: fn.launches for k, fn in counters.items()},
               "timing": step.timings[-1],
               "elements": sum(p.numel() for p in held),
               "finite": all(bool(torch.isfinite(p).all()) for p in held),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
        del opt, batch, held
        t0 = time.perf_counter()
        if opt_name == "sgd":
            rec["max_abs_diff"] = column_diff(np, torch, ref_path, model, mesh, params, plan)
        else:
            rec["next"] = world_loss(mesh, model, params, row_shard(
                pipe.global_batch(1), mesh.row, n, model.device))
        rec["compare_s"] = time.perf_counter() - t0
        rec["host_peak_gib"] = _host_peak_gib()
        out["runs"][run] = rec
        del params, step
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
    return out


def rank_timing(timings: list) -> dict:
    """A rank's record of a run's steps, summed over them: the step's
    phases, the data axis's FSDP gathers and reduce-scatters, the model
    axis's collectives and the wire (count, bytes, seconds)."""
    return {"phases_s": {k: sum(t[k] for t in timings) for k in step_phases(timings[0])},
            "fsdp": {k: sum(t.get(k, 0) for t in timings) for k in FSDP_KEYS},
            "model_axis": {k: sum(t[k] for t in timings) for k in MODEL_KEYS},
            "wire": {k: sum(t[k] for t in timings) for k in WIRE_KEYS}}


def check_model_run(what: str, line: dict, recs: list, *, want_fsdp: bool,
                    reducers: set, peaks: list | None = None) -> None:
    """The checks of a run of phase 8d's (2, 2) world (``recs``, a rank's
    record each; ``line``, its JSON line), raising AssertionError: FSDP
    resolved ``want_fsdp`` on every rank; the ranks' losses equal; every
    element within `TRAIN_PARITY_REL` x max |gradient| of one process
    (``line["rel"]``, where the run is held element by element);
    chunk_accumulate once on each rank of ``reducers`` and never elsewhere
    (``line["chunk_accumulate_by_rank"]``); the ranks' reserved ``peaks``
    (bytes) under the card's memory."""
    if any(r["fsdp"] != want_fsdp for r in recs):
        raise AssertionError(f"{what}: FSDP resolved {[r['fsdp'] for r in recs]} by rank, "
                             f"want {want_fsdp}")
    if any(r["loss"] != recs[0]["loss"] for r in recs):
        raise AssertionError(f"{what}: the ranks disagree on the loss")
    if "rel" in line and not line["rel"] <= TRAIN_PARITY_REL:
        raise AssertionError(f"{what}: off the one-process step by {line['rel']} of max "
                             f"|gradient|, budget {TRAIN_PARITY_REL}")
    by_rank = line["chunk_accumulate_by_rank"]
    want = {rank: int(rank in reducers) for rank in by_rank}
    if by_rank != want:
        raise AssertionError(f"{what}: chunk_accumulate launches {by_rank}, expected {want} "
                             f"(once on each column's reducer in the decoupled step)")
    if peaks is not None and not sum(peaks) < CARD_BYTES:
        raise AssertionError(f"{what}: the four ranks' peaks sum to {sum(peaks) / 1e9} GB, "
                             f"the card has {CARD_BYTES / 1e9}")


def moe_axis_refs(torch, np, seed: int, smi: str, tmp: str, mixtral_overlap: dict) -> dict:
    """Phase 8d (c)'s one process, in the parent: mixtral's one layer, an
    SGD step to a file in ``tmp`` and an AdamW step with the loss of the
    next batch after it, the card freed after each; its line, and phase
    8b's two-row overlap step (``mixtral_overlap``: its peaks, loss,
    aux_loss and router_entropy on the same weights and batch) held to it
    (`MOE_ROUTING_REL`)."""
    cfg = moe_axis_config()
    pipe = moe_axis_pipeline(cfg, seed)
    ref_path = os.path.join(tmp, "moe_sgd_step.npy")
    gc.collect()
    torch.cuda.empty_cache()
    ref = reference_sgd_step(torch, np, cfg, pipe, seed, ref_path)
    adamw = reference_adamw_step(torch, cfg, pipe, seed)
    routing = {k: abs(mixtral_overlap[k] - ref[k]) / abs(ref[k]) for k in MOE_METRICS}
    emit({"phase": "train_model", "run": "moe one-process step", "model": MOE_AXIS_ARCH,
          "layers": MOE_AXIS_LAYERS, "dtype": "f32", "seq_len": MOE_AXIS_SEQ,
          "global_batch": MOE_AXIS_BATCH, **ref, "adamw": adamw,
          "phase_8b_overlap_step1_rel": routing, "phase_8b_overlap_budget": MOE_ROUTING_REL,
          "parent_reserved_gib_after": torch.cuda.memory_reserved() / 2 ** 30,
          "nvidia_smi": smi})
    if not all(v <= MOE_ROUTING_REL for v in routing.values()):
        raise AssertionError(f"train_families: mixtral's overlap step 1 (phase 8b) is off the "
                             f"one-process step: {routing}, budget {MOE_ROUTING_REL}")
    return {"ref": ref, "adamw": adamw, "path": ref_path,
            "seconds": ref["seconds"] + adamw["seconds"]}


def moe_axis_part(torch, np, seed: int, smi: str, one: dict, mixtral_overlap: dict) -> dict:
    """Phase 8d (c): the (2, 2) world (`model_moe_rank`) against the one
    process (``one``, `moe_axis_refs`); a line a run and its checks
    (`check_model_run`):
    FSDP off by "auto" in the conventional and overlap steps and on as
    asked in the decoupled one; every element of the SGD steps within
    `TRAIN_PARITY_REL` x max |gradient| of the one process; the loss,
    aux_loss and router_entropy equal on every rank and within
    `MOE_ROUTING_REL` of the one process's, the next batch's loss after
    the overlap AdamW step (an update on ZeRO-1's parts) within
    `OVERLAP_LOSS_REL` of the one process's; finite parameters;
    `chunk_accumulate` once on each column's reducer in the decoupled
    step, which receives `MOE_AXIS_FOLD` f32 values, and never elsewhere;
    the four ranks' reserved peaks under 80 GB, printed beside phase 8b's
    two-row mixtral peaks. ``mixtral_overlap``: phase 8b's overlap step on
    the same weights and batch (its peaks, loss, aux_loss and
    router_entropy), whose metrics `moe_axis_refs` held to the one
    process's."""
    ref, adamw, ref_path = one["ref"], one["adamw"], one["path"]
    data, cols = MODEL_WORLD
    t0 = time.perf_counter()
    ranks = WORLDS.run(model_moe_rank, data, model=cols, args=(seed, ref_path), timeout_s=900)
    world_s = time.perf_counter() - t0
    os.remove(ref_path)
    counts = dict.fromkeys(kernel_counters(), 0)
    reducers = {r["rank"] for r in ranks if r["row"] == data - 1}
    for run, ts_kw, opt_name in MOE_AXIS_RUNS:
        what = f"train_model moe {run} {opt_name}"
        recs = [r["runs"][run] for r in ranks]
        for rec in recs:
            for k, v in rec["launches"].items():
                counts[k] += v
        peaks = [rec["peak_reserved_gib"] * 2 ** 30 for rec in recs]
        want = ref if opt_name == "sgd" else adamw["step"]
        rels = {k: abs(recs[0][k] - want[k]) / abs(want[k]) for k in MOE_METRICS}
        line = {"phase": "train_model", "run": f"moe {run} {opt_name}", "model": MOE_AXIS_ARCH,
                "layers": MOE_AXIS_LAYERS, "world": {"data": data, "model": cols},
                "mode": ts_kw.get("mode", "conventional"), "optimizer": opt_name,
                "fsdp": recs[0]["fsdp"], "params": ref["params"], "seq_len": MOE_AXIS_SEQ,
                "global_batch": MOE_AXIS_BATCH,
                **{k: recs[0][k] for k in MOE_METRICS},
                "one_process": {k: want[k] for k in MOE_METRICS},
                "metric_rel": rels, "metric_budget": MOE_ROUTING_REL,
                "step_wall_s": max(rec["wall_s"] for rec in recs),
                "per_rank": [{"rank": r["rank"], "row": r["row"], "col": r["col"],
                              **{k: rec[k] for k in ("wall_s", "elements", "peak_gib",
                                                     "peak_reserved_gib", "compare_s",
                                                     "host_peak_gib")},
                              **rank_timing([rec["timing"]])}
                             for r, rec in zip(ranks, recs)],
                "chunk_accumulate_by_rank": {r["rank"]: rec["launches"]["chunk_accumulate"]
                                             for r, rec in zip(ranks, recs)},
                "peak_reserved_sum_gb": sum(peaks) / 1e9,
                "phase_8b_mixtral_peak_reserved_gib": mixtral_overlap["peak_reserved_gib"],
                "card_gb": CARD_BYTES / 1e9, "world_s": world_s, "nvidia_smi": smi}
        if opt_name == "sgd":
            diff = max(rec["max_abs_diff"] for rec in recs)
            line.update(max_abs_diff=diff, max_abs_grad=ref["max_abs_grad"],
                        rel=diff / ref["max_abs_grad"], budget=TRAIN_PARITY_REL)
        else:  # the next batch's loss after the update
            line.update(next=recs[0]["next"], one_process_next=adamw["next"],
                        next_loss_rel=abs(recs[0]["next"]["loss"] - adamw["next"]["loss"])
                        / abs(adamw["next"]["loss"]), next_loss_budget=OVERLAP_LOSS_REL)
        if run == "decoupled":
            line["fold_values_by_rank"] = {r["rank"]: rec["timing"]["wire_recv_bytes"] // 4
                                           for r, rec in zip(ranks, recs)}
            line["fold_values_expected"] = MOE_AXIS_FOLD
        emit(line)
        check_model_run(what, line, recs, want_fsdp=run == "decoupled",
                        reducers=reducers if run == "decoupled" else set(), peaks=peaks)
        for k in MOE_METRICS:
            if any(rec[k] != recs[0][k] for rec in recs):
                raise AssertionError(f"{what}: the ranks disagree on {k}")
        if not all(v <= MOE_ROUTING_REL for v in rels.values()):
            raise AssertionError(f"{what}: off the one-process metrics by {rels}, budget "
                                 f"{MOE_ROUTING_REL}")
        if "next" in line:
            if any(rec["next"] != recs[0]["next"] for rec in recs):
                raise AssertionError(f"{what}: the ranks disagree on the next batch's loss")
            if not line["next_loss_rel"] <= OVERLAP_LOSS_REL:
                raise AssertionError(f"{what}: the next batch's loss after the update is off "
                                     f"the one process's by {line['next_loss_rel']}, budget "
                                     f"{OVERLAP_LOSS_REL}")
        if not all(rec["finite"] for rec in recs):
            raise AssertionError(f"{what}: non-finite parameters")
        if run == "decoupled":
            got = {rank: v for rank, v in line["fold_values_by_rank"].items() if rank in reducers}
            if any(v != MOE_AXIS_FOLD for v in got.values()):
                raise AssertionError(f"{what}: the reducers folded {got} f32 values, the "
                                     f"kernels phase times chunk_accumulate at "
                                     f"{MOE_AXIS_FOLD} (MOE_AXIS_FOLD)")
    return {"launches": counts, "seconds": world_s}


# phase 8d (d): the model axis for the SSM, hybrid and encoder-decoder
# families, f32, TF32 off, each part one step on the (2, 2) world held to
# its own one-process step on the same weights and global batch. (part,
# architecture, layers (None: whole), text tokens a sequence, step config,
# optimizer). (d1) hymba-1.5b at full width and phase 8b's depth (global
# layer 0, then sliding-window layers; 25 / 5 heads take the gathered
# projections, the odd vocabulary of 32,001 keeps both tables whole), FSDP
# "auto" (off: 0.49e9 parameters); (d2) mamba2-130m whole, the decoupled
# step under FSDP over each column's slices, its stream folded with
# chunk_accumulate once on each column's reducer; (d3) whisper-small whole,
# 1,500 frames before 448 decoder tokens, the overlap step (ZeRO-1)
AXIS_FAMILY_PARTS = (
    ("d1", "hymba-1.5b", 8, 2048, dict(), "sgd"),
    ("d2", "mamba2-130m", None, 1024,
     dict(mode="decoupled", reduce_alpha=0.5, wire_chunk_bytes=TRAIN_CHUNK_BYTES, fsdp=True),
     "sgd"),
    ("d3", "whisper-small", None, 448, dict(mode="overlap"), "sgd"),
)
AXIS_FAMILY_BATCH = 2


def axis_family_config(arch: str, layers):
    import torch

    from repro_torch.configs import get

    cfg = get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, dtype=torch.float32)


def axis_family_pipeline(cfg, seq: int, seed: int):
    from repro_torch.data.pipeline import DataConfig, Pipeline

    return Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=AXIS_FAMILY_BATCH, seed=seed, kind="zipf",
                               skew=0.4, frontend=cfg.frontend,
                               n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model))


def model_family_rank(mesh, seed: int, ref_paths: dict) -> dict:
    """One rank of phase 8d (d): each part of `AXIS_FAMILY_PARTS` on the
    (2, 2) world, built for this rank's column (`build(tp=mesh)`), from
    this rank's column slices (or FSDP parts) drawn unit by unit from
    ``seed``, one SGD step (lr 1) on its row's part of global batch 0 (the
    decoupled step's one compute row holding both sequences), with the
    kernel counts at 0 just before and read just after: its loss, phases,
    the data axis's gathers and reduce-scatters, the model axis's
    collectives, its device peaks, and every element against the column
    slice (and FSDP part) of the part's one-process file in ``ref_paths``."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.utils.treeutil import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    n = mesh.n_rows
    out = {"rank": mesh.rank, "row": mesh.row, "col": mesh.col, "parts": {}}
    for part, arch, layers, seq, ts_kw, opt_name in AXIS_FAMILY_PARTS:
        cfg = axis_family_config(arch, layers)
        model = build(cfg, tp=mesh)
        ts, opt_cfg = TrainStepConfig(**ts_kw), moe_axis_opt(opt_name)
        step = make_step(model, mesh, opt_cfg, ts, inplace=True)
        plan = step.fsdp
        if plan is not None:
            params = plan.shard_units(
                lambda u: model.init_unit(seed, u, param_dtype=torch.float32))
        else:
            params = sharding.join_units(
                (u, model.init_unit(seed, u, param_dtype=torch.float32)) for u in model.units)
        opt = init_opt_state(opt_cfg, params)
        if ts.mode == "overlap" and plan is None:
            opt = sharding.shard_opt_state(sharding.zero1_plan(params, n, mesh.row), opt)
        pipe = axis_family_pipeline(cfg, seq, seed)
        batch = row_shard(pipe.padded_for_groups(0, 1, n) if ts.mode == "decoupled" else
                          pipe.global_batch(0), mesh.row, n, model.device)
        gc.collect()  # the whole units drawn for the slices go back to the card
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        mesh.barrier()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        held = params if plan is not None else tree_leaves(params)
        rec = {"wall_s": time.perf_counter() - t0, "fsdp": plan is not None,
               "loss": float(metrics["loss"]),
               "launches": {k: fn.launches for k, fn in counters.items()},
               "timing": step.timings[-1],
               "elements": sum(p.numel() for p in held),
               "finite": all(bool(torch.isfinite(p).all()) for p in held),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
        del opt, batch, held
        t0 = time.perf_counter()
        rec["max_abs_diff"] = column_diff(np, torch, ref_paths[part], model, mesh, params, plan)
        rec["compare_s"] = time.perf_counter() - t0
        rec["host_peak_gib"] = _host_peak_gib()
        out["parts"][part] = rec
        del params, step, model
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
    return out


def family_axis_refs(torch, np, seed: int, tmp: str) -> dict:
    """Phase 8d (d)'s one processes, in the parent: each part's SGD step to
    a file in ``tmp``, the card freed after each (`reference_sgd_step`);
    their records, their files and their seconds."""
    refs, paths = {}, {}
    t_ref = 0.0
    for part, arch, layers, seq, _, _ in AXIS_FAMILY_PARTS:
        cfg = axis_family_config(arch, layers)
        paths[part] = os.path.join(tmp, f"family_{part}_sgd_step.npy")
        gc.collect()
        torch.cuda.empty_cache()
        refs[part] = reference_sgd_step(torch, np, cfg, axis_family_pipeline(cfg, seq, seed),
                                        seed, paths[part])
        t_ref += refs[part]["seconds"]
    return {"refs": refs, "paths": paths, "seconds": t_ref}


def family_axis_part(torch, np, seed: int, smi: str, one: dict) -> dict:
    """Phase 8d (d): the (2, 2) world (`model_family_rank`) takes every
    part, each held to its one process (``one``, `family_axis_refs`); a
    line a part and its checks (`check_model_run`): FSDP off by "auto" in (d1) and (d3) and on as
    asked in (d2); every element within `TRAIN_PARITY_REL` x max |gradient|
    of the one process; the loss equal on every rank and within 1e-5
    relative of the one process's; finite parameters; `chunk_accumulate`
    once on each column's reducer in (d2), which receives `SSM_AXIS_FOLD`
    f32 values, and never elsewhere; the four ranks' reserved peaks under
    80 GB."""
    refs, paths = one["refs"], one["paths"]
    data, cols = MODEL_WORLD
    t0 = time.perf_counter()
    ranks = WORLDS.run(model_family_rank, data, model=cols, args=(seed, paths), timeout_s=900)
    world_s = time.perf_counter() - t0
    for path in paths.values():
        os.remove(path)
    counts = dict.fromkeys(kernel_counters(), 0)
    reducers = {r["rank"] for r in ranks if r["row"] == data - 1}
    for part, arch, layers, seq, ts_kw, opt_name in AXIS_FAMILY_PARTS:
        what = f"train_model {part} {arch}"
        ref = refs[part]
        recs = [r["parts"][part] for r in ranks]
        for rec in recs:
            for k, v in rec["launches"].items():
                counts[k] += v
        peaks = [rec["peak_reserved_gib"] * 2 ** 30 for rec in recs]
        mode = ts_kw.get("mode", "conventional")
        diff = max(rec["max_abs_diff"] for rec in recs)
        line = {"phase": "train_model", "run": f"{part} {mode} {opt_name}", "model": arch,
                "layers": layers or axis_family_config(arch, None).n_layers,
                "world": {"data": data, "model": cols}, "mode": mode, "optimizer": opt_name,
                "fsdp": recs[0]["fsdp"], "params": ref["params"], "seq_len": seq,
                "global_batch": AXIS_FAMILY_BATCH, "loss": recs[0]["loss"],
                "one_process_loss": ref["loss"],
                "loss_rel": abs(recs[0]["loss"] - ref["loss"]) / abs(ref["loss"]),
                "one_process_s": ref["seconds"], "one_process_step_s": ref["step_s"],
                "one_process_peak_gib": ref["peak_gib"],
                "step_wall_s": max(rec["wall_s"] for rec in recs),
                "per_rank": [{"rank": r["rank"], "row": r["row"], "col": r["col"],
                              **{k: rec[k] for k in ("wall_s", "elements", "peak_gib",
                                                     "peak_reserved_gib", "compare_s",
                                                     "host_peak_gib")},
                              **rank_timing([rec["timing"]])}
                             for r, rec in zip(ranks, recs)],
                "chunk_accumulate_by_rank": {r["rank"]: rec["launches"]["chunk_accumulate"]
                                             for r, rec in zip(ranks, recs)},
                "max_abs_diff": diff, "max_abs_grad": ref["max_abs_grad"],
                "rel": diff / ref["max_abs_grad"], "budget": TRAIN_PARITY_REL,
                "peak_reserved_sum_gb": sum(peaks) / 1e9, "card_gb": CARD_BYTES / 1e9,
                "world_s": world_s, "nvidia_smi": smi}
        if mode == "decoupled":
            line["fold_values_by_rank"] = {r["rank"]: rec["timing"]["wire_recv_bytes"] // 4
                                           for r, rec in zip(ranks, recs)}
            line["fold_values_expected"] = SSM_AXIS_FOLD
        emit(line)
        check_model_run(what, line, recs, want_fsdp=bool(ts_kw.get("fsdp")),
                        reducers=reducers if mode == "decoupled" else set(), peaks=peaks)
        if not line["loss_rel"] <= 1e-5:
            raise AssertionError(f"{what}: the world's loss {line['loss']} is off the "
                                 f"one-process loss {ref['loss']}")
        if not all(rec["finite"] for rec in recs):
            raise AssertionError(f"{what}: non-finite parameters")
        if mode == "decoupled":
            got = {rank: v for rank, v in line["fold_values_by_rank"].items() if rank in reducers}
            if any(v != SSM_AXIS_FOLD for v in got.values()):
                raise AssertionError(f"{what}: the reducers folded {got} f32 values, the "
                                     f"kernels phase times chunk_accumulate at "
                                     f"{SSM_AXIS_FOLD} (SSM_AXIS_FOLD)")
    return {"launches": counts, "seconds": world_s}


def model_axis_phase(torch, np, seed: int, smi: str, fsdp: dict, tmp: str,
                     mixtral_overlap: dict) -> dict:
    """Phase 8d: (a) qwen2.5-3b whole under FSDP over a model axis of 2,
    held to phase 8c's one-process step (``fsdp``: 8c's result, its file
    and loss): FSDP on by the default rule, every rank's loss equal and
    within 1e-5 relative of the one-process loss, every element within
    `TRAIN_PARITY_REL` x max |gradient|, the four ranks' reserved peaks
    under the card's 80 GB; (b) the paper's decoupled step, the
    conventional and the overlap step of qwen1.5-0.5b on the model axis,
    each within `TRAIN_PARITY_REL` x max |gradient| of one process, with
    ``chunk_accumulate`` launched once a wave on each column's reducer
    (waves x columns) and never in the other modes; (c) the MoE family's
    model axis, mixtral-8x7b's experts over the columns (`moe_axis_part`;
    ``tmp`` holds its one-process file, ``mixtral_overlap`` is phase 8b's
    two-row mixtral step); (d) the SSM, hybrid and encoder-decoder
    families' (`family_axis_part`). The parent takes (d)'s one-process
    steps while (a)'s world runs, and (c)'s while (b)'s runs: (a) and (b)
    leave most of the card free, (c)'s world does not."""

    data, cols = MODEL_WORLD
    ref = fsdp["ref"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world = WORLDS.start(model_fsdp_rank, data, model=cols, args=(seed, fsdp["ref_path"]),
                         timeout_s=900)
    fam_one = family_axis_refs(torch, np, seed, tmp)
    ranks = WORLDS.wait(world)
    fsdp_s = time.perf_counter() - t0
    peaks = [r["peak_reserved_gib"] * 2 ** 30 for r in ranks]
    diff = max(r["max_abs_diff"] for r in ranks)
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    line = {"phase": "train_model", "run": "fsdp sgd", "model": FSDP_ARCH,
            "world": {"data": data, "model": cols}, "mode": "conventional", "fsdp": True,
            "params": ref["params"], "units": ranks[0]["units"], "seq_len": FSDP_SEQ,
            "global_batch": FSDP_BATCH, "loss": ranks[0]["loss"],
            "one_process_loss": ref["loss"], "step_wall_s": max(r["wall_s"] for r in ranks),
            "per_rank": [{k: r[k] for k in ("rank", "row", "col", "wall_s", "peak_gib",
                                            "peak_reserved_gib", "column_elements",
                                            "part_elements", "compare_s", "host_peak_gib")}
                         | rank_timing([r["timing"]]) for r in ranks],
            "chunk_accumulate_by_rank": {r["rank"]: r["launches"]["chunk_accumulate"]
                                         for r in ranks},
            "max_abs_diff": diff, "max_abs_grad": ref["max_abs_grad"],
            "rel": diff / ref["max_abs_grad"], "budget": TRAIN_PARITY_REL,
            "peak_reserved_sum_gb": sum(peaks) / 1e9,
            "phase_8c_peak_reserved_sum_gb": fsdp["peak_reserved_sum_gb"],
            "card_gb": CARD_BYTES / 1e9, "world_s": fsdp_s, "launches": dict(launches),
            "parent_one_process_s_beside": fam_one["seconds"], "nvidia_smi": smi}
    emit(line)
    check_model_run("train_model fsdp sgd", line, ranks, want_fsdp=True, reducers=set(),
                    peaks=peaks)
    if not abs(line["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]):
        raise AssertionError(f"train_model: the world's loss {line['loss']} is off the "
                             f"one-process loss {ref['loss']}")
    os.remove(fsdp["ref_path"])  # read by (a) alone: the disk holds one file at a time

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world = WORLDS.start(model_modes_rank, data, model=cols, args=(seed + 8,), timeout_s=900)
    moe_one = moe_axis_refs(torch, np, seed, smi, tmp, mixtral_overlap)
    modes = WORLDS.wait(world)
    modes_s = time.perf_counter() - t0
    counts = dict.fromkeys(kernel_counters(), 0)
    reducers = {r["rank"] for r in modes if r["row"] == data - 1}
    for mode, run0 in modes[0]["runs"].items():
        recs = [r["runs"][mode] for r in modes]
        for rec in recs:
            for k, v in rec["launches"].items():
                counts[k] += v
        line = {"phase": "train_model", "run": "sgd", "mode": mode, "model": "qwen1.5-0.5b",
                "layers": TRAIN_LAYERS, "params": modes[0]["params"],
                "world": {"data": data, "model": cols}, "fsdp": run0["fsdp"],
                "seq_len": TRAIN_SEQ, "global_batch": MODEL_BATCH, "loss": run0["loss"],
                "step_wall_s": max(rec["wall_s"] for rec in recs),
                "per_rank": [{"rank": r["rank"], "wall_s": rec["wall_s"],
                              "peak_gib": rec["peak_gib"], **rank_timing([rec["timing"]])}
                             for r, rec in zip(modes, recs)],
                "chunk_accumulate_by_rank": {r["rank"]: rec["launches"]["chunk_accumulate"]
                                             for r, rec in zip(modes, recs)},
                **{k: run0[k] for k in ("max_abs_diff", "max_abs_grad", "rel",
                                        "one_process_loss")},
                "budget": TRAIN_PARITY_REL, "one_process_s": modes[0]["one_process_s"],
                "world_s": modes_s, "parent_one_process_s_beside": moe_one["seconds"],
                "nvidia_smi": smi}
        emit(line)
        # the decoupled step folds one wave (its one compute row's gradient)
        # on each column's reducer row
        check_model_run(f"train_model {mode}", line, recs, want_fsdp=False,
                        reducers=reducers if mode == "decoupled" else set())
    moe = moe_axis_part(torch, np, seed, smi, moe_one, mixtral_overlap)
    fam = family_axis_part(torch, np, seed, smi, fam_one)
    for k in counts:
        counts[k] += moe["launches"][k] + fam["launches"][k]
    return {"launches": counts,
            "seconds": fsdp_s + modes_s + moe["seconds"] + fam["seconds"]}


# -- phase 9: the paper's decoupled MapReduce --------------------------------------

MR_ROWS = 8
# 16,384 documents of 4,096 word slots (2^26), Zipf(1.4) ids, skewed lengths
MR_CFG = dict(n_docs_per_row=2048, words_per_doc=4096, skew=0.8)
# qwen's vocabulary (the global path), and 32,000 bins (the block path) for
# the fold alone (the kernels phase runs the block path too)
MR_VOCABS = (151_936, 32_000)
MR_GRANULARITY = 8192  # words per element: 64 KiB [keys | counts] elements
# (run, mode, vocab, keyword arguments of run_wordcount)
MR_RUNS = [("reference", "reference", 151_936, {}),
           ("decoupled", "decoupled", 151_936, {"alpha": 0.25}),
           ("pipelined", "pipelined", 151_936, {"alpha": 0.25, "chain_alphas": {"io": 0.125}})]
MR_FOLD_ELEMENTS = 256  # elements of compute row 0's stream timed on a reduce row
# the adaptive word count (fig12's check (a), the no-op hysteresis, at the
# paper's scale): balanced corpora (skew 0) of the same size, seeds --seed +
# t, under `run_wordcount_adaptive`'s default policy; it must never regroup.
# It starts at the planner's own allocation for this load, 4 reduce rows of
# 8 (the row budget's edge): from alpha0 1/4 the model predicts 1.88x for 4
# reduce rows here, and regroups (fig12's 16 and 32 documents over 6 map rows
# leave the last row a third full, and plan 1.133x), so the no-op path at
# this scale is the optimum's: "already optimal" at every wall
# (`scripts/torch_adapt_plan.py` replays these verdicts on the host)
MR_ADAPT_STEPS = 2  # the warmup's sample, then the planner's first decision
MR_ADAPT_ALPHA0 = 0.5
# half the static runs' documents: at skew 0 every slot is a valid word, and
# at 2^26 words Zipf(1.4)'s hottest bin passes 2^24 (~21.6M), where no f32
# histogram (the reference's included) is exact; at 2^25 it holds ~10.8M
MR_ADAPT_CFG = dict(n_docs_per_row=1024, words_per_doc=4096, skew=0.0)
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
    """One rank of the MapReduce phase's eight-row world (run by `WORLDS`):
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
        run_wordcount_adaptive,
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

    # the adaptive word count over the balanced corpora, one superstep each
    cfg = CorpusCfg(**MR_ADAPT_CFG, vocab=MR_VOCABS[0], seed=seed)
    mesh.stats = WireStats()
    torch.cuda.synchronize()
    mesh.barrier()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    report, ag = run_wordcount_adaptive(mesh, cfg, supersteps=MR_ADAPT_STEPS,
                                        alpha0=MR_ADAPT_ALPHA0, granularity_words=MR_GRANULARITY,
                                        corpora=[load_corpus(p) for p in paths["adaptive"]])
    torch.cuda.synchronize()
    out["adaptive"] = {"wall_s": time.perf_counter() - t0,
                       "launches": {k: fn.launches for k, fn in counters.items()},
                       "hist": [r.pop("histogram") for r in report], "report": report,
                       "rows": ag.rows, "wire": mesh.stats.as_dict(),
                       "speedups": [d.predicted_speedup for d in ag.history]}
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


def corpus_job(cfg, total_docs: int, directory: str) -> tuple:
    """One corpus made and saved under ``directory`` (`save_corpus`; run in
    a worker process), and its host counts: (path, `np.bincount` of the
    valid words, valid words, words per document)."""
    import numpy as np

    from repro_torch.apps.mapreduce import save_corpus

    os.makedirs(directory)
    path = save_corpus(cfg, total_docs, directory)
    tokens = np.load(path + ".tokens.npy", mmap_mode="r")
    mask = np.load(path + ".mask.npy", mmap_mode="r")
    valid = np.asarray(mask) > 0
    return (path, np.bincount(np.asarray(tokens)[valid], minlength=cfg.vocab), int(valid.sum()),
            np.asarray(mask).sum(1))


def start_corpora(seed: int) -> dict:
    """Every corpus of the MapReduce phase started at once, one worker
    process each (the static runs' two and the adaptive run's balanced
    ones), under a fresh temporary directory: `main` starts them before
    phase 7b, so that they are made while the single-process phases hold
    the card and the phase waits only for what is left. `mapreduce_phase`
    takes the result; `close_corpora` removes the directory."""
    import tempfile

    from repro_torch.apps.mapreduce import CorpusCfg

    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    total_docs = MR_CFG["n_docs_per_row"] * MR_ROWS
    jobs = {vocab: (CorpusCfg(**MR_CFG, vocab=vocab, seed=seed), total_docs)
            for vocab in MR_VOCABS}
    jobs.update({f"adaptive_{t}": (CorpusCfg(**MR_ADAPT_CFG, vocab=MR_VOCABS[0], seed=seed + t),
                                   MR_ADAPT_CFG["n_docs_per_row"] * MR_ROWS)
                 for t in range(MR_ADAPT_STEPS)})
    pool = concurrent.futures.ProcessPoolExecutor(
        len(jobs), mp_context=multiprocessing.get_context("spawn"))
    futures = {key: pool.submit(corpus_job, cfg, docs, os.path.join(tmp, str(key)))
               for key, (cfg, docs) in jobs.items()}
    return {"dir": tmp, "pool": pool, "futures": futures, "t0": time.perf_counter()}


def close_corpora(corpora: dict) -> None:
    corpora["pool"].shutdown(wait=True, cancel_futures=True)
    shutil.rmtree(corpora["dir"], ignore_errors=True)


def mapreduce_phase(torch, np, seed: int, smi: str, corpora: dict) -> dict:
    """The MapReduce phase: the corpora (`start_corpora`) shared with the
    eight ranks through files, every run's histogram held against
    `np.bincount` of the valid words bit for bit, the modes against each
    other, the histogram kernel's launches against the schedule, the
    measured counters against the host's per-row counts, and the
    quickstart's statistics against the rows' figures."""
    from repro_torch.apps.mapreduce import CorpusCfg, histogram_launches

    total_docs = MR_CFG["n_docs_per_row"] * MR_ROWS
    t0 = time.perf_counter()
    host, paths, stats = {}, {}, {}
    done = {key: f.result() for key, f in corpora["futures"].items()}
    corpus_wait_s = time.perf_counter() - t0
    corpus_s = time.perf_counter() - corpora["t0"]
    for vocab in MR_VOCABS:
        paths[vocab], host[vocab], valid_words, doc_words = done[vocab]
        stats[vocab] = {"valid_words": valid_words, "hottest_bin": int(host[vocab].max()),
                        "doc_words": doc_words}
    paths["adaptive"] = [done[f"adaptive_{t}"][0] for t in range(MR_ADAPT_STEPS)]
    adaptive_host = [done[f"adaptive_{t}"][1] for t in range(MR_ADAPT_STEPS)]
    del done
    t0 = time.perf_counter()
    ranks = WORLDS.run(mapreduce_rank, MR_ROWS, args=(seed, paths), timeout_s=900)
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
    adaptive = adaptive_mapreduce_line(np, ranks, adaptive_host, smi)
    for k, v in adaptive["launches"].items():
        launches_total[k] = launches_total.get(k, 0) + v
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
    summary = {"phase": "mapreduce_summary", "corpus_s": corpus_s,
               "corpus_wait_s": corpus_wait_s, "world_s": world_s,
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
    return {"runs": runs, "launches": launches_total, "fold": fold,
            "launches_adaptive": adaptive["launches"]["histogram"]}


def adaptive_mapreduce_line(np, ranks: list, host: list, smi: str) -> dict:
    """The adaptive word count's line and its checks: no regroup, the same
    decisions on every row, every superstep's histogram equal to the
    host's `np.bincount` bit for bit on every row, and the histogram
    kernel's launches, summed over the ranks, equal to the schedule's,
    warmups included (`adaptive_histogram_launches`)."""
    from repro_torch.apps.mapreduce import CorpusCfg, adaptive_histogram_launches

    per = [r["adaptive"] for r in ranks]
    report = per[0]["report"]
    cfg = CorpusCfg(**MR_ADAPT_CFG, vocab=MR_VOCABS[0])
    hottest = max(int(h.max()) for h in host)
    if hottest >= 2 ** 24:
        raise AssertionError(f"mapreduce adaptive: a bin ({hottest}) is past f32's exact integers")
    want = adaptive_histogram_launches(report, cfg, MR_ROWS, granularity_words=MR_GRANULARITY)
    launches = {k: sum(p["launches"][k] for p in per) for k in per[0]["launches"]}
    exact = [all(np.array_equal(p["hist"][t], host[t]) for p in per)
             for t in range(MR_ADAPT_STEPS)]
    line = {"phase": "mapreduce", "run": "adaptive", "mode": "decoupled", "vocab": cfg.vocab,
            "rows": MR_ROWS, "alpha0": MR_ADAPT_ALPHA0, "supersteps": MR_ADAPT_STEPS,
            "corpus": {**MR_ADAPT_CFG, "seeds": "--seed + t"}, "hottest_bin": hottest,
            "granularity_words": MR_GRANULARITY,
            "wall_s": max(p["wall_s"] for p in per),
            "superstep_wall_s": [r["wall_s"] for r in report],
            "decisions": [r["decision"] for r in report],
            "reduce_rows": [r["rows"]["reduce"] for r in report],
            "predicted_speedups": per[0]["speedups"], "regroups": sum(r["regrouped"]
                                                                      for r in report),
            "work_cv": [r["work_cv"] for r in report], "tokens": [float(r["tokens"])
                                                                 for r in report],
            "launches": launches, "histogram_expected": want,
            "histogram_by_row": [p["launches"]["histogram"] for p in per],
            "bit_identical_to_host": exact,
            "wire": "gloo over host loopback (device -> pinned host -> gloo -> host -> device)",
            "nvidia_smi": smi}
    emit(line)
    if any(p["report"] != report or p["rows"] != per[0]["rows"] for p in per):
        raise AssertionError("mapreduce adaptive: the rows disagree on the decisions")
    if line["regroups"]:
        raise AssertionError(f"mapreduce adaptive: a balanced load regrouped: {line['decisions']}")
    if not all(exact):
        raise AssertionError(f"mapreduce adaptive: a histogram differs from the host's: {exact}")
    if launches["histogram"] != want or want <= 0:
        raise AssertionError(f"mapreduce adaptive: histogram launched {launches['histogram']} "
                             f"times, the schedule (warmups included) says {want}")
    return line


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
    """One rank of the CG phase's eight-row world (run by `WORLDS`): each
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

    t0 = time.perf_counter()
    ranks = WORLDS.run(cg_rank, CG_ROWS, timeout_s=600)
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
# the adaptive run (fig12's check (b), the reference test's settings at
# 2^21 particles): every row can hold them all, so none can overflow
PIC_ADAPT_CFG = dict(capacity=2 ** 21, n_particles_total=2 ** 21, n_steps=2, dt=0.1, skew=0.9,
                     sheet_center0=0.25, drift=0.12, attract=2.0)
PIC_ADAPT_ALPHA0 = 0.25
PIC_ADAPT_STEPS = 4


def pic_rank(mesh, seed: int, sink_dir: str) -> dict:
    """One rank of the PIC phase's eight-row world (run by `WORLDS`): each
    run of `apps.pic.RUNS` through `apps.pic.run_pic`, its kernel counts set to
    0 just before and read just after, with its phase times, movers, wire
    statistics and peak memory; after the io run, its final state streamed
    to a `HostSink` through `io.iogroup.stream_to_io_group`."""
    import torch

    from repro_torch.apps.pic import RUNS, PICCfg, pic_graph, run_pic, run_pic_adaptive
    from repro_torch.core.adapt import AdaptPolicy
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

    # the adaptive run: the drifting sheet, regroups and in-memory migrations
    acfg = PICCfg(**PIC_ADAPT_CFG, seed=3 + seed)
    stats = {}
    mesh.stats = WireStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.barrier()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    report, ag, state = run_pic_adaptive(mesh, acfg, alpha0=PIC_ADAPT_ALPHA0,
                                         supersteps=PIC_ADAPT_STEPS,
                                         policy=AdaptPolicy(**ADAPT_POLICY), stats=stats)
    torch.cuda.synchronize()
    work = ag.graph.gmesh.compute.size
    m = state["m"] > 0
    x = state["x"][m]
    owned = bool((torch.floor(x / (acfg.domain / work)) == mesh.row).all()) if mesh.row < work \
        else not bool(m.any())
    out["adaptive"] = {"wall_s": time.perf_counter() - t0, "report": report, "rows": ag.rows,
                       "stats": stats, "owned": owned, "valid": int(m.sum()),
                       "device": str(state["x"].device),
                       "speedups": [d.predicted_speedup for d in ag.history],
                       "launches": {k: fn.launches for k, fn in counters.items()},
                       "wire": mesh.stats.as_dict(),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state, x, m
    torch.cuda.empty_cache()
    return out


def adaptive_pic_line(ranks: list, smi: str) -> dict:
    """The adaptive PIC run's line and its checks: the same report on every
    row, every particle conserved at every superstep (each migration
    raises on a drop, on every rank alike) and owned by its row on the
    final partition, and each migration's seconds and bytes."""
    per = [r["adaptive"] for r in ranks]
    report = per[0]["report"]
    total = PIC_ADAPT_CFG["n_particles_total"]
    line = {"phase": "pic", "run": "adaptive", "mode": "decoupled", "rows": PIC_ROWS,
            "cfg": PIC_ADAPT_CFG, "alpha0": PIC_ADAPT_ALPHA0, "policy": ADAPT_POLICY,
            "wall_s": max(p["wall_s"] for p in per),
            "superstep_wall_s": [r["wall_s"] for r in report],
            "centers": [r["center"] for r in report], "exits": [r["exits"] for r in report],
            "comm_rows": [r["rows"]["comm"] for r in report],
            "decisions": [r["decision"] for r in report],
            "regroups": sum(r["regrouped"] for r in report), "final_rows": per[0]["rows"],
            "predicted_speedups": per[0]["speedups"],
            "n_particles": [r["n_particles"] for r in report],
            "final_valid_by_row": [p["valid"] for p in per],
            "owned": all(p["owned"] for p in per),
            "migrations": [{"superstep": m["superstep"], "bytes_per_rank": m["gathered_bytes"],
                            "slowest_s": max(p["stats"]["migrations"][i]["seconds"]
                                             for p in per)}
                           for i, m in enumerate(per[0]["stats"].get("migrations", []))],
            "launches": {k: sum(p["launches"][k] for p in per) for k in per[0]["launches"]},
            "sent_bytes": sum(p["wire"]["sent_bytes"] for p in per),
            "collective_bytes": sum(p["wire"]["collective_bytes"] for p in per),
            "peak_gib": [p["peak_gib"] for p in per], "device": per[0]["device"],
            "wire": "gloo over host loopback (device -> pinned host -> gloo -> host -> device)",
            "nvidia_smi": smi}
    emit(line)
    if any(p["report"] != report for p in per):
        raise AssertionError("pic adaptive: the rows disagree on the report")
    if not per[0]["device"].startswith("cuda"):
        raise AssertionError(f"pic adaptive: particles lie on {per[0]['device']}")
    if line["n_particles"] != [float(total)] * PIC_ADAPT_STEPS \
            or sum(line["final_valid_by_row"]) != total:
        raise AssertionError(f"pic adaptive: particles not conserved: {line['n_particles']}, "
                             f"final {line['final_valid_by_row']}")
    if not line["owned"]:
        raise AssertionError("pic adaptive: a particle lies off its row on the final partition")
    if len(line["migrations"]) != line["regroups"]:
        raise AssertionError("pic adaptive: a regroup without its migration")
    return line


def pic_phase(torch, np, seed: int, smi: str) -> dict:
    """The PIC phase: one line per run, then the checks: particles conserved
    at every step and owned by their row, the valid (x, v) over all rows
    equal to a numpy replay of the push in f32 from the run's initial
    particles, the io row's chunks, and the drained file equal to the
    packed final state bit for bit."""
    import tempfile

    from repro_torch.apps.pic import RUNS, PICCfg, init_particles

    cfg = PICCfg(**PIC_CFG, seed=3 + seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sink_") as sink_dir:
        t0 = time.perf_counter()
        ranks = WORLDS.run(pic_rank, PIC_ROWS, args=(seed, sink_dir), timeout_s=600)
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
    lines["adaptive"] = adaptive = adaptive_pic_line(ranks, smi)
    for k, n in adaptive["launches"].items():
        launches_total[k] = launches_total.get(k, 0) + n
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
    t_main = time.perf_counter()
    CLOCK.start("device")
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
    CLOCK.start("build")
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
    CLOCK.start("kernels")
    kernels = [check_paged(torch, np, args.seed), check_argmax(torch, np, args.seed),
               check_flash(torch, np, args.seed), check_ssd(torch, np, args.seed),
               check_accumulate(torch, np, args.seed), check_histogram(torch, args.seed)]
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4: full-width serve of tinyllama-1.1b (and phase 5's profile)
    CLOCK.start("serve")
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
    CLOCK.start("long")
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
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6b: the serving example's traffic scenarios, qwen2.5-3b at full
    # width and depth, the same weights
    CLOCK.start("scenario")
    scen = scenario_phase(torch, np, qmodel, qparams, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6c: speculative decoding, qwen2.5-3b at full width and depth (f32
    # parity from --seed; the speed runs on the same bf16 weights)
    CLOCK.start("spec")
    spec = spec_phase(torch, np, qmodel, qparams, smi, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6d: disaggregated serving and the serving fleet, qwen2.5-3b at full
    # width and depth (f32 parity and checkpoint recovery from --seed, the
    # adaptive fleet under faults on the same bf16 weights), then the SPMD
    # step in a four-row tinyllama-1.1b world on this card
    CLOCK.start("disagg")
    disagg = disagg_phase(torch, np, qmodel, qparams, smi, args.seed)
    del qparams
    # the arms' engines hold their params in reference cycles (the timed
    # step closures): collect them, so the mamba arm's peak is its own
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()

    # phase 7: mamba2-130m at full width and depth, aligned mode
    CLOCK.start("mamba")
    mcfg = get("mamba2-130m")
    mmodel = build(mcfg)
    mparams = mmodel.init(args.seed)
    mamba = aligned_arm(torch, np, mmodel, mparams,
                      reqs=mamba_requests(np, mcfg, n_req=16, seed=args.seed + 4))
    profile_prefill(torch, np, mmodel, mparams, seed=args.seed + 5)
    profile_decode(torch, np, mmodel, mparams, seed=args.seed + 6, mode="aligned")
    del mmodel, mparams
    gc.collect()
    torch.cuda.empty_cache()

    # the rank processes of phases 8-11 and the MapReduce corpora, started
    # now so that they are ready by then: the single-process phases 7b and
    # 7c leave the host's other cores idle. The ranks' allocators map
    # memory in growable segments, so the large, differently sized buffers
    # of the folds, the parity steps and one world after another reuse it
    global WORLDS
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    WORLDS = RankPool(POOL_SIZE)
    atexit.register(WORLDS.close)
    corpora = start_corpora(args.seed)
    atexit.register(close_corpora, corpora)

    # phase 7b: the MoE family at full width and cut depth, continuous mode
    CLOCK.start("moe")
    moe_lines = moe_phase(torch, np, args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 7c: the last model families (VLM, hybrid, encoder-decoder) at
    # full width and depth
    CLOCK.start("families")
    families = families_phase(torch, np, args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8: training in every step mode, with checkpoints and a resume,
    # qwen1.5-0.5b at full width in a four-row world on this card
    CLOCK.start("train")
    train = train_phase(torch, np, args.seed + 8, smi)

    # phase 8b: training the MoE, VLM, hybrid and encoder-decoder families at
    # full width and cut depth in a two-row world on this card
    CLOCK.start("train_families")
    train_families = family_train_phase(torch, np, args.seed, smi)

    # phase 8c: FSDP training, qwen2.5-3b at full width and depth in a two-row
    # world on this card, against one process; phase 8d: the model axis, the
    # same step on a (2, 2) world against the same one-process file, the
    # three step modes of qwen1.5-0.5b on it, and mixtral-8x7b's experts over
    # its columns against its own one-process step
    import tempfile

    CLOCK.start("train_fsdp")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    try:
        train_fsdp = fsdp_phase(torch, np, args.seed, smi, tmp)
        CLOCK.start("train_model")
        train_model = model_axis_phase(torch, np, args.seed, smi, train_fsdp, tmp,
                                       train_families["mixtral_overlap"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # phase 9: the paper's decoupled MapReduce in an eight-row world on this card
    CLOCK.start("mapreduce")
    mapreduce = mapreduce_phase(torch, np, args.seed, smi, corpora)
    close_corpora(corpora)

    # phases 10 and 11: the paper's halo-exchange CG, and its particle
    # communication and decoupled I/O, in eight-row worlds on this card
    CLOCK.start("cg")
    cg = cg_phase(torch, np, smi)
    CLOCK.start("pic")
    pic = pic_phase(torch, np, args.seed, smi)
    CLOCK.stop()
    WORLDS.close()

    # phase 12: summary; "launches" is the count from the run of the path
    # each kernel belongs to (the bf16 tinyllama arm for paged decode,
    # argmax and flash, the scenario phase's traced replay and the spec
    # phase's run with the qwen1.5-0.5b draft and phase 6d's adaptive fleet
    # under faults (launches_disagg) beside it, and phase 7b's bf16
    # mixtral-8x7b arm (launches_moe; every MoE arm's by arm), and phase 7c's
    # arms (a)-(c) summed (launches_families; each arm's by arm); the
    # mamba arm for the SSD scan; the train phase's decoupled run, summed
    # over its four ranks, for chunk_accumulate, every train run's counts
    # beside it (launches_train_by_run, the adaptive run's too); the MapReduce
    # phase, its five runs summed over their eight ranks, for histogram, the
    # adaptive run's beside it as launches_adaptive),
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
            kern["launches_adaptive"] = mapreduce["launches_adaptive"]
            fold = mapreduce["fold"][MR_VOCABS[0]]
            kern["isolated_2p26"] = {k: kern[k] for k in timed}
            kern.update({k: fold["kernel_" + k if k in ("ms", "device_ms") else k]
                         for k in timed},
                        max_abs_err=max(kern["max_abs_err"], fold["max_abs_err"]))
        main_arm = {"ssd_scan": mamba["launches"], "chunk_accumulate": train["launches"],
                    "histogram": mapreduce["launches"]}.get(name, bf16["launches"])
        kern["launches"] = main_arm[name]
        kern["launches_long_arm"] = long["launches"][name]
        kern["launches_scenario"] = scen["launches"][name]
        kern["launches_spec"] = spec["launches"][name]
        kern["launches_disagg"] = disagg["launches"][name]
        kern["launches_mamba_arm"] = mamba["launches"][name]
        kern["launches_moe"] = moe_lines["launches"][name]
        kern["launches_moe_by_arm"] = {arm: counts[name] for arm, counts
                                       in moe_lines["launches_by_arm"].items()}
        kern["launches_families"] = families["launches"][name]
        kern["launches_families_by_arm"] = {arm: counts[name] for arm, counts
                                            in families["launches_by_arm"].items()}
        kern["launches_train"] = train["launches"][name]
        kern["launches_train_by_run"] = {run: counts[name]
                                         for run, counts in train["launches_by_run"].items()}
        kern["launches_train_families"] = train_families["launches"][name]
        kern["launches_train_fsdp"] = train_fsdp["launches"][name]
        kern["launches_train_model"] = train_model["launches"][name]
        kern["launches_mapreduce"] = mapreduce["launches"][name]
        kern["launches_cg"] = cg["launches"][name]
        kern["launches_pic"] = pic["launches"][name]
        if kern["launches"] <= 0:
            raise AssertionError(f"{name} was launched no time on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "plain_device_ms", "library_device_ms", "launches_long_arm",
            "launches_scenario", "launches_spec", "launches_disagg", "launches_mamba_arm",
            "launches_moe", "launches_moe_by_arm", "launches_families",
            "launches_families_by_arm", "launches_train", "launches_train_by_run",
            "launches_train_families", "launches_train_fsdp", "launches_train_model",
            "launches_mapreduce",
            "launches_cg", "launches_pic")
    emit({"phase": "timing", "seconds_by_phase": CLOCK.totals,
          "total_s": time.perf_counter() - t_main})
    emit({"kernels": [{k: kern[k] for k in keys + ("isolated_2p26", "launches_adaptive")
                       if k in kern} for kern in kernels]})
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
