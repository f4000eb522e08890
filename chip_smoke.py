"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--phases device,build,kernels,...] [--out results.json]

Phases, each of which fails the run (exit code 1) if anything in it fails:

1. device    -- the card's name and power limit (nvidia-smi).
2. build     -- compiles every ``kernels/csrc/*.cu`` with nvcc for sm_90a,
                one nvcc per source, all started together, and prints each
                source's time and, per kernel, ptxas's registers, spill
                bytes, stack and static shared memory, which the report
                keeps (``ptxas``).
3. kernels   -- each hand-written kernel against its plain PyTorch version
                on the same card tensors.  Attention at qwen2-1.5b's shapes
                and Jamba-1.5-Large's heads (64/8), in bf16 and fp32 (and
                one fp16 prefill): the largest absolute error, and the
                largest error of an output row relative to that row's RMS;
                decode also against the plain split of the cache, and
                paged == contiguous and two calls equal, bitwise.
                SIL-MSE at the paper MLP's boundary and at qwen2-1.5b's LM
                SIL, in fp32 and bf16 act: the loss's relative error and the
                grad's largest absolute and row-relative errors, two calls
                bitwise equal, and at both shapes 100 back-to-back calls and
                50 over two streams bitwise equal to a first.  The
                selective scan at Jamba-1.5-Large's full width (Ba 2, S 512,
                Di 16384, N 16; the init's A and a random one), at a ragged
                shape, over a 4096-step prompt, at S 1 and S shorter than a
                time tile, and at N 4 and 8 with a ragged Di: fp32 and bf16
                u, zero and nonzero h0, B and C as the layer's column views,
                and two calls bitwise equal.  The scan's backward on the
                states its forward saved (at full width with h0 and dh_last
                and with B and C as column views, ragged, N 4 and 8 at a
                ragged Di; fp32 and bf16 u) against its plain version: each
                gradient's largest error over its largest value, two calls
                bitwise equal, and the saving forward bitwise the forward.
                The attention backward
                (causal) at qwen2-1.5b's full layer shape (B8 S1024, 12/2
                heads of 128) in bf16 and fp16, at the smoke LM's (B2 S64,
                4/2 of 64) in fp32 and bf16, and at B2 S1024 with qwen2's
                heads under a 256-key window and at D 64 in bf16, against
                its plain version, against the same in the tensor-core
                kernels' order of rounding and against fp32 autograd of
                ``ref.chunked_attention``, and two calls bitwise equal.
                At granite-moe-3b-a800m's attention (24/8 heads of 64): the
                training forward with its lse at B8 S1024 in bf16, its
                backward, and decode and paged decode at B8.  At
                stablelm-3b's (32/32 heads of 80: the last 64-column box
                of D zero-filled by the tensor maps) and chatglm3-6b's
                (32/2 of 128, 16 query heads a KV head): the training
                forward with its lse and the serve forward (stablelm's
                also in fp32 at a small shape), the backward (stablelm's
                at B8 S1024 in bf16, at a small shape in fp32 and under a
                window; chatglm3's heads at B2 S1024), two calls bitwise
                equal; decode and paged decode at B8 on both and at
                mistral-large-123b's 96/8 heads (12 a KV head).  At
                whisper-tiny's (6/6 heads of 64), non-causal: the serve
                and training forward and the backward at the encoder's
                B8 S1500 (ragged last tiles) and the cross-attention's B8
                Sq448 Sk1500 in bf16, at small ragged shapes in fp32, two
                calls bitwise equal; decode over the 1500 cross slots at
                pos 1499 and over a ragged self cache, paged ==
                contiguous bitwise.
4. reference -- the smoke qwen2 model, the smoke Jamba without and with
                its experts, the smoke granite (MoE) and the smoke dense
                variants at head dim 80 (stablelm, d 320), 16 query heads
                a KV head (chatglm3, d 1024, 16/1) and 12 (mistral-large,
                d 768, 12/1) at fp32 on the card
                (kernels) against the same model on the CPU (plain
                versions): prefill and decode logits, and greedy engine
                tokens on both pools.  A small MLP through Fig. 3 +
                §5 on the card and on the CPU from the same params and SIL:
                per-step losses, accuracies and MACs.  The smoke qwen2
                through ``run_lm_sequential`` (SIL stage, live frozen
                prefix, recovery) on the card and on the CPU, fp32: each
                step function's first loss and gradients, then every step's
                loss; the same for Jamba's attention-free smoke cut (2 Mamba
                layers, one a stage: the scan's backward kernel, gradients
                held leaf by leaf at 1e-5 of the leaf's largest value);
                through ``run_lm_parallel`` (Fig. 5, the stage
                executor): every (tick, stage) loss; and through Fig. 3 on
                the stored boundary (3 batches): every loss; the D-80
                stablelm variant through ``run_lm_sequential`` as the
                smoke qwen2 (the fp32 backward kernels at D 80).  The smoke
                qwen2 served from its two stage trees
                (``Engine(plan=, stage_params=)``): greedy tokens and
                launches equal to the joined engine's on both pools.
                whisper-tiny's smoke config at 2 heads of 64 and 100
                frames: logits, engine tokens (each request with its
                frames), the staged engine, and the LM schedule through
                the (x, enc_out) payload, as the smoke qwen2.
                xlstm-125m's smoke config (4 layers, d 256): logits and
                engine tokens on both pools (a 70-token prompt pads its
                second mLSTM chunk), launching no kernel of the port.
                llava-next-34b's smoke config (16 image rows before each
                prompt): logits and engine tokens on both pools.  The
                smoke qwen2's unpartitioned train step
                (``launch.steps.build_train_step``), 3 steps: the first
                step's loss, ce and grad_norm at the fp32 tier.
5. serve     -- qwen2-1.5b at full width from seeded random weights through
                ``Engine(precision="bf16", max_slots=8)``: 8 greedy and 2
                sampled requests, once on the contiguous pool and once
                paged.  Greedy tokens must agree between the pools, and
                every kernel's launch count must be > 0 (counts are zeroed
                just before each run and read just after).  A short run is
                profiled: device time by kernel family, and the host time,
                device time and kernel launches of each decode step.  Then
                the same for Jamba-1.5-Large without experts at full width
                and 8 layers (7 Mamba + 1 attention, seeded random bf16
                weights): its runs must launch the selective scan too.
5b. loadgen  -- the open-loop load generator: ``python -m
                repro_torch.launch.loadgen --preset full`` and ``--preset
                paged --compare`` through ``main`` (the smoke qwen2 in
                fp32: the fp32 prefill and decode kernels on both pools),
                then the ``full`` preset's trace (48 requests, Poisson at
                12 req/s, prompts 8/16, 8/16 new tokens, 4 slots, 2
                oversized) against qwen2-1.5b at full width in bf16 on both
                pools.  TTFT p50/p99 at admission and on the stream,
                tokens/s, queue depth, sheds, peak slots, completions.
                Gates: every report valid (``launch.metrics --check``),
                cache sheds == oversized requests, every other request
                completed, paging holds more sessions than the contiguous
                rows of the same budget (``concurrency_ok``); the TTFT
                verdict is printed, not gated.
6. train     -- the paper's 784-80-60-60-60-47 MLP at full width through
                ``repro_torch.verify.paper``'s ``full`` preset: the paper's
                schedule (baseline 40 epochs; Fig. 3 + §5: 5, 160 and 10)
                on the EMNIST-size data (112,800 samples resident on the
                card, batch 1410).  ms per optimizer step and samples/s per
                phase, peak memory, accuracies, and the SIL-MSE launch count
                (zeroed just before, read just after, must be > 0).  One
                profiled epoch of each phase gives kernel launches and
                device time per step, and must hold exactly one SIL-MSE
                kernel per wrapper call.  Then the ``tiny`` preset.
7. lm_train  -- qwen2-1.5b at full width (28 layers, random weights from a
                seed) trained by the paper's stage-sequential schedule
                through ``recipes.run_lm_sequential``, as ``python -m
                repro_torch.launch.train --mode pnn --stages 2 --batch 8
                --seq 1024`` runs it: bf16 compute, fp32 params, AdamW,
                stage 0 against a 1536 x 151,936 SIL table (the SIL-MSE
                kernel), stage 1 with CE on the live frozen stage 0, then
                §5 recovery.  Per phase: ms per optimizer step, tokens/s,
                every loss finite; peak memory; launches per kernel family
                (zeroed just before, read just after: the prefill, its
                backward and SIL-MSE must all be > 0).  A shorter run under
                the profiler gives launches, device ms and the busy share
                of each phase, and device time by kernel family; each
                phase's operations floor (``lm_step_flops``) at 989
                TFLOP/s is printed beside its ms per step.  Then the
                paper's baseline on the same batches: the whole network
                unpartitioned through ``launch.steps.build_train_step``
                with the training CLI's optimizer, 4 steps (exactly 56
                prefill and 28 backward launches a step, every loss, ce
                and grad_norm finite) and 2 profiled (device and host ms,
                busy share, the floor; no SDPA kernel), its peak and
                device ms against the partitioned steps', and one
                ``accum=2`` step whose loss and grad_norm equal the first
                step's at the bf16 ``REL_TOL``.
8. timing    -- each kernel, its plain version and one PyTorch library call
                (where there is one) timed with CUDA events at the main
                path's shapes (prefill also at the serve phase's longest
                prompt on each model, and with its lse at the LM train
                layer, at granite's (24/8 heads of 64) and at stablelm's
                (32/32 of 80); the attention backward at the three beside
                SDPA's backward; decode and paged decode on qwen2's,
                granite's, stablelm's, chatglm3's (32/2 of 128) and
                mistral-large's (96/8) heads; whisper-tiny's non-causal
                training forward and backward at the encoder's B8 S1500
                and the cross-attention's B8 Sq448 Sk1500 and its decode
                over the 1500 cross slots; SIL-MSE at qwen2's
                and granite's LM SIL), beside the least time the card could
                take for the same work (for the selective scan, the larger
                of its bytes and its exponentials over the SFU and the FMA
                pipe, at the timing shape and at the Jamba serve phase's
                prefills).  CUDA events over back-to-back calls time the
                host's issue rate wherever a call is shorter than its issue,
                so the kernels and the library call are also timed by their
                own device time (profiler, every launch of the timed calls
                recorded; for SDPA the sum of every kernel it launched, with
                the backend those kernels show).  The scan's backward at the
                hybrid phase's train layer (B8 S1024, bf16 u), B and C
                contiguous and as column views of one tensor (as the
                train cut calls it), each kernel's device time, beside its
                plain version, its bound and its blocks an SM.  SIL-MSE must launch one
                kernel a call; an empty kernel of its grid, in the same
                profile, gives the floor any launch reaches, and its
                wrapper's host time is split step by step.
9. lm_parallel -- the paper's Fig. 5 on qwen2-1.5b at full width: both
                stages at once for 8 ticks through ``recipes.run_lm_parallel``
                as ``python -m repro_torch.launch.train --mode pnn --dist
                round_robin --devices 1`` runs it (the ``StageExecutor`` on
                one card; stage 1 on SIL_0[:, y], no frozen-prefix forward),
                and again through the phase's own loop: losses and joined
                params bitwise equal, every loss finite; ms per tick,
                tokens/s, peak memory, launches a tick per kernel (exactly
                56 prefill, 28 backward, 1 SIL-MSE), the operations floor
                (``lm_step_flops``'s ``parallel``); a profiled 2-tick run's
                host and device ms, busy share and device ms by family a
                tick.  Then the durability contract, bitwise: the full-size
                paper MLP's Fig. 5 (3 stages) and the smoke LM's (2) through
                the executor, every stage checkpointed every tick, against
                a run whose stage 1 is zeroed after tick 1, resumed from its
                tick-1 checkpoint and replayed; ``join_from_checkpoints``
                against the live join.  Last, ``save_stage`` +
                ``restore_stage`` of stage 1 of qwen2-1.5b at full width
                cut to 4 layers (2.06 GB; the 28-layer stage's 8.8 GB until
                PR 28, cut for time) under ``build/``: bytes, seconds, GB/s,
                the device-to-host copy's and the CRC's share, bitwise
                (skipped, and said so, with less than twice its bytes free
                on the disk).  It
                runs after timing: in one process after it, the timing
                phase read SIL-MSE at the LM shape ~14% slower (NVIDIA H100
                80GB HBM3, 700 W).
10. lm_fig3   -- the paper's Fig. 3 on qwen2-1.5b at full width, as the
                reference composes it: 4 SIL steps of stage 0, the frozen
                stage 0 once over 4 batches into a ``BoundaryCache``
                (101 MB of bf16 rows), 4 CE steps of stage 1 on the stored
                rows (one batch uploaded a step, no prefix forward), 2 of
                recovery (8 / 8 / 8 / 4 until PR 29, cut for time); ms per
                step (a batch), tokens/s, launches per
                step by kernel (the cache step exactly 28 prefill, 14
                backward, no SIL-MSE; a stored batch 14 prefill), peak
                memory.  Gates, bitwise: the same schedule with the rows
                in a forced memmap spill and the right phase on the live
                prefix gives the same rows, the same right-phase losses
                and the same trained stage 1.  A profiled 2 / 2 / 2 / 1
                run: device ms, busy share and activities by family per
                step, the device-to-host copy of a stored batch and the
                host-to-device copy of a cache step.  Then the trained
                stages as a user deploys them: the tied snapshot
                refreshed, each stage saved with ``lifecycle.save_stage``,
                restored with ``stage_params_from_checkpoints`` (bitwise),
                and the serve phase's 10 requests, cut to 16 new tokens
                each (32-64 until PR 29), through the joined and then the
                staged engine after a warm-up run, on both pools (in turns
                joined, staged, staged, joined until PR 28): greedy tokens
                and launches per decode step equal; a profiled short run
                of each.
11. moe       -- granite-moe-3b-a800m at full width (32 MoE layers, 40
                experts of d_ff 512, top 8, 24/8 heads of 64; 3.299 B
                seeded random params): served as the serve phase serves,
                16 new tokens a request (cut for time, as every model
                ``serve_cut`` serves; greedy tokens and sampled streams
                equal across the pools),
                with its weights floor; trained stage by stage as
                ``python -m repro_torch.launch.train --arch
                granite-moe-3b-a800m --mode pnn --stages 2 --batch 8 --seq
                1024 --steps 8`` trains it (4 SIL steps, 4 CE steps on the
                live prefix, 2 of recovery): ms per step, tokens/s, the
                load-balance and z-losses of each phase's first and last
                step, peak memory, launches, the operations floor
                (``lm_step_flops`` over the experts' E x C slots) and, from
                a profiled 2 / 2 / 1 run, device ms, busy share and device
                time by family with the experts' batched products apart.
                Gate: two identical 2-step SIL runs of stage 0 give the
                same losses and params, bit for bit.
12. hybrid    -- Jamba-1.5-Large cut to 2 layers at every published width,
                which leaves no attention layer: with its experts (Mamba +
                MoE, then Mamba + dense; 12.18 B seeded random bf16 params)
                served as the moe phase serves granite, against its weights
                floor; without them (two 1-layer groups of Mamba + dense,
                3.12 B params) trained as the moe phase trains granite (4 +
                4 + 2 steps at B8 S1024, every Mamba layer's gradient
                through the scan's backward kernel, exactly one launch a
                trained layer a step), the profiled 2 / 2 / 1 run and the
                bitwise repeat gate.  No run may launch an attention kernel.
13. dense     -- stablelm-3b at full width (32 layers, d 2560, 32/32 heads
                of 80, partial rotary, LayerNorm, untied; 2.80 B seeded
                random params) served as the moe phase serves granite,
                against its weights floor, trained as the moe phase trains
                granite (two stages of 16 layers, 4 + 4 + 2 AdamW steps at
                B8 S1024, the profiled 2 / 2 / 1 run, the bitwise repeat
                gate); chatglm3-6b at full width (28 layers, 32/2 heads of
                128, QKV bias; 6.24 B params) served the same way.  Every
                attention launch of these runs is at head dim 80 or 16
                query heads a KV head, and no profile may hold a kernel of
                PyTorch's fused attention (SDPA).
14. whisper   -- whisper-tiny at full width (4 encoder and 4 decoder
                layers, d 384, 6/6 heads of 64, 1500 frames, LayerNorm,
                GELU, learned decoder positions, untied; 69.04 M seeded
                random params) served on both pools on speech
                recognition's traffic (8 greedy and 2 sampled requests,
                prompts of 4-64 tokens, 32-128 new tokens, each with its
                own 1500 x 384 frames): greedy tokens equal across the
                pools, 12 prefill launches an admission group (4 encoder,
                4 self, 4 cross) and 8 attention launches a decode step
                (4 over the self cache, 4 over the 1500 cross slots),
                against the decoder's weights and the cross K/V read
                once; trained stage by stage at B32 x S448 (the encoder
                in stage 0; 4 + 4 + 2 AdamW steps, bf16 compute), the
                profiled 2 / 2 / 1 run, the exact attention launches of
                the schedule and the bitwise repeat gate.  No profile may
                hold an SDPA kernel.
15. xlstm     -- xlstm-125m at full width (12 layers alternating mLSTM and
                sLSTM, d 768, 4 heads, d_up 1536, chunk 64, LayerNorm, no
                FFN, tied 50,304 vocabulary; 123.6 M seeded random params)
                served as the moe phase serves granite, against a floor of
                its weights read and its recurrent state (113.8 MB at 8
                slots) read and written once a decode step; trained stage
                by stage at B8 S1024 (two stages of 3 groups, 1 + 1 + 1
                AdamW steps, the bitwise repeat gate over 1 SIL step; the
                steps and the profiled run cut for time).  The reference computes xLSTM
                without a kernel: no run may launch an attention or scan
                kernel, and SIL-MSE runs once a SIL step.  Host-bound: the
                sLSTM steps one token at a time.
16. llava     -- llava-next-34b (60 layers, d 7168, 56/8 heads of 128: 7
                query heads a KV head; the vision encoder stubbed, 2,880
                image rows projected by img_proj before the text; 34.44 B
                seeded random bf16 params, 68.88 GB).  First, with no more
                than 1 GiB left allocated by earlier phases: every kernel
                of its paths against its plain version at its shapes (the
                prefill with its lse at B1 S3392 and serving at S3392 and
                a ragged S3213, the backward at B1 S3392, decode and paged
                decode at B2 over 3,456 slots, paged == contiguous
                bitwise, SIL-MSE at T512 d7168 M64,000) and each timed
                beside SDPA and its bound.  Then served at full width and
                depth on 2 slots, contiguous and paged: 4 requests of
                64-512 text tokens after their 2,880 image rows, 32 new
                tokens each; greedy tokens equal across the pools, exact
                attention launches (60 an admission, 60 a decode step),
                TTFT, peak memory, host and device ms and launches a
                decode step against the weights floor, busy share.  Last,
                a 4-layer full-width cut (3.20 B params) trained stage by
                stage on the plan make_plan(strategy="auto") searched, at
                B1 x 512 text tokens plus the image rows: 2 + 2 + 1 AdamW
                steps, exact attention launches, every SIL loss on the
                text rows only, a profiled 1 / 1 / 1 run against the
                operations floor, peak memory.
17. resilience -- the chaos sweep (``launch.chaos.run_matrix("full")``) on
                the card: the paper's MLP at full width, 2 stages, 6 ticks,
                every fault cell (crash, transient, the three checkpoint
                corruptions, straggler, NaN under the step guard, three
                seeded mixed schedules) ok under the ``SupervisedExecutor``,
                SIL-MSE launched.  Then qwen2-1.5b at full width cut to 4
                of its 28 layers (2 stages of 2, B8 x S1024, AdamW), 4
                ticks through the ``StageExecutor`` without faults and
                again under the supervisor (``FakeClock``, checkpoints
                every 2 ticks under ``build/``, 2 kept a stage) with a
                transient error, a straggler, a crash and a truncated
                checkpoint manifest: every scheduled fault seen and only
                those, no dispatch error, nothing unrecovered, exact
                launches a stage tick, params, optimizer state and
                ``gather()`` bitwise the run without faults; the time to
                recover each lost stage (waiting, restore bytes and GB/s,
                replay), the saves, peak memory.  The phase fails, and
                prints the free bytes, where the disk lacks two kept ticks
                of both stages.
18. verify    -- the conformance-oracle sweep (``launch.verify.sweep``) on
                the card at ``tiny``: every oracle for qwen2-1.5b but
                ``paper/emnist_parity`` (the train phase runs the paper
                gate), the arch-aware ones again for Jamba's smoke config,
                and ``plan/auto_vs_hand`` at ``full`` only (at tiny it
                misses as the paper gate's tiny does); each oracle's
                seconds; the prefill, decode, paged decode, selective scan
                and SIL-MSE kernels launched.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the per-kernel JSON.  Without a CUDA device, or
without the repository's ``src/`` beside it, the script exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
# max|err| of an output row (one query, one head) over the RMS of that row:
# bf16 rounds the output to 8 bits (a 1-ulp disagreement is 0.4-0.8% of an
# element, ~2.5% of the row RMS at worst), while one dropped key at Lc ~1000
# moves a row by ~10% of its RMS
REL_TOL = {"bfloat16": 5e-2, "float16": 5e-2, "float32": 1e-3}
PHASES = ("device", "build", "kernels", "reference", "serve", "loadgen",
          "train",
          "lm_train", "timing", "lm_parallel", "lm_fig3", "moe", "hybrid",
          "dense", "whisper", "xlstm", "llava", "resilience", "verify")

# qwen2-1.5b attention at full width
B_PREFILL, H, KV, D = 2, 12, 2, 128
B_DECODE, LC, BLOCK = 8, 1056, 16
DECODE_POS = (0, 15, 16, 100, 511, 1000, 1055, 1500)   # ragged, two >= Lc
# Jamba-1.5-Large's attention layer: 64 query heads on 8 KV heads of 128
JAMBA_H, JAMBA_KV = 64, 8
# granite-moe-3b-a800m's attention layer: 24 query heads on 8 KV heads of
# 64, at the moe phase's training batch (B8 S1024)
GRANITE_H, GRANITE_KV, GRANITE_D = 24, 8, 64
GRANITE_LAYER = (8, 1024, GRANITE_H, GRANITE_KV, GRANITE_D)
# stablelm-3b's attention layer: 32 query heads on 32 KV heads of 80, at the
# dense phase's training batch; chatglm3-6b's 32 on 2 of 128 (16 query heads
# a KV head) and mistral-large-123b's 96 on 8 of 128 (12)
STABLELM_H, STABLELM_KV, STABLELM_D = 32, 32, 80
STABLELM_LAYER = (8, 1024, STABLELM_H, STABLELM_KV, STABLELM_D)
CHATGLM_H, CHATGLM_KV = 32, 2
CHATGLM_LAYER = (2, 1024, CHATGLM_H, CHATGLM_KV, D)
MISTRAL_H, MISTRAL_KV = 96, 8
# whisper-tiny's attention: 6 query heads on 6 KV heads of 64.  The encoder
# over 1500 frames (1500 = 23 * 64 + 28: ragged last key and query tiles)
# and the decoder's 448 tokens (its published context) against them, both
# non-causal, at the whisper phase's serve batch (B8); in fp32 at small
# ragged shapes on 2/2 heads; decode over the 1500 cross slots at pos 1499
# (1500 = 93 * 16 + 12: a ragged last tile)
WHISPER_ARCH = "whisper-tiny"
WHISPER_H, WHISPER_KV, WHISPER_D = 6, 6, 64
WHISPER_ENC, WHISPER_DEC = 1500, 448
WHISPER_ATTN = ((8, WHISPER_ENC, WHISPER_ENC, WHISPER_H, WHISPER_KV,
                 WHISPER_D, "bfloat16"),
                (8, WHISPER_DEC, WHISPER_ENC, WHISPER_H, WHISPER_KV,
                 WHISPER_D, "bfloat16"),
                (2, 100, 100, 2, 2, WHISPER_D, "float32"),
                (2, 37, 100, 2, 2, WHISPER_D, "float32"))
# the training forward with its lse, as the stages run it: granite's layer,
# stablelm's (and in fp32 at a small shape) and chatglm3's heads
LSE_CASES = ((GRANITE_LAYER, "bfloat16"), (STABLELM_LAYER, "bfloat16"),
             ((2, 200, STABLELM_H, STABLELM_KV, STABLELM_D), "float32"),
             (CHATGLM_LAYER, "bfloat16"))

# kernel -> (its source in the port, the TPU kernel it replaces)
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_TPU = "src/repro/kernels/flash_attention/kernel.py"
KERNELS = {
    "flash_attention": (FA_SOURCE, f"{FA_TPU}:196"),
    # the gradient JAX takes of flash_attention_tpu (it has no custom_vjp)
    "flash_attention_bwd": (FA_SOURCE, f"{FA_TPU}:196"),
    "decode_attention": (FA_SOURCE, f"{FA_TPU}:275"),
    "paged_decode_attention": (FA_SOURCE, f"{FA_TPU}:329"),
    "sil_mse": ("src/repro_torch/kernels/csrc/sil_mse.cu",
                "src/repro/kernels/sil_mse/kernel.py:81"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan/kernel.py:99"),
    # the gradient JAX takes of selective_scan_tpu (it has no custom_vjp)
    "selective_scan_bwd": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                           "src/repro/kernels/selective_scan/kernel.py:99"),
}

# the selective scan at Jamba-1.5-Large's full width (d_inner 16384, d_state
# 16) over the serve phase's longest prompt, two requests; a ragged shape off
# every tile and block of channels; a long prompt; S = 1 and S shorter than
# a time tile; N 4 and 8 at a ragged Di (4100 is staged by plain loads, 4104
# by 16-byte copies)
SCAN_FULL = (2, 512, 16384, 16)
SCAN_RAGGED = (1, 333, 16008, 16)
SCAN_LONG = (1, 4096, 16384, 16)
SCAN_S1 = (1, 1, 16384, 16)
SCAN_SHORT = (1, 12, 16384, 16)
SCAN_N4 = (2, 300, 4100, 4)
SCAN_N8 = (2, 300, 4104, 8)
# the timing rows: the timing shape, and the serve phase's Jamba prefills,
# one prompt at a time, at its longest and shortest prompt
SCAN_TIMED = {"selective_scan": SCAN_FULL,
              "selective_scan@serve_s512": (1, 512, 16384, 16),
              "selective_scan@serve_s64": (1, 64, 16384, 16)}
# fp32: |err| <= tol * (1 + |plain|), the rtol = atol of the reference's own
# kernel test.  bf16 u: y is rounded to bf16 from fp32 values that agree to
# ~1e-5, so where one lies near a rounding boundary the two round one bf16
# ulp apart: y is held within one ulp of the plain's value (rtol 2^-7, the
# largest ulp relative to its value, atol 1e-4).  An error relative to the
# row's RMS cannot hold there: a row's largest |y| is ~8x its RMS, and one
# ulp of it is 3% of the RMS.  h_last (fp32 from the same bf16 u on both
# sides) is held at the fp32 tolerance.
SCAN_TOL = 1e-4
SCAN_Y_RTOL_BF16 = 2.0 ** -7
# SFU exponentials per clock per SM on compute capability 9.0 (the CUDA C++
# programming guide's arithmetic-instruction throughput table)
SFU_PER_CLK_PER_SM = 16
# instructions the 4 schedulers of an SM issue a clock (a warp's each), which
# is also the FP32 pipe's rate (128 lanes an SM)
ISSUE_PER_CLK_PER_SM = 128
# FP32-pipe instructions a (b, t, d, n) of the scan needs besides its
# exponential: dt * (A log2 e), (dt u) * B, the state's FFMA and the y FFMA
SCAN_FMA_PER_ELEM = 4
# the fewest instructions an exp2 takes on the FMA pipe instead of the SFU:
# a cubic's 3 FFMA on the fraction and one to split x (counted low, so the
# bound stays a bound)
EX2_FMA_PIPE = 4
H100_SMS = 132
# the scan's backward at the hybrid phase's train layer (B8 S1024, Jamba's
# d_inner and d_state)
SCAN_TRAIN = (8, 1024, 16384, 16)
# fp32 operations a (token, channel, state) of the selective scan: 6 in its
# forward; 12 in its backward, which are also the FP32-pipe instructions an
# element of the backward kernel needs beside its exponential: the
# recompute's 3 (dt * A log2 e, (dt u) * B, the state's FFMA) and the
# gradient's 9 (the state gradient's FFMA and its product with exp(dt A),
# dB's and dC's products, exp(dt A) * h, the B and A sums, dA's product and
# FFMA), counted low so the bound stays a bound
SCAN_FWD_OPS, SCAN_BWD_OPS = 6, 12

# SIL-MSE: (T, d, M) of the paper MLP's boundary (batch 1410, width 60, 47
# classes) and of qwen2-1.5b's LM SIL (8192 tokens, d_model 1536, vocab
# 151,936: a 0.93 GB fp32 table)
SIL_PAPER = (1410, 60, 47)
SIL_LM = (8192, 1536, 151936)
# granite-moe-3b-a800m's stage-0 SIL (the moe phase's): 8192 tokens, d_model
# 1536, vocab 49,155
SIL_GRANITE = (8192, 1536, 49155)
# section 6 of the port's tests: loss relative to max(1, loss), and the
# grad's rtol with atol 1e-4.  At the LM shape a grad element is ~1e-7, so
# atol alone would pass anything: the largest error of a grad element
# relative to that element holds it (bf16 rounds to nearest with 8
# significant bits, within 2^-8 = 3.9e-3 of the value)
# the LM shape once more with every label distinct and below T: the same
# bytes as the random labels' bound counts, but the table rows gathered from
# one 50 MB region, which tells what the random gather over the 0.93 GB
# table costs
SIL_LM_FIRST_ROWS = "sil_mse@lm_first_rows"
SIL_LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
SIL_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
SIL_ELEM_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


# -- phase 1 -------------------------------------------------------------------

def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def phase_device(torch, report):
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    report["device"] = {"name": name, "count": torch.cuda.device_count(),
                        "nvidia_smi": smi,
                        "capability": list(torch.cuda.get_device_capability(0)),
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    log(f"device: {name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    require(tuple(torch.cuda.get_device_capability(0)) == (9, 0),
            "the kernels are built for sm_90a (Hopper)")


# -- phase 2 -------------------------------------------------------------------

_PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?")
_PTXAS_NUMBERS = {
    "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
    "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
    "spill_load_bytes": re.compile(r"(\d+) bytes spill loads"),
    "registers": re.compile(r"Used (\d+) registers"),
    "smem_bytes": re.compile(r"(\d+) bytes smem"),
}


def ptxas_summary(text: str) -> dict:
    """{kernel (mangled name): {registers, spill_store_bytes,
    spill_load_bytes, stack_bytes, smem_bytes}} from ``nvcc -Xptxas -v``
    output (static shared memory only: a kernel's dynamic shared memory is
    set at its launch)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        for key, pat in _PTXAS_NUMBERS.items():
            m = pat.search(line)
            if m:
                cur[key] = int(m.group(1))
    return out


def phase_build(report):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    report["build_s"] = dt
    report["build_s_by_source"] = {n: sec for n, (_, sec) in logs.items()}
    report["ptxas"] = {n: ptxas_summary(text) for n, (text, _) in
                       logs.items()}
    log(f"built {sorted(logs) or 'nothing (current)'} in {dt:.1f}s, "
        "concurrently")
    for name, (text, sec) in logs.items():
        log(f"  {name}.cu: {sec:.1f}s")
        for kern, c in report["ptxas"][name].items():
            log(f"  ptxas[{name}] {kern}: {c.get('registers')} registers, "
                f"spill stores {c.get('spill_store_bytes')} B, loads "
                f"{c.get('spill_load_bytes')} B, stack "
                f"{c.get('stack_bytes')} B, smem {c.get('smem_bytes', 0)} B")


# -- phase 3 -------------------------------------------------------------------

def _rand(torch, gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def prefill_inputs(torch, gen, dev, dtype, sq, sk, b=B_PREFILL, h=H, kv=KV,
                   d=D):
    return (_rand(torch, gen, (b, sq, h, d), dtype, dev),
            _rand(torch, gen, (b, sk, kv, d), dtype, dev),
            _rand(torch, gen, (b, sk, kv, d), dtype, dev))


def decode_inputs(torch, gen, dev, dtype, h=H, kv=KV, d=D, lc=LC,
                  positions=DECODE_POS):
    """q, a shuffled paged pool with garbage pads, its block table, pos (one
    a request of ``positions``), and the contiguous (B, lc, KV, d) view
    gathered through the table."""
    nb = lc // BLOCK + 1                    # one pad column past lc
    b_ = len(positions)
    n_blocks = b_ * nb + 1                  # + the garbage block 0
    q = _rand(torch, gen, (b_, 1, h, d), dtype, dev)
    kp = _rand(torch, gen, (n_blocks, BLOCK, kv, d), dtype, dev)
    vp = _rand(torch, gen, (n_blocks, BLOCK, kv, d), dtype, dev)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm[:b_ * nb].reshape(b_, nb).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    for b, p in enumerate(positions):       # blocks past a request's span
        first_unused = min(p, lc - 1) // BLOCK + 1
        bt[b, first_unused:] = 0            # point at the garbage block
    bt[:, -1] = 0
    kc = kp[bt.long()].reshape(b_, nb * BLOCK, kv, d)[:, :lc]
    vc = vp[bt.long()].reshape(b_, nb * BLOCK, kv, d)[:, :lc]
    return q, kp, vp, bt, pos, kc.contiguous(), vc.contiguous()


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def row_rel_err(got, want) -> float:
    """max over output rows (last dim) of max|got - want| / rms(want row)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt().clamp_min(1e-12)
    return ((g - w).abs().amax(-1) / rms).max().item()


def kernel_checker(errs, rel_errs, checks):
    """``check(name, what, dtype, got, want)``: a kernel's output against
    its plain version at ``TOL`` (largest absolute error) and ``REL_TOL``
    (largest row error over the row's RMS), kept in ``errs`` /
    ``rel_errs`` (the worst a kernel) and ``checks``; fails past either."""
    def check(name, what, dtype, got, want):
        err, rel = max_err(got, want), row_rel_err(got, want)
        tol, rtol = TOL[dtype], REL_TOL[dtype]
        errs[name] = max(errs[name], err)
        rel_errs[name][dtype] = max(rel_errs[name].get(dtype, 0.0), rel)
        checks.append({"kernel": name, "case": what, "dtype": dtype,
                       "max_abs_err": err, "tol": tol,
                       "max_row_rel_err": rel, "rel_tol": rtol})
        log(f"  {name:24s} {what:34s} {dtype:9s} max|err| {err:.3e} "
            f"(tol {tol:g}), row-relative {rel:.3e} (tol {rtol:g})")
        require(math.isfinite(err) and err <= tol,
                f"{name} {what} {dtype}: max|err| {err} > {tol}")
        require(math.isfinite(rel) and rel <= rtol,
                f"{name} {what} {dtype}: row-relative err {rel} > {rtol}")
    return check


def check_decode(torch, dev, gen, check, dtype, h, kv, d, positions=DECODE_POS,
                 lc=LC):
    """Decode and paged decode, one request a position of ``positions``
    over an ``lc``-slot cache (the paged pool shuffled, with garbage pads)
    against the plain version and the plain split of the cache; paged ==
    contiguous and two calls equal, bitwise."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    dn = str(dtype).replace("torch.", "")
    b = len(positions)
    q, kp, vp, bt, pos, kc, vc = decode_inputs(
        torch, gen, dev, dtype, h=h, kv=kv, d=d, lc=lc, positions=positions)
    got_c = K.decode_attention_cuda(q, kc, vc, pos)
    got_p = K.paged_decode_attention_cuda(q, kp, vp, bt, pos, logical_len=lc)
    again = K.decode_attention_cuda(q, kc, vc, pos)
    torch.cuda.synchronize()
    _, n_split = K.split_plan(lc, b, kv)
    at = "ragged pos" if positions == DECODE_POS else \
        f"pos {positions[0]}" if len(set(positions)) == 1 else \
        f"pos {list(positions)}"
    check("decode_attention", f"B{b} Lc{lc} {h}/{kv} D{d} {at}", dn, got_c,
          R.decode_attention(q, kc, vc, pos))
    check("decode_attention", f"  the same, plain {n_split}-split", dn,
          got_c, R.decode_attention_split(q, kc, vc, pos, n_split))
    check("paged_decode_attention", f"B{b} Lc{lc} {h}/{kv} D{d} BS16 "
          "shuffled+pads", dn, got_p,
          R.paged_decode_attention(q, kp, vp, bt, pos, logical_len=lc))
    require(torch.equal(got_c, got_p),
            f"paged != contiguous decode bitwise ({dn}, {h}/{kv}, Lc{lc})")
    require(torch.equal(got_c, again),
            f"two decode calls differ bitwise ({dn}, {h}/{kv}, Lc{lc})")
    log(f"  paged == contiguous decode bitwise, and two calls bitwise equal "
        f"({dn}, {h}/{kv}, Lc{lc}, {n_split} splits)")


def phase_kernels(torch, dev, report):
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    rel_errs = {k: {} for k in KERNELS}
    checks = []
    check = kernel_checker(errs, rel_errs, checks)

    # bf16 and fp16 run the tensor-core prefill, fp32 the CUDA-core one
    prefill_cases = [(B_PREFILL, sq, sk, window, H, KV) for sq, sk, window in
                     ((1000, 1000, 0), (1024, 1024, 0), (1024, 1024, 256),
                      (384, 1024, 0))]
    prefill_cases.append((1, 512, 512, 0, JAMBA_H, JAMBA_KV))   # Jamba
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for b, sq, sk, window, h, kv in prefill_cases:
            if dtype == torch.float16 and (sq, window) != (1024, 0):
                continue
            q, k, v = prefill_inputs(torch, gen, dev, dtype, sq, sk, b=b,
                                     h=h, kv=kv)
            got = K.flash_attention_cuda(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            want = R.chunked_attention(q, k, v, causal=True, window=window)
            check("flash_attention", f"B{b} Sq{sq} Sk{sk} win{window} "
                  f"{h}/{kv}", dn, got, want)
        if dtype == torch.float16:
            continue
        # G = 6, G = 8, granite's G = 3 at D 64, stablelm's G = 1 at D 80,
        # chatglm3's G = 16 and mistral-large's G = 12 (256 threads a
        # block); whisper-tiny's G = 1 at D 64 over the decoder's self cache
        # (ragged pos) and over the 1500 cross slots (pos 1499, every slot)
        whisper_cross = (B_DECODE * (WHISPER_ENC - 1,), WHISPER_ENC)
        for h, kv, d, (positions, lc) in (
                (H, KV, D, (DECODE_POS, LC)),
                (JAMBA_H, JAMBA_KV, D, (DECODE_POS, LC)),
                (GRANITE_H, GRANITE_KV, GRANITE_D, (DECODE_POS, LC)),
                (STABLELM_H, STABLELM_KV, STABLELM_D, (DECODE_POS, LC)),
                (CHATGLM_H, CHATGLM_KV, D, (DECODE_POS, LC)),
                (MISTRAL_H, MISTRAL_KV, D, (DECODE_POS, LC)),
                (WHISPER_H, WHISPER_KV, WHISPER_D, (DECODE_POS, LC)),
                (WHISPER_H, WHISPER_KV, WHISPER_D, whisper_cross)):
            check_decode(torch, dev, gen, check, dtype, h, kv, d, positions,
                         lc)
    checks += check_prefill_lse(torch, dev, gen, check)
    bwd_checks = check_attention_bwd(torch, dev, errs, rel_errs)
    sil_checks = check_sil_mse(torch, dev, errs, rel_errs)
    scan_checks = check_selective_scan(torch, dev, errs, rel_errs)
    scan_checks += check_selective_scan_bwd(torch, dev, errs)
    report["kernel_checks"] = checks + bwd_checks + sil_checks + scan_checks
    report["max_abs_err"] = errs
    report["max_row_rel_err"] = rel_errs


def check_prefill_lse(torch, dev, gen, check, cases=None):
    """The training forward at ``LSE_CASES`` (granite's layer, B8 S1024,
    24/8 heads of 64, as the moe phase's stages run it; stablelm's at D 80,
    also in fp32; chatglm3's 32/2 heads), causal, and at ``WHISPER_ATTN``
    (the encoder's 1500 frames, the decoder's 448 tokens against them,
    small ragged fp32 shapes), non-causal: the output against the plain
    version (``check``'s tolerances), the rows' fp32 lse against the plain
    version's within 1e-5 of max(1, |lse|), the serve forward (no lse)
    against the plain version, and two calls bitwise equal.  ``cases``:
    ((b, sq, sk, h, kv, d), dtype name, causal) in place of those."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    checks = []
    if cases is None:
        cases = [((b, s, s, h, kv, d), dn, True)
                 for (b, s, h, kv, d), dn in LSE_CASES]
        cases += [(c[:6], c[6], False) for c in WHISPER_ATTN]
    for (b, sq, sk, h, kv, d), dn, causal in cases:
        q, k, v = prefill_inputs(torch, gen, dev, getattr(torch, dn), sq, sk,
                                 b=b, h=h, kv=kv, d=d)
        got, lse = K.flash_attention_cuda(q, k, v, causal=causal,
                                          return_lse=True)
        again, lse2 = K.flash_attention_cuda(q, k, v, causal=causal,
                                             return_lse=True)
        serve = K.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want, want_lse = R.flash_attention_fwd(q, k, v, causal=causal)
        what = f"B{b} Sq{sq} Sk{sk} {h}/{kv} D{d}" + (
            "" if causal else " non-causal")
        check("flash_attention", what + " with lse", dn, got, want)
        check("flash_attention", what + " serve", dn, serve, want)
        err = max_err(lse, want_lse)
        tol = 1e-5 * max(1.0, want_lse.abs().max().item())
        log(f"  {'flash_attention':24s} {what + ' with lse: lse':34s} "
            f"float32   max|err| {err:.3e} (tol {tol:.3g})")
        require(math.isfinite(err) and err <= tol,
                f"flash_attention {what}: lse max|err| {err} > {tol}")
        require(torch.equal(got, again) and torch.equal(lse, lse2),
                f"two prefill calls differ bitwise ({what}, {dn})")
        log(f"  flash_attention {what} {dn}: two calls bitwise equal")
        checks.append({"kernel": "flash_attention",
                       "case": what + " with lse: lse", "dtype": "float32",
                       "max_abs_err": err, "tol": tol})
        del q, k, v, got, again, serve, want, lse, lse2, want_lse
        torch.cuda.empty_cache()
    return checks


# the attention backward: qwen2-1.5b's full layer shape as the LM train phase
# runs it, and the smoke LM's (B, S, H, KV, D)
BWD_FULL = (8, 1024, H, KV, D)
BWD_SMOKE = (2, 64, 4, 2, 64)
# (shape, dtype name, window) of check_attention_bwd: the train layer in
# bf16 and fp16, the smoke LM's in fp32 and bf16, qwen2's heads in bf16
# under a 256-key window and at D 64, granite's layer (the moe phase's),
# stablelm's (the dense phase's, D 80; in fp32 at a small shape, and in
# bf16 under a window) and chatglm3's heads (G 16)
BWD_CASES = ((BWD_FULL, "bfloat16", 0), (BWD_SMOKE, "float32", 0),
             (BWD_SMOKE, "bfloat16", 0), (BWD_FULL, "float16", 0),
             ((2, 1024, H, KV, D), "bfloat16", 256),
             ((2, 1024, H, KV, 64), "bfloat16", 0),
             (GRANITE_LAYER, "bfloat16", 0),
             (STABLELM_LAYER, "bfloat16", 0),
             ((2, 200, STABLELM_H, STABLELM_KV, STABLELM_D), "float32", 0),
             ((2, 1024, 8, 8, STABLELM_D), "bfloat16", 256),
             (CHATGLM_LAYER, "bfloat16", 0))


def grad_row_rel_err(got, want) -> float:
    """``row_rel_err`` with each row's RMS floored at the whole tensor's: a
    gradient row can cancel to ~0 (a query's only key gives dS = P (dP -
    delta) = 0 exactly), and its rounding is judged against the tensor's
    typical row instead."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt().clamp_min(
        max(w.pow(2).mean().sqrt().item(), 1e-12))
    return ((g - w).abs().amax(-1) / rms).max().item()


def check_attention_bwd(torch, dev, errs, rel_errs, cases=None):
    """The backward kernel against its plain version (``ref.flash_attention
    _bwd``, same inputs, same lse), against the same in the tensor-core
    kernels' order (``kernel_order=True``: P and dS rounded to the input's
    type for their products) and against fp32 autograd of
    ``ref.chunked_attention`` on the inputs upcast, both ways the forward is
    held: the largest absolute error, here relative to max(1, the largest
    |gradient|) (a bf16 gradient of magnitude m rounds within m 2^-8, and
    gradients reach ~4 at the full shape), and the largest row error over
    the row's RMS (``grad_row_rel_err``) at bf16/fp16 5e-2, fp32 1e-3; two
    calls bitwise equal.  Causal, at ``BWD_CASES``; non-causal at Whisper's
    ``WHISPER_ATTN`` (the encoder's and the cross-attention's, ragged).
    ``cases``: ((b, sq, sk, h, kv, d), dtype name, window, causal) in
    place of those."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    gen = torch.Generator(device=dev).manual_seed(5)
    checks = []
    if cases is None:
        cases = [((b, s, s, h, kv, d), dn, window, True)
                 for (b, s, h, kv, d), dn, window in BWD_CASES]
        cases += [(c[:6], c[6], 0, False) for c in WHISPER_ATTN]
    for (b, sq, sk, h, kv, d), dn, window, causal in cases:
        dtype = getattr(torch, dn)
        q = _rand(torch, gen, (b, sq, h, d), dtype, dev)
        k = _rand(torch, gen, (b, sk, kv, d), dtype, dev)
        v = _rand(torch, gen, (b, sk, kv, d), dtype, dev)
        do = _rand(torch, gen, (b, sq, h, d), dtype, dev)
        _, lse = K.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        got = K.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                         window=window)
        again = K.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                           window=window)
        torch.cuda.synchronize()
        shape = (f"B{b} S{sq} {h}/{kv} D{d}" if sq == sk else
                 f"B{b} Sq{sq} Sk{sk} {h}/{kv} D{d}") + (
            f" window {window}" if window else "") + (
            "" if causal else " non-causal")
        wants = {}
        wants["plain"] = R.flash_attention_bwd(q, k, v, lse, do,
                                               causal=causal, window=window)
        wants["kernel order"] = R.flash_attention_bwd(
            q, k, v, lse, do, causal=causal, window=window,
            kernel_order=True)
        qkv = [t.float().requires_grad_() for t in (q, k, v)]
        R.chunked_attention(*qkv, causal=causal, window=window).backward(
            do.float())
        wants["fp32 autograd"] = [t.grad for t in qkv]
        for ref_name, want in wants.items():
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                err = max_err(g, w)
                scale = max(1.0, w.float().abs().max().item())
                rel = grad_row_rel_err(g, w)
                tol, rtol = TOL[dn] * scale, REL_TOL[dn]
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"], err)
                rel_errs["flash_attention_bwd"][dn] = max(
                    rel_errs["flash_attention_bwd"].get(dn, 0.0), rel)
                checks.append({"kernel": "flash_attention_bwd",
                               "case": f"{shape} {gname} vs {ref_name}",
                               "dtype": dn, "max_abs_err": err, "tol": tol,
                               "max_row_rel_err": rel, "rel_tol": rtol})
                log(f"  flash_attention_bwd {shape} {gname} vs {ref_name:13s}"
                    f" {dn:9s} max|err| {err:.3e} (tol {tol:.3g}), "
                    f"row-relative {rel:.3e} (tol {rtol:g})")
                require(math.isfinite(err) and err <= tol,
                        f"attention backward {shape} {gname} {dn} vs "
                        f"{ref_name}: max|err| {err} > {tol}")
                require(math.isfinite(rel) and rel <= rtol,
                        f"attention backward {shape} {gname} {dn} vs "
                        f"{ref_name}: row-relative err {rel} > {rtol}")
        require(all(torch.equal(a, c) for a, c in zip(got, again)),
                f"two backward calls differ bitwise ({shape}, {dn})")
        log(f"  flash_attention_bwd {shape} {dn}: two calls bitwise equal")
        del q, k, v, do, lse, got, again, wants, qkv
        torch.cuda.empty_cache()
    return checks


def sil_inputs(torch, gen, dev, t, d, m, dtype, labels=None):
    """act (T, d), the (d, M) table, int64 labels (random unless given)."""
    act = torch.randn((t, d), generator=gen, device=dev).to(dtype)
    sil = torch.rand((d, m), generator=gen, device=dev) * 10
    lab = torch.randint(0, m, (t,), generator=gen, device=dev) \
        if labels is None else labels
    return act, sil, lab


def check_sil_mse(torch, dev, errs, rel_errs, cases=None):
    """The SIL-MSE kernel against its plain version: the paper boundary,
    the LM SIL, T and d off any block multiple, repeated labels; fp32 and
    bf16 act; the (d, M) table as it is and as the trainer holds it (a
    (d, M) view of a contiguous (M, d) transpose); then the repeated-calls
    gate (``check_sil_repeats``).  ``cases``: (what, (T, d, M), labels or
    None) in place of those, without the repeated calls."""
    from repro_torch.kernels.sil_mse import kernel as K
    from repro_torch.kernels.sil_mse import ref as R
    gen = torch.Generator(device=dev).manual_seed(3)
    checks = []
    repeats = cases is None
    if cases is None:
        rep = torch.tensor(([7] * 900 + [0, 46] * 255)[:1410], device=dev)
        cases = [("paper boundary", SIL_PAPER, None),
                 ("LM SIL qwen2-1.5b", SIL_LM, None),
                 ("off-block T1003 d61", (1003, 61, 47), None),
                 ("repeated labels", SIL_PAPER, rep)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for what, (t, d, m), lab in cases:
            act, sil, lab = sil_inputs(torch, gen, dev, t, d, m, dtype, lab)
            layouts = [("(M,d)^T", sil.t().contiguous().t())]
            if t * d < 10**7:             # the natural layout, uncoalesced
                layouts.append(("(d,M)", sil))
            for lay, table in layouts:
                loss, grad = K.sil_mse_cuda(act, table, lab)
                loss2, grad2 = K.sil_mse_cuda(act, table, lab)
                torch.cuda.synchronize()
                path = "16-byte" if K.vector_loads(act, table) else "scalar"
                require(torch.equal(loss, loss2) and torch.equal(grad, grad2),
                        f"sil_mse T{t} d{d} {what} {lay} {dn}: two calls "
                        "differ bitwise")
                want = R.sil_mse(act, table, lab).item()
                wgrad = R.sil_mse_grad_act(act, table, lab)
                loss_rel = abs(loss.item() - want) / max(1.0, want)
                gerr = (grad.float() - wgrad).abs()
                over = (gerr - SIL_GRAD_RTOL[dn] * wgrad.abs()).max().item()
                g_abs = gerr.max().item()
                g_elem = (gerr / wgrad.abs().clamp_min(1e-30)).max().item()
                g_row = row_rel_err(grad, wgrad)
                errs["sil_mse"] = max(errs["sil_mse"], g_abs,
                                      abs(loss.item() - want))
                rel_errs["sil_mse"][dn] = max(
                    rel_errs["sil_mse"].get(dn, 0.0), g_row)
                case = f"T{t} d{d} M{m} {what} {lay}"
                checks.append({"kernel": "sil_mse", "case": case,
                               "dtype": dn, "path": path,
                               "loss_rel_err": loss_rel,
                               "loss_tol": SIL_LOSS_TOL[dn],
                               "max_abs_err": g_abs,
                               "grad_over_rtol": over,
                               "grad_rtol": SIL_GRAD_RTOL[dn],
                               "max_elem_rel_err": g_elem,
                               "elem_rel_tol": SIL_ELEM_TOL[dn],
                               "max_row_rel_err": g_row})
                log(f"  sil_mse {case:44s} {dn:9s} {path:7s} loss rel "
                    f"{loss_rel:.2e} "
                    f"(tol {SIL_LOSS_TOL[dn]:g}), grad max|err| {g_abs:.2e}, "
                    f"element-relative {g_elem:.2e} (tol "
                    f"{SIL_ELEM_TOL[dn]:g}), row-relative {g_row:.2e}")
                require(math.isfinite(loss_rel)
                        and loss_rel <= SIL_LOSS_TOL[dn],
                        f"sil_mse {case} {dn}: loss rel err {loss_rel}")
                require(math.isfinite(over) and over <= 1e-4,
                        f"sil_mse {case} {dn}: grad beyond rtol "
                        f"{SIL_GRAD_RTOL[dn]} + atol 1e-4 by {over}")
                require(math.isfinite(g_elem) and g_elem <= SIL_ELEM_TOL[dn],
                        f"sil_mse {case} {dn}: grad element-relative err "
                        f"{g_elem}")
            del act, sil, table, layouts, grad, grad2, wgrad, gerr
    torch.cuda.empty_cache()
    if repeats:
        check_sil_repeats(torch, dev, gen)
    return checks


def check_sil_repeats(torch, dev, gen, calls=100):
    """The one-launch reduction under load: ``calls`` back-to-back calls,
    then calls alternating over two streams (each with its own workspace),
    all bitwise equal to a first call, at the paper and the LM shapes; every
    workspace's ticket counter is left at zero."""
    from repro_torch.kernels.sil_mse import kernel as K
    for (t, d, m), dtype in ((SIL_PAPER, torch.float32),
                             (SIL_LM, torch.bfloat16)):
        act, sil, lab = sil_inputs(torch, gen, dev, t, d, m, dtype)
        table = sil.t().contiguous().t()
        del sil
        want = K.sil_mse_cuda(act, table, lab)
        torch.cuda.synchronize()
        got = [K.sil_mse_cuda(act, table, lab) for _ in range(calls)]
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        for i in range(calls // 2):
            with torch.cuda.stream(streams[i % 2]):
                got.append(K.sil_mse_cuda(act, table, lab))
        torch.cuda.synchronize()
        same = sum(torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
                   for g in got)
        counters = [K._workspace(dev.index, s.cuda_stream)[0].item()
                    for s in streams + [torch.cuda.current_stream(dev)]]
        log(f"  sil_mse T{t} d{d} {str(dtype)[6:]}: {same} of {len(got)} "
            f"calls ({calls} back to back, {calls // 2} over two streams) "
            f"bitwise equal to the first; ticket counters {counters}")
        require(same == len(got), f"sil_mse T{t} d{d}: {len(got) - same} "
                "calls differ bitwise from the first")
        require(counters == [0, 0, 0], f"sil_mse: a ticket counter was not "
                f"left at zero: {counters}")
        del act, table, lab, want, got
    torch.cuda.empty_cache()


def scan_inputs(torch, gen, dev, ba, s, di, n, *, h0=False, views=False,
                random_a=False):
    """u (fp32), dt, A, B, C, D and h0 (or None) as the Mamba layer makes
    them: dt = softplus(normal), A = -(1..N) tiled (the init's A_log), D = 1;
    with ``random_a`` A = -exp(A_log) with A_log ~ N(0, 0.5) per (d, n), as
    trained weights may hold it; with ``views`` B and C are column views of
    one (Ba, S, R + 2N) tensor, as ``mamba_apply`` hands them over (R = 512,
    Jamba's dt_rank)."""
    f32 = torch.float32
    u = torch.randn((ba, s, di), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((ba, s, di), generator=gen, device=dev))
    if random_a:
        a = -torch.exp(0.5 * torch.randn((di, n), generator=gen, device=dev))
    else:
        a = -torch.arange(1, n + 1, dtype=f32, device=dev)[None].repeat(di, 1)
    if views:
        xdb = torch.randn((ba, s, 512 + 2 * n), generator=gen, device=dev)
        b, c = xdb[..., 512:512 + n], xdb[..., 512 + n:]
    else:
        b = torch.randn((ba, s, n), generator=gen, device=dev)
        c = torch.randn((ba, s, n), generator=gen, device=dev)
    d = torch.ones((di,), dtype=f32, device=dev)
    h = torch.randn((ba, di, n), generator=gen, device=dev) if h0 else None
    return u, dt, a, b, c, d, h


def allclose_excess(got, want, rtol) -> float:
    """max(|got - want| - rtol * |want|): <= atol passes rtol and atol."""
    g, w = got.float(), want.float()
    return ((g - w).abs() - rtol * w.abs()).max().item()


def check_selective_scan(torch, dev, errs, rel_errs):
    """The selective-scan kernel against its plain version at Jamba's full
    width (zero and nonzero h0, fp32 and bf16 u, B/C as the layer's column
    views, a random A), at a ragged shape, over a long prompt, at S = 1 and
    S shorter than a time tile, and at N 4 and 8 with a ragged Di; and two
    calls on the same inputs are bitwise equal."""
    from repro_torch.kernels.selective_scan import kernel as K
    from repro_torch.kernels.selective_scan import ref as R
    gen = torch.Generator(device=dev).manual_seed(4)
    checks = []
    cases = [("full width", SCAN_FULL, False, False, False),
             ("full width, h0", SCAN_FULL, True, False, False),
             ("full width, B/C views", SCAN_FULL, False, True, False),
             ("full width, random A", SCAN_FULL, True, True, True),
             ("ragged", SCAN_RAGGED, True, False, True),
             ("long, h0", SCAN_LONG, True, True, True),
             ("S 1, h0", SCAN_S1, True, False, True),
             ("S < tile, h0", SCAN_SHORT, True, False, True),
             ("N 4, ragged Di", SCAN_N4, True, False, True),
             ("N 8, ragged Di", SCAN_N8, True, True, True)]
    for what, (ba, s, di, n), with_h0, views, random_a in cases:
        u, dt, a, b, c, d, h0 = scan_inputs(torch, gen, dev, ba, s, di, n,
                                            h0=with_h0, views=views,
                                            random_a=random_a)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).replace("torch.", "")
            ud = u.to(dtype)
            y, h = K.selective_scan_cuda(ud, dt, a, b, c, d, h0=h0)
            y2, h2 = K.selective_scan_cuda(ud, dt, a, b, c, d, h0=h0)
            torch.cuda.synchronize()
            same = bool(torch.equal(y, y2) and torch.equal(h, h2))
            del y2, h2
            wy, wh = R.selective_scan(ud, dt, a, b, c, d, h0=h0)
            y_abs, h_abs = max_err(y, wy), max_err(h, wh)
            y_row = row_rel_err(y, wy)
            y_rtol = SCAN_TOL if dtype == torch.float32 else SCAN_Y_RTOL_BF16
            y_over = allclose_excess(y, wy, y_rtol)
            h_over = allclose_excess(h, wh, SCAN_TOL)
            errs["selective_scan"] = max(errs["selective_scan"], y_abs,
                                         h_abs)
            rel_errs["selective_scan"][dn] = max(
                rel_errs["selective_scan"].get(dn, 0.0), y_row)
            case = f"Ba{ba} S{s} Di{di} N{n} {what}"
            vec = K.vector_loads(ud, dt, b, c)
            checks.append({"kernel": "selective_scan", "case": case,
                           "dtype": dn, "vector_loads": vec,
                           "bitwise_repeat": same, "y_max_abs_err": y_abs,
                           "y_max_row_rel_err": y_row,
                           "h_last_max_abs_err": h_abs,
                           "y_allclose_excess": y_over,
                           "h_last_allclose_excess": h_over,
                           "y_rtol": y_rtol, "atol": SCAN_TOL})
            log(f"  selective_scan {case:38s} {dn:9s} y max|err| "
                f"{y_abs:.2e} (beyond rtol {y_rtol:.2g}: {y_over:.1e}, "
                f"atol {SCAN_TOL:g}), row-relative (RMS) {y_row:.2e}; h_last "
                f"max|err| {h_abs:.2e} (beyond rtol: {h_over:.1e}); "
                f"{'16-byte' if vec else 'plain'} staging, two calls "
                f"{'bitwise equal' if same else 'DIFFER'}")
            require(same, f"selective_scan {case} {dn}: two calls on the "
                    "same inputs differ")
            require(y.dtype == dtype and h.dtype == torch.float32,
                    f"selective_scan {case}: dtypes {y.dtype}, {h.dtype}")
            require(math.isfinite(h_over) and h_over <= SCAN_TOL,
                    f"selective_scan {case} {dn}: h_last beyond rtol = atol"
                    f" {SCAN_TOL} by {h_over}")
            require(math.isfinite(y_over) and y_over <= SCAN_TOL,
                    f"selective_scan {case} {dn}: y beyond rtol {y_rtol} by "
                    f"{y_over} (atol {SCAN_TOL})")
            del y, h, wy, wh, ud
        del u, dt, a, b, c, d, h0
    torch.cuda.empty_cache()
    return checks


# (case, shape, h0, B/C as column views, dh_last): the first as the hybrid
# phase's train cut calls it (B and C made contiguous by their fp32 cast,
# no h0, no gradient into h_last)
SCAN_BWD_CASES = (("train cut", SCAN_TRAIN, False, False, False),
                  ("train shape, B/C views, dh_last", SCAN_TRAIN, False, True,
                   True),
                  ("full width, h0, dh_last", SCAN_FULL, True, False, True),
                  ("full width, B/C views", SCAN_FULL, False, True, True),
                  ("ragged, h0", SCAN_RAGGED, True, True, False),
                  ("N 4, ragged Di, h0", SCAN_N4, True, False, False),
                  ("N 8, ragged Di, h0, dh_last", SCAN_N8, True, True,
                   True))
# each gradient's largest |kernel - plain| over its largest |plain|: both
# sum in fp32 in other orders (dB and dC over 16,384 channels, dA and dD
# over batch and time; the kernel's exponentials are ex2.approx), ~1e-5 of
# the largest term; bf16 u rounds du to bf16 on both sides, so du may be
# one bf16 ulp (2^-8 of its value) apart where the two fp32 values straddle
# a rounding boundary
SCAN_BWD_TOL = 1e-4
SCAN_BWD_DU_TOL_BF16 = 2.0 ** -7
SCAN_BWD_NAMES = ("du", "ddt", "dA", "dB", "dC", "dD", "dh0")


def check_selective_scan_bwd(torch, dev, errs):
    """The selective-scan backward against its plain version
    (``ref.selective_scan_bwd``) on the states its own forward saved: at
    the hybrid phase's train shape (Ba 8, S 1024) as its train cut calls it
    and with B/C views and dh_last, at Jamba's full width with h0 and
    dh_last and with B and C as the layer's column views, at a ragged
    shape, and at N 4 and 8 with a ragged Di (4100 staged by plain loads in
    the forward, 4104 by 16-byte copies); fp32 and bf16 u; two calls
    bitwise equal."""
    from repro_torch.kernels.selective_scan import kernel as K
    from repro_torch.kernels.selective_scan import ref as R
    gen = torch.Generator(device=dev).manual_seed(5)
    checks = []
    for what, (ba, s, di, n), with_h0, views, with_dh in SCAN_BWD_CASES:
        u, dt, a, b, c, d, h0 = scan_inputs(torch, gen, dev, ba, s, di, n,
                                            h0=with_h0, views=views,
                                            random_a=True)
        dh = torch.randn((ba, di, n), generator=gen, device=dev) \
            if with_dh else None
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).replace("torch.", "")
            ud = u.to(dtype)
            dy = torch.randn((ba, s, di), generator=gen, device=dev).to(dtype)
            y, h_last, states = K.selective_scan_fwd_saving_cuda(
                ud, dt, a, b, c, d, h0=h0)
            y0, h0_plain = K.selective_scan_cuda(ud, dt, a, b, c, d, h0=h0)
            got = K.selective_scan_bwd_cuda(ud, dt, a, b, c, d, states, dy,
                                            dh_last=dh,
                                            want_dh0=h0 is not None)
            again = K.selective_scan_bwd_cuda(ud, dt, a, b, c, d, states, dy,
                                              dh_last=dh,
                                              want_dh0=h0 is not None)
            torch.cuda.synchronize()
            same_fwd = bool(torch.equal(y, y0) and torch.equal(h_last,
                                                               h0_plain))
            same = all(g is None and r is None or torch.equal(g, r)
                       for g, r in zip(got, again))
            del y, y0, h_last, h0_plain, again, states
            want = R.selective_scan_bwd(ud, dt, a, b, c, d, dy, h0=h0,
                                        dh_last=dh)
            rel = {}
            for name, g, w in zip(SCAN_BWD_NAMES, got, want):
                if w is None:
                    require(g is None, f"selective_scan_bwd: {name} without "
                            "h0")
                    continue
                require(g.dtype == w.dtype and g.shape == w.shape,
                        f"selective_scan_bwd {name}: {g.dtype} "
                        f"{tuple(g.shape)} against {w.dtype} "
                        f"{tuple(w.shape)}")
                rel[name] = max_err(g, w) / max(w.float().abs().max().item(),
                                                1e-30)
            errs["selective_scan_bwd"] = max(
                errs.get("selective_scan_bwd", 0.0),
                max(max_err(g, w) for g, w in zip(got, want)
                    if w is not None))
            case = f"Ba{ba} S{s} Di{di} N{n} {what}"
            tols = {k: SCAN_BWD_DU_TOL_BF16 if (k == "du" and dtype ==
                                                 torch.bfloat16)
                    else SCAN_BWD_TOL for k in rel}
            checks.append({"kernel": "selective_scan_bwd", "case": case,
                           "dtype": dn, "bitwise_repeat": same,
                           "forward_saving_equals_forward": same_fwd,
                           "max_err_over_max": rel, "tol": tols})
            log(f"  selective_scan_bwd {case:54s} {dn:9s} max|err| / "
                f"max|plain|: " + ", ".join(f"{k} {v:.1e}" for k, v in
                                            rel.items())
                + f" (tol {SCAN_BWD_TOL:g}"
                + (f", du {SCAN_BWD_DU_TOL_BF16:.2g}" if dtype ==
                   torch.bfloat16 else "")
                + f"); two calls {'bitwise equal' if same else 'DIFFER'}; "
                f"the saving forward {'equals' if same_fwd else 'DIFFERS'}"
                " the forward bitwise")
            require(same, f"selective_scan_bwd {case} {dn}: two calls "
                    "differ")
            require(same_fwd, f"selective_scan {case} {dn}: the forward "
                    "that saves states differs from the forward")
            for k, v in rel.items():
                require(math.isfinite(v) and v <= tols[k],
                        f"selective_scan_bwd {case} {dn}: {k} error {v} > "
                        f"{tols[k]} of its largest value")
            del got, want, ud, dy
        del u, dt, a, b, c, d, h0, dh
    torch.cuda.empty_cache()
    return checks


# -- phase 4 -------------------------------------------------------------------

def request_frames(cfg, rng):
    """One request's (enc_seq, d) fp32 frames for an encoder-decoder (the
    reference stubs the audio frontend), None otherwise."""
    import numpy as np
    if not cfg.enc_dec:
        return None
    return (rng.randn(cfg.enc_seq, cfg.d_model) * 0.02).astype(np.float32)


def with_frames(cfg, batch, seed):
    """``batch`` with an encoder-decoder's (B, enc_seq, d) fp32 frames drawn
    from ``seed`` (numpy: the same on every device); unchanged otherwise."""
    import numpy as np
    if not cfg.enc_dec:
        return batch
    rng = np.random.RandomState(seed)
    return dict(batch, frames=np.stack([request_frames(cfg, rng)
                                        for _ in range(len(batch["tokens"]))]))


def request_images(cfg, rng):
    """One request's (vision_tokens, d) fp32 image rows for a vision config
    (the reference stubs the vision encoder), None otherwise."""
    import numpy as np
    if cfg.frontend != "vision":
        return None
    return (rng.randn(cfg.vision_tokens, cfg.d_model) * 0.02).astype(
        np.float32)


def smoke_requests(cfg, GenerationConfig, Request):
    import numpy as np
    rng = np.random.RandomState(0)
    return [Request(tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
                    gen=GenerationConfig(max_new_tokens=nn), id=f"s{i}",
                    frames=request_frames(cfg, rng),
                    image_embeds=request_images(cfg, rng))
            for i, (ln, nn) in enumerate(((40, 12), (17, 20), (40, 9),
                                          (70, 16)))]


def reference_lm(torch, dev, cfg, tag):
    """One smoke LM at fp32 on the card (kernels) against the same model on
    the CPU (plain versions): prefill + 3 decode logits within 1e-4, and
    greedy engine tokens on the card's contiguous and paged pools equal to
    the CPU's.  Returns the worst logit error and the card's launches."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, GenerationConfig, Request
    from repro_torch.tree import tree_map
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    dparams = tree_map(lambda t: t.to(dev), params)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen)}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                      generator=gen) * 0.02
    if cfg.frontend == "vision":
        batch["image_embeds"] = torch.randn(
            (2, cfg.vision_tokens, cfg.d_model), generator=gen) * 0.02
    prefix = cfg.vision_tokens if cfg.frontend == "vision" else 0
    worst = 0.0
    lc, cache = {}, {}
    LAUNCHES.reset()
    for name, p, d in (("cpu", params, "cpu"), ("cuda", dparams, dev)):
        lc[name], cache[name], _ = M.prefill(
            cfg, p, {k: t.to(d) for k, t in batch.items()}, 64)
    worst = max(worst, max_err(lc["cuda"].cpu(), lc["cpu"]))
    tok = torch.argmax(lc["cpu"][:, :cfg.vocab_size], -1)
    pos = torch.tensor([40, 40], dtype=torch.int32) + prefix
    for _ in range(3):
        out = {}
        for name, p, d in (("cpu", params, "cpu"), ("cuda", dparams, dev)):
            out[name], _ = M.decode_step(cfg, p, cache[name], tok.to(d),
                                         pos.to(d))
        worst = max(worst, max_err(out["cuda"].cpu(), out["cpu"]))
        tok = torch.argmax(out["cpu"][:, :cfg.vocab_size], -1)
        pos = pos + 1
    log(f"  {tag} fp32 prefill + 3 decode logits, card vs CPU: max|err| "
        f"{worst:.3e} (tol 1e-4)")
    require(worst <= 1e-4, f"{tag}: card vs CPU logits differ by {worst}")
    reqs = smoke_requests(cfg, GenerationConfig, Request)
    toks_by = {}
    for d, paged in (("cpu", False), (dev, False), (dev, True)):
        eng = Engine(cfg, params, device=d, max_slots=2, decode_block=4,
                     paged=paged)
        toks_by[(str(d), paged)] = [c.tokens for c in eng.generate(reqs)]
    launches = LAUNCHES.snapshot()
    want = toks_by[("cpu", False)]
    for key, got in toks_by.items():
        require(got == want, f"{tag}: engine tokens on {key} differ from "
                "the CPU's")
    log(f"  {tag} fp32 engine greedy tokens: card contiguous == card paged "
        f"== CPU ({sum(len(t) for t in want)} tokens); card launches "
        f"{launches}")
    return worst, launches


# smoke variants whose heads reach the new kernel cases (the CPU tests'
# ``tests/test_torch_dense.py`` variants at head dims the kernels take):
# stablelm's at D 80 (d 320, 4/4 heads), chatglm3's at 16 query heads a KV
# head (d 1024, 16/1 heads of 64), mistral-large's at 12 (d 768, 12/1 of 64)
DENSE_SMOKE = {"smoke stablelm D80": ("stablelm-3b", dict(d_model=320)),
               "smoke chatglm3 G16": ("chatglm3-6b", dict(
                   d_model=1024, n_heads=16, n_kv_heads=1)),
               "smoke mistral-large G12": ("mistral-large-123b", dict(
                   d_model=768, n_heads=12, n_kv_heads=1))}


def reference_dense(torch, dev):
    """``DENSE_SMOKE`` served card against CPU (``reference_lm``), and the
    D-80 stablelm through the LM schedule (``reference_lm_train``: the fp32
    backward kernels at D 80)."""
    from repro_torch.configs import get
    out = {}
    for tag, (arch, kw) in DENSE_SMOKE.items():
        cfg = get(arch, smoke=True).replace(dtype="float32", **kw)
        worst, launches = reference_lm(torch, dev, cfg, tag)
        require(launches.get("decode_attention", 0) > 0,
                f"{tag}: no decode kernel launched: {launches}")
        out[tag] = {"hd": cfg.hd, "q_per_kv": cfg.q_per_kv,
                    "logits_max_abs_err": worst, "launches": launches}
    arch, kw = DENSE_SMOKE["smoke stablelm D80"]
    out["smoke stablelm D80 train"] = reference_lm_train(
        torch, dev, get(arch, smoke=True).replace(**kw),
        "smoke stablelm D80")
    return out


# whisper-tiny's smoke config at a head dim the kernels take: the
# reference's smoke() (d 128, 4 heads of 32) with 2 heads of 64, and 100
# encoder frames (not a multiple of 16 or 64, so the small model reaches
# the kernels' ragged key and query tiles and the decode's ragged last
# tile); the CPU tests run the reference's smoke() as it is
WHISPER_SMOKE = dict(n_heads=2, n_kv_heads=2, enc_seq=100)


def reference_whisper(torch, dev):
    """The ``WHISPER_SMOKE`` variant on the card against the CPU: prefill
    and decode logits and greedy engine tokens on both pools
    (``reference_lm``, each request with its own frames), the staged
    engine against the joined one (``reference_staged``), and the LM
    schedule at fp32 (``reference_lm_train``: the SIL stage, the live
    frozen prefix's (x, enc_out) payload, recovery; the non-causal
    backward kernels at 100 frames)."""
    from repro_torch.configs import get
    tag = "smoke whisper D64"
    cfg = get(WHISPER_ARCH, smoke=True).replace(**WHISPER_SMOKE)
    worst, launches = reference_lm(torch, dev, cfg.replace(dtype="float32"),
                                   tag)
    require(all(launches.get(k, 0) > 0 for k in (
        "flash_attention", "decode_attention", "paged_decode_attention")),
        f"{tag}: the card's runs missed an attention kernel: {launches}")
    return {"hd": cfg.hd, "enc_seq": cfg.enc_seq,
            "logits_max_abs_err": worst, "launches": launches,
            "staged": reference_staged(torch, dev, cfg, tag),
            "train": reference_lm_train(torch, dev, cfg, tag,
                                        leaf_scaled=True)}


def reference_xlstm(torch, dev):
    """xlstm-125m's smoke config (4 layers, d 256) at fp32 on the card
    against the CPU (``reference_lm``: prefill and decode logits, greedy
    engine tokens on both pools; a 70-token prompt pads its second mLSTM
    chunk), launching none of the port's kernels."""
    from repro_torch.configs import get
    tag = "smoke xLSTM"
    worst, launches = reference_lm(
        torch, dev, get(XLSTM_ARCH, smoke=True).replace(dtype="float32"), tag)
    require(not any(launches.values()),
            f"{tag}: the card's runs launched a kernel: {launches}")
    return {"logits_max_abs_err": worst, "launches": launches}


def phase_reference(torch, dev, report):
    """The port on the card against its plain path on the CPU, fp32: the
    smoke qwen2, the smoke Jamba without experts (2 groups of mamba +
    attention) and with them (Mamba + MoE, attention + dense, twice), the
    smoke granite (2 MoE layers, 4 experts, top 2), ``DENSE_SMOKE`` (head
    dim 80, 16 and 12 query heads a KV head) and the small MLP; the smoke
    qwen2, the D-80 stablelm and Jamba's attention-free smoke cut (2 Mamba
    layers, one a stage) through the LM schedule.  A routing flip between
    the card's kernels and the plain versions would show in the MoE
    models' logits and tokens."""
    from repro_torch.configs import get
    worst, _ = reference_lm(torch, dev, get("qwen2-1.5b", smoke=True).replace(
        dtype="float32"), "smoke qwen2")
    moe = {}
    for tag, cfg in (
            ("smoke Jamba (no experts)", get("jamba-1.5-large-398b",
                                             smoke=True).replace(moe=None)),
            ("smoke Jamba with experts", get("jamba-1.5-large-398b",
                                             smoke=True)),
            ("smoke granite", get("granite-moe-3b-a800m", smoke=True))):
        moe[tag] = reference_lm(torch, dev, cfg.replace(dtype="float32"),
                                tag)
    for tag in ("smoke Jamba (no experts)", "smoke Jamba with experts"):
        require(moe[tag][1].get("selective_scan", 0) > 0,
                f"the {tag} on the card launched no selective scan: "
                f"{moe[tag][1]}")
    h_worst, h_launches = moe.pop("smoke Jamba (no experts)")
    report["reference"] = {"logits_max_abs_err": worst, "tol": 1e-4,
                           "engine_tokens_equal": True,
                           "hybrid_logits_max_abs_err": h_worst,
                           "hybrid_launches": h_launches,
                           "moe": {tag: {"logits_max_abs_err": w,
                                         "launches": n}
                                   for tag, (w, n) in moe.items()},
                           "mlp": reference_mlp(torch, dev),
                           "lm_train": reference_lm_train(torch, dev),
                           "baseline": reference_baseline(torch, dev),
                           # Jamba's attention-free cut (the hybrid phase's
                           # train cut at smoke widths): the scan's backward
                           "hybrid_train": reference_lm_train(
                               torch, dev, get("jamba-1.5-large-398b",
                                               smoke=True).replace(
                                   n_layers=2, attn_period=8, moe=None),
                               "smoke Jamba attention-free", (
                                   "selective_scan", "selective_scan_bwd",
                                   "sil_mse"), leaf_scaled=True),
                           "lm_parallel": reference_lm_parallel(torch, dev),
                           "lm_fig3": reference_lm_fig3(torch, dev),
                           "staged": reference_staged(torch, dev),
                           "dense": reference_dense(torch, dev),
                           "whisper": reference_whisper(torch, dev),
                           "xlstm": reference_xlstm(torch, dev),
                           "llava": reference_llava(torch, dev)}


# card against CPU over a short training run: cuBLAS and the CPU's GEMMs sum
# in other orders (~1e-7 relative a step), which 64 momentum steps grow
MLP_LOSS_RTOL, MLP_LOSS_ATOL = 1e-4, 1e-6


def reference_mlp(torch, dev):
    """The smoke MLP (784-32-16-16-47) through Fig. 3 + §5 on the card and
    on the CPU, from the same params and SIL (drawn on the CPU): per-step
    losses Allclose, accuracies within two test samples, MACs equal, and the
    card's run through the SIL-MSE kernel."""
    from repro_torch.configs import paper_mlp
    from repro_torch.data.images import emnist_like
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import mlp as MLP
    from repro_torch.train import recipes
    from repro_torch.core import sil as sil_lib
    from repro_torch.verify.compare import Allclose
    cfg = paper_mlp.smoke()
    n_test = 256
    data = emnist_like(n_train=2048, n_test=n_test, seed=0, noise=0.5)
    spec = recipes.paper_spec(n_left=2, n_right=2, n_baseline=2,
                              n_recovery=2, batch_size=128)
    gen = torch.Generator().manual_seed(0)
    params = MLP.init_params(cfg, gen)
    sil = sil_lib.make_sil(gen, cfg.boundary_width, cfg.n_classes,
                           spec.kappa)
    hist, launches = {}, {}
    for d in ("cpu", dev):
        LAUNCHES.reset()
        _, hist[str(d)] = recipes.run_mlp_fig3(
            cfg, data, spec, params=[{k: v.to(d) for k, v in p.items()}
                                     for p in params],
            sil=sil.to(d), device=d)
        launches[str(d)] = LAUNCHES.get("sil_mse")
    cpu, card = hist["cpu"], hist[str(dev)]
    verdict = Allclose(MLP_LOSS_RTOL, MLP_LOSS_ATOL).compare(
        cpu.column("loss"), card.column("loss"))
    acc_gap = max(abs(a - b) for a, b in zip(cpu.column("acc"),
                                              card.column("acc")))
    log(f"  MLP {cfg.sizes} Fig. 3 + §5, {len(card.column('loss'))} steps, "
        f"card vs CPU: losses {verdict.detail or 'allclose'} "
        f"(max|err| {verdict.metrics.get('max_abs_err', float('nan')):.2e},"
        f" rtol {MLP_LOSS_RTOL:g}, atol {MLP_LOSS_ATOL:g}); acc gap "
        f"{acc_gap:.4f} (tol {2 / n_test:.4f}); MACs equal "
        f"{cpu.column('macs') == card.column('macs')}; sil_mse launches "
        f"{launches[str(dev)]} (CPU {launches['cpu']})")
    require(verdict.ok, f"MLP losses card vs CPU: {verdict.detail}")
    require(acc_gap <= 2 / n_test, f"MLP accuracy gap card vs CPU {acc_gap}")
    require(cpu.column("macs") == card.column("macs"), "MLP MACs differ")
    require(launches[str(dev)] > 0 and launches["cpu"] == 0,
            f"sil_mse launches: card {launches[str(dev)]}, CPU "
            f"{launches['cpu']}")
    return {"losses": verdict.metrics, "acc_gap": acc_gap,
            "n_steps": len(card.column("loss")),
            "sil_mse_launches": launches[str(dev)]}


# card against CPU over the smoke LM's whole schedule: AdamW's early steps
# move an element with a rounding-level gradient by up to lr either way
# (tests/test_torch_lm_train.py: 1% of the elements of a leaf at most), which
# moved the port's CPU losses by up to ~2e-6 relative against the reference
# over 9 steps; the card's cuBLAS and kernel sums differ from the CPU's as
# the two frameworks' do.  Ten times that margin, and an atol for losses
# near zero:
LM_LOSS_RTOL, LM_LOSS_ATOL = 1e-4, 1e-5
LM_SMOKE_BATCH, LM_SMOKE_SEQ = 2, 64


# the first-step gradients of a model with Mamba layers, card against CPU:
# each leaf within rtol 1e-5 and 1e-5 of its largest magnitude (the tier
# test_torch_lm_boundary.py holds stored rows at): the scan's kernels take
# every exponential as ex2.approx (2^-22 relative) and sum in their own
# orders, and a leaf's error scales with its magnitude through the chain
LEAF_ATOL = 1e-5


def reference_lm_train(torch, dev, cfg=None, tag="smoke LM",
                       need=("flash_attention", "flash_attention_bwd",
                             "sil_mse"), leaf_scaled=False):
    """A smoke LM (by default qwen2's: 2 layers, d 256, 4/2 heads of 64,
    vocab 512) through the LM schedule at fp32 on the card and on the CPU,
    from the same params, SIL table (class-major, as the LM backend draws
    it) and batches.  First each step function's loss and gradients on the
    first batch (the SIL stage, stage 1's CE on the live prefix, recovery)
    at the fp32 tier; then ``run_lm_sequential`` (3 steps a stage, 3 of
    recovery): every step's loss within ``LM_LOSS_RTOL`` /
    ``LM_LOSS_ATOL``, and the card's run through the kernels ``need``
    names.  ``leaf_scaled`` holds the first-step gradients leaf by leaf at
    ``LEAF_ATOL`` of the leaf's largest magnitude."""
    from repro_torch.configs import get
    from repro_torch.core import partition, sil as sil_lib
    from repro_torch.data.lm import lm_batches, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.train import recipes
    from repro_torch.train.backends import LMBackend, value_and_accum_grads
    from repro_torch.train.spec import StageSpec, TrainSpec
    from repro_torch.tree import tree_map
    from repro_torch.verify.compare import Allclose
    cfg = cfg or get("qwen2-1.5b", smoke=True)
    plan = partition.make_plan(cfg, 2)
    spec = TrainSpec(n_stages=2, kappa=1.0, precision="fp32", stages=(
        StageSpec(steps=3, lr=1e-3, optimizer="adamw"),) * 2,
        recovery=StageSpec(steps=3, lr=1e-4, optimizer="adamw"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    sil = sil_lib.make_sil(torch.Generator().manual_seed(1), cfg.d_model,
                           cfg.vocab_size, 1.0, class_major=True)
    stream = synthetic_token_stream(20_000, cfg.vocab_size, seed=0)
    it = lm_batches(stream, LM_SMOKE_BATCH, LM_SMOKE_SEQ, seed=0)
    batches = [with_frames(cfg, next(it), i) for i in range(4)]

    def first_steps(d):
        """{step: (loss, grads)} of the three step functions' losses."""
        be = LMBackend(cfg, plan, lambda i: batches[i % 4], spec, device=d)
        sp = be.split(tree_map(lambda t: t.to(d), params))
        be.before_stage_train(sp, 1)
        b = be.batch_fn(0)
        trained = be.trainable(sp[1])
        snap = {k: v for k, v in sp[1].items() if k not in trained}
        h = be.prefix_forward(1)(tuple(sp[:1]), b)
        frozen = [tree_map(lambda t: t.detach(), x) for x in sp]
        return {
            "left": value_and_accum_grads(be.stage_loss(0, sil.to(d), {}),
                                          sp[0], (b, b["labels"], None)),
            "right": value_and_accum_grads(be.stage_loss(1, None, snap),
                                           trained,
                                           (h, b["labels"], None)),
            "recovery": value_and_accum_grads(
                be.recovery_loss(0, frozen, {}), sp[0], (b,))}

    cpu, card = first_steps("cpu"), first_steps(dev)
    first = {}
    for name in cpu:
        (lc, gc), (ld, gd) = cpu[name], card[name]
        gd = [g.cpu() for g in gd]
        if leaf_scaled:
            checks = [Allclose().compare(lc, ld.cpu())] + [
                Allclose(atol=LEAF_ATOL * g.abs().max().item()).compare(g, h)
                for g, h in zip(gc, gd)]
            bad = [i for i, c in enumerate(checks) if not c.ok]
            v = checks[bad[0]] if bad else checks[0]
            err = max(c.metrics.get("max_abs_err", 0.0) for c in checks)
            tier = f"fp32 tier, grads atol {LEAF_ATOL:g} of a leaf's max"
        else:
            v = Allclose().compare([lc] + gc, [ld.cpu()] + gd)
            err, tier = v.metrics.get("max_abs_err", float("nan")), \
                "fp32 tier"
        first[name] = {"max_abs_err": err}
        log(f"  {tag} {name:9s} first step card vs CPU, fp32: loss "
            f"{lc.item():.6f} / {ld.item():.6f}, loss and {len(gc)} grads "
            f"{v.detail or 'allclose'} (max|err| {err:.2e}, {tier})")
        require(v.ok, f"{tag} {name} first-step loss or grads card vs "
                f"CPU: {v.detail}")
    hist, launches = {}, {}
    for d in ("cpu", dev):
        LAUNCHES.reset()
        _, hist[str(d)] = recipes.run_lm_sequential(
            cfg, plan, tree_map(lambda t: t.to(d), params),
            lambda i: batches[i % 4], spec, sils=[sil.to(d)], device=d)
        launches[str(d)] = LAUNCHES.snapshot()
    lc, ld = hist["cpu"].column("loss"), hist[str(dev)].column("loss")
    v = Allclose(LM_LOSS_RTOL, LM_LOSS_ATOL).compare(lc, ld)
    log(f"  {tag} run_lm_sequential, {len(ld)} steps card vs CPU, fp32: "
        f"losses {v.detail or 'allclose'} (max|err| "
        f"{v.metrics.get('max_abs_err', float('nan')):.2e}, rtol "
        f"{LM_LOSS_RTOL:g}, atol {LM_LOSS_ATOL:g}); card launches "
        f"{launches[str(dev)]}, CPU {launches['cpu']}")
    require(v.ok, f"{tag} losses card vs CPU: {v.detail}")
    require(hist["cpu"].column("phase") == hist[str(dev)].column("phase"),
            f"{tag} phase records differ")
    require(all(launches[str(dev)].get(k, 0) > 0 for k in need)
            and not launches["cpu"],
            f"{tag} launches: card {launches[str(dev)]}, CPU "
            f"{launches['cpu']}")
    return {"first_step": first, "losses": v.metrics, "n_steps": len(ld),
            "launches": launches[str(dev)]}


BASELINE_SMOKE_STEPS = 3


def reference_baseline(torch, dev):
    """The smoke qwen2's unpartitioned train step
    (``launch.steps.build_train_step``, AdamW at lr 1e-3) at fp32 on the
    card and on the CPU, from the same params and batches: the first
    step's ``loss``, ``ce`` and ``grad_norm`` at the fp32 tier, every
    step's within ``LM_LOSS_RTOL`` / ``LM_LOSS_ATOL`` (AdamW's first steps
    move an element whose gradient is at rounding level by up to lr either
    way, as ``reference_lm_train`` allows), and the card's steps through
    the prefill and backward kernels."""
    from repro_torch.configs import get
    from repro_torch.data.lm import lm_batches, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_map
    from repro_torch.verify.compare import Allclose
    cfg = get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    stream = synthetic_token_stream(20_000, cfg.vocab_size, seed=0)
    it = lm_batches(stream, LM_SMOKE_BATCH, LM_SMOKE_SEQ, seed=0)
    batches = [next(it) for _ in range(BASELINE_SMOKE_STEPS)]
    got, launches = {}, {}
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d, copy=True), params)
        opt = make_optimizer("adamw", 1e-3)
        state, step = opt.init(p), build_train_step(cfg, opt)
        LAUNCHES.reset()
        rows = []
        for b in batches:
            p, state, m = step(p, state, {k: torch.as_tensor(v).long().to(d)
                                          for k, v in b.items()})
            rows.append(torch.stack([m[k] for k in ("loss", "ce",
                                                    "grad_norm")]).cpu())
        got[str(d)] = torch.stack(rows)
        launches[str(d)] = LAUNCHES.snapshot()
    v = Allclose().compare(got["cpu"][0], got[str(dev)][0])
    va = Allclose(LM_LOSS_RTOL, LM_LOSS_ATOL).compare(got["cpu"],
                                                      got[str(dev)])
    log(f"  smoke qwen2 baseline train step card vs CPU, fp32: (loss, ce, "
        f"grad_norm) {got[str(dev)].tolist()} / {got['cpu'].tolist()}: the "
        f"first "
        f"{v.detail or 'allclose'} (max|err| "
        f"{v.metrics.get('max_abs_err', float('nan')):.2e}, fp32 tier), all"
        f" {BASELINE_SMOKE_STEPS} {va.detail or 'allclose'} (rtol "
        f"{LM_LOSS_RTOL:g}, atol {LM_LOSS_ATOL:g}); card launches "
        f"{launches[str(dev)]}")
    require(v.ok and va.ok, "the smoke baseline step card vs CPU: "
            f"{v.detail or va.detail}")
    need = ("flash_attention", "flash_attention_bwd")
    require(all(launches[str(dev)].get(k, 0) > 0 for k in need)
            and not launches["cpu"],
            f"smoke baseline launches: card {launches[str(dev)]}, CPU "
            f"{launches['cpu']}")
    return {"steps": got[str(dev)].tolist(), "cpu": got["cpu"].tolist(),
            "first": v.metrics,
            "all": va.metrics, "launches": launches[str(dev)]}


def reference_lm_parallel(torch, dev):
    """The smoke qwen2 through ``run_lm_parallel`` (Fig. 5: both stages at
    once, 3 ticks, through the stage executor) at fp32 on the card and on
    the CPU, from the same params, SIL table and batches: every (tick,
    stage) loss within ``LM_LOSS_RTOL`` / ``LM_LOSS_ATOL``, the card's run
    through the prefill, its backward and SIL-MSE."""
    from repro_torch.configs import get
    from repro_torch.core import sil as sil_lib
    from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.train import recipes
    from repro_torch.train.spec import StageSpec, TrainSpec
    from repro_torch.tree import tree_map
    from repro_torch.verify.compare import Allclose
    cfg = get("qwen2-1.5b", smoke=True)
    spec = TrainSpec(n_stages=2, kappa=1.0, precision="fp32", stages=(
        StageSpec(steps=3, lr=1e-3, optimizer="adamw"),) * 2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    sil = sil_lib.make_sil(torch.Generator().manual_seed(1), cfg.d_model,
                           cfg.vocab_size, 1.0, class_major=True)
    stream = synthetic_token_stream(20_000, cfg.vocab_size, seed=0)
    hist, launches = {}, {}
    for d in (torch.device("cpu"), dev):
        LAUNCHES.reset()
        _, hist[d.type] = recipes.run_lm_parallel(
            cfg, 2, tree_map(lambda t: t.to(d), params),
            lambda i: lm_batch_at(stream, LM_SMOKE_BATCH, LM_SMOKE_SEQ, i),
            spec, sils=[sil.to(d)], dist="round_robin", dist_devices=[d],
            device=d)
        launches[d.type] = LAUNCHES.snapshot()
    cpu, card = hist["cpu"], hist["cuda"]
    v = Allclose(LM_LOSS_RTOL, LM_LOSS_ATOL).compare(cpu.column("loss"),
                                                     card.column("loss"))
    log(f"  smoke LM run_lm_parallel (executor), {len(card.column('loss'))}"
        f" (tick, stage) losses card vs CPU, fp32: {v.detail or 'allclose'}"
        f" (max|err| {v.metrics.get('max_abs_err', float('nan')):.2e}, rtol"
        f" {LM_LOSS_RTOL:g}, atol {LM_LOSS_ATOL:g}); card launches "
        f"{launches['cuda']}, CPU {launches['cpu']}")
    require(v.ok, f"smoke LM Fig.-5 losses card vs CPU: {v.detail}")
    require([(r.step, r.stage) for r in cpu.records]
            == [(r.step, r.stage) for r in card.records]
            == [(i, k) for i in range(3) for k in range(2)],
            "smoke LM Fig.-5 records differ")
    need = ("flash_attention", "flash_attention_bwd", "sil_mse")
    require(all(launches["cuda"].get(k, 0) > 0 for k in need)
            and not launches["cpu"],
            f"smoke LM Fig.-5 launches: card {launches['cuda']}, CPU "
            f"{launches['cpu']}")
    return {"losses": v.metrics, "n_losses": len(card.column("loss")),
            "launches": launches["cuda"]}


class Tap:
    """A phase that hands the trainer's state to ``fn``: reads what the
    trainer keeps to itself (the boundary cache before the run closes it,
    the trained stage trees) without touching the card."""
    needs_sil = False

    def __init__(self, fn):
        self.fn = fn

    def run(self, trainer, state):
        self.fn(state)


def fig3_phases(n_batches, taps=None, source="cache", spill_dir=None,
                recovery=True):
    """The reference's Fig. 3 composition for the 2-stage LM (with
    ``source="live"`` and no ``n_batches``, its live-prefix schedule);
    ``taps`` maps a phase's name to a ``fn(state)`` run just after it."""
    from repro_torch.train import (BoundaryMaterializePhase,
                                   FrozenPrefixPhase, RecoveryPhase,
                                   SilStagePhase)
    phases = [SilStagePhase(stage=0)]
    if n_batches:
        phases.append(BoundaryMaterializePhase(upto=1, n_batches=n_batches,
                                               spill_dir=spill_dir))
    phases.append(FrozenPrefixPhase(stage=1, source=source))
    if recovery:
        phases.append(RecoveryPhase(stage=0))
    out = []
    for phase in phases:
        out.append(phase)
        if taps and phase.name in taps:
            out.append(Tap(taps[phase.name]))
    return out


def reference_lm_fig3(torch, dev):
    """The smoke qwen2 through the paper's Fig. 3 (3 SIL steps, the stored
    boundary of 3 batches, 3 CE steps on it, 3 of recovery) at fp32 on the
    card and on the CPU, from the same params, SIL table and batches: every
    step's loss within ``LM_LOSS_RTOL`` / ``LM_LOSS_ATOL``, the card's run
    through the prefill, its backward and SIL-MSE."""
    from repro_torch.configs import get
    from repro_torch.core import partition, sil as sil_lib
    from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.train import LMBackend, Trainer
    from repro_torch.train.spec import StageSpec, TrainSpec
    from repro_torch.tree import tree_map
    from repro_torch.verify.compare import Allclose
    cfg = get("qwen2-1.5b", smoke=True)
    spec = TrainSpec(n_stages=2, kappa=1.0, precision="fp32", stages=(
        StageSpec(steps=3, lr=1e-3, optimizer="adamw"),) * 2,
        recovery=StageSpec(steps=3, lr=1e-4, optimizer="adamw"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    sil = sil_lib.make_sil(torch.Generator().manual_seed(1), cfg.d_model,
                           cfg.vocab_size, 1.0, class_major=True)
    stream = synthetic_token_stream(20_000, cfg.vocab_size, seed=0)
    hist, launches = {}, {}
    for d in (torch.device("cpu"), dev):
        be = LMBackend(cfg, partition.make_plan(cfg, 2),
                       lambda i: lm_batch_at(stream, LM_SMOKE_BATCH,
                                             LM_SMOKE_SEQ, i), spec, device=d)
        LAUNCHES.reset()
        _, hist[d.type] = Trainer(be, spec).run(
            fig3_phases(3), params=tree_map(lambda t: t.to(d), params),
            sils=[sil.to(d)])
        launches[d.type] = LAUNCHES.snapshot()
    cpu, card = hist["cpu"], hist["cuda"]
    v = Allclose(LM_LOSS_RTOL, LM_LOSS_ATOL).compare(cpu.column("loss"),
                                                     card.column("loss"))
    log(f"  smoke LM Fig. 3 (stored boundary, 3 batches), "
        f"{len(card.column('loss'))} losses card vs CPU, fp32: "
        f"{v.detail or 'allclose'} (max|err| "
        f"{v.metrics.get('max_abs_err', float('nan')):.2e}, rtol "
        f"{LM_LOSS_RTOL:g}, atol {LM_LOSS_ATOL:g}); card launches "
        f"{launches['cuda']}, CPU {launches['cpu']}")
    require(v.ok, f"smoke LM Fig.-3 losses card vs CPU: {v.detail}")
    require(cpu.column("phase") == card.column("phase")
            == ["left"] * 3 + ["right"] * 3 + ["recovery"] * 3,
            "smoke LM Fig.-3 records differ")
    need = ("flash_attention", "flash_attention_bwd", "sil_mse")
    require(all(launches["cuda"].get(k, 0) > 0 for k in need)
            and not launches["cpu"],
            f"smoke LM Fig.-3 launches: card {launches['cuda']}, CPU "
            f"{launches['cpu']}")
    return {"losses": v.metrics, "n_losses": len(card.column("loss")),
            "launches": launches["cuda"]}


def reference_staged(torch, dev, cfg=None, tag="smoke qwen2"):
    """A smoke model (by default qwen2's) at fp32 served from its two stage
    trees (``Engine(plan=, stage_params=)``) on the card: greedy tokens
    equal to the joined engine's on the contiguous and the paged pool, with
    the same kernel launches."""
    from repro_torch.configs import get
    from repro_torch.core import partition
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, GenerationConfig, Request
    cfg = (cfg or get("qwen2-1.5b", smoke=True)).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    plan = partition.make_plan(cfg, 2)
    stages = [partition.slice_stage_params(cfg, plan, params, k)
              for k in range(2)]
    reqs = smoke_requests(cfg, GenerationConfig, Request)
    out = {}
    for paged in (False, True):
        toks = {}
        for mode, kw in (("joined", {"params": params}),
                         ("staged", {"plan": plan, "stage_params": stages})):
            LAUNCHES.reset()
            eng = Engine(cfg, device=dev, max_slots=2, decode_block=4,
                         paged=paged, **kw)
            toks[mode] = ([c.tokens for c in eng.generate(reqs)],
                          LAUNCHES.snapshot())
        pool = "paged" if paged else "contiguous"
        (tj, lj), (ts, ls) = toks["joined"], toks["staged"]
        log(f"  {tag} fp32 staged engine ({pool}): greedy tokens == "
            f"joined {ts == tj} ({sum(len(t) for t in tj)} tokens); "
            f"launches staged {ls}, joined {lj}")
        require(ts == tj, f"{tag} staged engine tokens differ from the "
                f"joined engine's ({pool})")
        require(ls == lj and all(v > 0 for v in ls.values()) and ls,
                f"{tag} staged launches {ls} != joined {lj} ({pool})")
        out[pool] = {"tokens_equal": True, "launches": ls}
    return out


# -- phase 5 -------------------------------------------------------------------

def serve_requests(cfg, GenerationConfig, Request):
    import numpy as np
    rng = np.random.RandomState(0)
    greedy = [(64, 32), (96, 40), (128, 48), (200, 64), (256, 36),
              (333, 56), (420, 44), (512, 64)]
    reqs = [Request(tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
                    gen=GenerationConfig(max_new_tokens=nn), id=f"g{i}")
            for i, (ln, nn) in enumerate(greedy)]
    for i, (ln, nn) in enumerate(((150, 48), (300, 40))):
        reqs.append(Request(
            tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
            gen=GenerationConfig(max_new_tokens=nn, temperature=0.8,
                                 top_k=50, top_p=0.95, seed=100 + i),
            id=f"s{i}"))
    return reqs


def run_engine(torch, engine, reqs, LAUNCHES):
    """One measured generate(): tokens, TTFTs, wall time, launch counts."""
    engine.tracer.spans.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    first = {}
    done = {}
    for ev in engine.stream(reqs):
        if ev.kind == "delta" and ev.req_idx not in first:
            first[ev.req_idx] = time.perf_counter() - t0
        elif ev.kind == "done":
            done[ev.req_idx] = ev.completion
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    steps = [(s.dur, s.args.get("steps", 0)) for s in engine.tracer.spans
             if s.name.startswith("decode[")]
    admits = sum(1 for s in engine.tracer.spans if s.name == "admit")
    n_steps = sum(n for _, n in steps)
    comps = [done[i] for i in range(len(reqs))]
    ttft = sorted(first.values())
    return {
        "tokens": [list(c.tokens) for c in comps],
        "n_generated": sum(len(c.tokens) for c in comps),
        "wall_s": wall,
        "tokens_per_s": sum(len(c.tokens) for c in comps) / wall,
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "ttft_max_ms": 1e3 * ttft[-1],
        "ttft_ms": [1e3 * first[i] for i in range(len(reqs))],
        "decode_steps": n_steps,
        "admit_groups": admits,
        "ms_per_decode_step": 1e3 * sum(d for d, _ in steps) / max(n_steps,
                                                                    1),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
    }


# kernel names of PyTorch's fused attention (SDPA's cuDNN, flash and
# memory-efficient backends), which the port never calls
SDPA_FAMILY = "SDPA (library)"
SDPA_NAMES = ("sdpa", "fmha", "flash_fwd", "flash_bwd", "pytorch_flash",
              "efficient_attention", "mem_eff")


def kernel_family(name: str) -> str:
    if name.startswith("Memcpy"):         # "Memcpy DtoH (Device -> ...)"
        return "copy " + name.split()[1]
    if any(w in name.lower() for w in SDPA_NAMES):
        return SDPA_FAMILY
    if "attn_bwd" in name:
        return "flash_attention_bwd (ours)"
    if "prefill" in name:
        return "flash_attention (ours)"
    if "decode_kernel" in name:
        return "decode attention (ours)"
    if "scan_bwd" in name:
        return "selective_scan_bwd (ours)"
    if "scan_kernel" in name:
        return "selective_scan (ours)"
    if any(w in name for w in ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                               "splitK")):
        return "matmul (cuBLAS)"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort (sampling)"
    if "index" in name.lower() or "scatter" in name.lower():
        return "index/scatter"
    if "reduce" in name.lower():
        return "reductions"
    return "elementwise/other"


EXPERT_FAMILY = "expert bmm (cuBLAS)"


def raw_events(prof):
    """A finished profile's events as tuples (name, on the device, start ns,
    end ns, correlation id, thread), read from Kineto's results as they
    are, in place of ``prof.events()``, which builds a Python object for
    every event and a tree of their children, the slowest part of reading
    a profile of 10^5-10^6 launches.  Of the host events only those the
    readers below look at are
    kept: the CUDA API calls, ``aten::bmm`` and the profiler ranges of the
    engine and trainer spans.  As the profiler's own parsing does, an API
    call is put on the thread of the op it serves, names are demangled,
    and async host events and hidden ones are left out.  A kernel and the
    API call that launched it share their correlation id."""
    import torch
    from torch.autograd import DeviceType
    cpu = DeviceType.CPU
    op_thread, names, dev, host = {}, {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cpu:
            if not e.is_hidden_event():
                dev.append((name, True, e.start_ns(), e.end_ns(),
                            e.correlation_id(), None))
            continue
        link = e.linked_correlation_id()
        if link == 0:
            op_thread[e.correlation_id()] = e.start_thread_id()
        if not (name.startswith("cu") or name == "aten::bmm"
                or is_range(name)):
            continue
        thread = e.start_thread_id()
        if e.is_async() or thread != e.end_thread_id() \
                or e.is_hidden_event():
            continue
        host.append((name, e.start_ns(), e.end_ns(), e.correlation_id(),
                     thread, link))
    for ev in dev:
        if ev[0] not in names:
            names[ev[0]] = torch._C._demangle(ev[0])
    return [(names[n], True, t0, t1, c, None) for n, _, t0, t1, c, _ in dev] \
        + [(n, False, t0, t1, c, op_thread.get(link, thread))
           for n, t0, t1, c, thread, link in host]


def _nested(events, outer, inner):
    """[(outer event, [inner events inside it])]: the host events whose name
    ``outer`` accepts, each with the host events of its thread whose name
    ``inner`` accepts and whose time lies within it (the profiler's
    parent-child nesting)."""
    import bisect
    by_thread = {}
    for ev in events:
        if not ev[1] and inner(ev[0]):
            by_thread.setdefault(ev[5], []).append(ev)
    for evs in by_thread.values():
        evs.sort(key=lambda ev: ev[2])
    starts = {t: [ev[2] for ev in evs] for t, evs in by_thread.items()}
    out = []
    for ev in events:
        if ev[1] or not outer(ev[0]):
            continue
        evs = by_thread.get(ev[5], [])
        i = bisect.bisect_left(starts.get(ev[5], []), ev[2])
        inside = []
        while i < len(evs) and evs[i][2] <= ev[3]:
            if evs[i][3] <= ev[3] and evs[i] is not ev:
                inside.append(evs[i])
            i += 1
        out.append((ev, inside))
    return out


def bmm_launch_ids(events):
    """Correlation ids of the CUDA API calls made under an ``aten::bmm`` op,
    forward or backward: the experts' products (an MoE model's only
    batched matmuls)."""
    return {e[4] for _, inside in _nested(
        events, lambda n: n == "aten::bmm", lambda n: n.startswith("cu"))
        for e in inside}


def event_families(events, experts=False):
    """({family: (device ms, activities)}, {kernel name: (device ms,
    activities)}) of every device activity in the profile (spin kernels and
    ranges left out); with ``experts``, the experts' batched matmuls a
    family of their own beside cuBLAS's other products."""
    bmm = bmm_launch_ids(events) if experts else set()
    fam, by_name = {}, {}
    for name, on_dev, t0, t1, corr, _ in events:
        if not on_dev or is_range(name) or LEAD_KERNEL in name:
            continue
        ms = (t1 - t0) / 1e6
        f = EXPERT_FAMILY if corr in bmm else kernel_family(name)
        for d, key in ((fam, f), (by_name, name)):
            t, n = d.get(key, (0.0, 0))
            d[key] = (t + ms, n + 1)
    return fam, by_name


SYNC_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaEventSynchronize")


TRAIN_PHASES = {"BaselinePhase": "baseline", "SilStagePhase": "left",
                "BoundaryMaterializePhase": "materialize",
                "FrozenPrefixPhase": "right", "RecoveryPhase": "recovery",
                "ParallelSilPhase": "parallel"}


def is_range(name: str) -> bool:
    """An engine or trainer span made a profiler range; with CPU activity
    on, the profiler also puts it on the device timeline as an annotation
    spanning its kernels, which is no device work of its own."""
    return name.startswith(("decode[", "tick ")) or name == "admit" \
        or name in TRAIN_PHASES


def range_split(events, match, families=None):
    """Host time, host time spent waiting in CUDA sync calls, device time and
    device activities (kernels and copies) (ms, ms, ms, n) under the
    profiler ranges whose name ``match`` accepts, over ``raw_events``;
    ``families``, a dict, also gets the device ms and count of each
    ``kernel_family`` there.  Each activity on the
    device carries the correlation id of the CUDA API call that issued
    it (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``,
    ...); it counts once, for the range that call lies in.  This holds for
    PyTorch's kernels, the port's ctypes-launched ones and the backward's,
    which autograd launches from its own thread, outside the range's ops;
    the kernels the profiler hangs on those ops would leave the backward
    out, and adding the ctypes kernels to them would count one launched
    under an op (the SIL-MSE autograd Function's forward) twice."""
    import bisect
    host = wait = dev = 0.0
    launches = 0
    spans = []
    for ev, syncs in _nested(events, match, lambda n: n in SYNC_CALLS):
        host += (ev[3] - ev[2]) / 1e6
        spans.append((ev[2], ev[3]))
        wait += sum(e[3] - e[2] for e in syncs) / 1e6
    spans.sort()
    starts = [a for a, _ in spans]
    called_at = {ev[4]: ev[2] for ev in events
                 if not ev[1] and ev[0].startswith("cu")}
    for name, on_dev, t0, t1, corr, _ in events:
        if not on_dev or is_range(name):
            continue
        t = called_at.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            ms = (t1 - t0) / 1e6
            launches += 1
            dev += ms
            if families is not None:
                f_ms, f_n = families.get(kernel_family(name), (0.0, 0))
                families[kernel_family(name)] = (f_ms + ms, f_n + 1)
    return host, wait, dev, launches


def decode_spans(engine):
    """(host ms, steps) over the engine's ``decode[n]`` spans."""
    spans = [s for s in engine.tracer.spans if s.name.startswith("decode[")]
    return (1e3 * sum(s.dur for s in spans),
            sum(s.args.get("steps", 0) for s in spans))


@contextlib.contextmanager
def ranged(tracer):
    """While in effect, every span of ``tracer`` is also a profiler range,
    so the profile attributes kernels to the span that launched them."""
    from torch.profiler import record_function
    span = tracer.span

    @contextlib.contextmanager
    def ranged_span(name, **kw):
        with record_function(name), span(name, **kw):
            yield

    tracer.span = ranged_span
    try:
        yield tracer
    finally:
        del tracer.span                    # back to the class's method


def profile_run(torch, engine, reqs):
    """One generate() of ``reqs`` unprofiled, then one under torch.profiler
    with CPU and CUDA activity, where each engine span is also a profiler
    range.  Gives device time by kernel family, the busy share (device time
    / the unprofiled wall time), and per decode step: host time unprofiled
    and profiled, the profiled host time waiting in sync calls, device
    time and kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    engine.tracer.spans.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plain_host, steps = decode_spans(engine)
    engine.tracer.spans.clear()
    with ranged(engine.tracer), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(reqs)
        torch.cuda.synchronize()
    prof_host, prof_steps = decode_spans(engine)
    events = raw_events(prof)
    fam, _ = event_families(events)
    total = sum(ms for ms, _ in fam.values())
    host, wait, dev, launches = range_split(
        events, lambda name: name.startswith("decode["))
    per = max(prof_steps, 1)
    return {"requests": len(reqs), "wall_ms": 1e3 * wall,
            "device_ms": total, "busy_share": total / (1e3 * wall),
            "families": {f: {"ms": ms, "launches": n}
                         for f, (ms, n) in sorted(fam.items(),
                                                  key=lambda x: -x[1][0])},
            "decode_steps": prof_steps,
            "decode_per_step": {
                "host_ms_unprofiled": plain_host / max(steps, 1),
                "host_ms_span_profiled": prof_host / per,
                "host_ms_range_profiled": host / per,
                "sync_wait_ms_profiled": wait / per,
                "device_ms": dev / per,
                "launches": launches / per,
                "host_us_per_launch_profiled":
                    1e3 * (host - wait) / max(launches, 1)}}


# the hybrid served on the card: Jamba-1.5-Large at full width, one whole
# attn_period (7 Mamba layers + 1 attention layer, G = 1), dense FFNs
JAMBA_LAYERS = 8


def jamba_serve_config(get):
    return get("jamba-1.5-large-398b").replace(moe=None,
                                               n_layers=JAMBA_LAYERS)


def serve_model(torch, dev, cfg, params, required, profile_tokens=16,
                reqs=None, max_slots=8):
    """Serves ``reqs`` (by default the 10 of ``serve_requests``) from
    ``params`` through
    ``Engine(precision="bf16", max_slots=max_slots)``, once on the contiguous pool
    and once paged (each after a warm-up run; launch counts zeroed just
    before each measured run and read just after), then profiles a short
    run on the contiguous pool (4 requests of ``profile_tokens``).  Greedy tokens must agree between the
    pools, and each pool's run must launch the kernels ``required`` names
    ({"contiguous": [...], "paged": [...]}).  Returns the runs."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.serve import Engine, GenerationConfig, Request
    reqs = reqs or serve_requests(cfg, GenerationConfig, Request)
    runs = {}
    for paged in (False, True):
        label = "paged" if paged else "contiguous"
        engine = Engine(cfg, params, device=dev, precision="bf16",
                        max_slots=max_slots, paged=paged)
        engine.generate(reqs)        # warm-up: cuBLAS picks per new shape
        runs[label] = r = run_engine(torch, engine, reqs, LAUNCHES)
        r["pool_bytes"] = engine._pool.nbytes
        log(f"  {label:10s}: {r['n_generated']} tokens in {r['wall_s']:.2f}s"
            f" = {r['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.1f} ms (max {r['ttft_max_ms']:.1f}), "
            f"{r['ms_per_decode_step']:.2f} ms/decode step over "
            f"{r['decode_steps']} steps, peak {r['peak_mem_gib']:.2f} GiB, "
            f"pool {r['pool_bytes'] / 2**20:.0f} MiB, launches "
            f"{r['launches']}")
        if not paged:     # the pools' device work differs only in attention
            short = [dataclasses.replace(q, gen=q.gen.replace(
                max_new_tokens=profile_tokens)) for q in reqs[:4]]
            r["profile"] = prof = profile_run(torch, engine, short)
            log(f"    profiled 4 requests x {profile_tokens} tokens: device "
                f"busy {prof['device_ms']:.1f} ms of {prof['wall_ms']:.0f} ms "
                f"({100 * prof['busy_share']:.1f}%)")
            for f, v in prof["families"].items():
                log(f"      {f:26s} {v['ms']:9.2f} ms  {v['launches']:7d} "
                    "launches")
            d = prof["decode_per_step"]
            log(f"    per decode step ({prof['decode_steps']} steps): host "
                f"{d['host_ms_unprofiled']:.2f} ms unprofiled, "
                f"{d['host_ms_range_profiled']:.2f} ms profiled of which "
                f"{d['sync_wait_ms_profiled']:.2f} ms waiting in sync calls;"
                f" device {d['device_ms']:.2f} ms; {d['launches']:.0f} "
                f"launches, {d['host_us_per_launch_profiled']:.1f} us of "
                "host time each (profiled)")
            require(d["device_ms"] > 0 and d["launches"] > 0,
                    "the profile attributed no device work to decode steps")
        del engine
        torch.cuda.empty_cache()
        for req, toks in zip(reqs, r["tokens"]):
            require(len(toks) == req.gen.max_new_tokens,
                    f"{req.id}: {len(toks)} tokens, expected "
                    f"{req.gen.max_new_tokens}")
            require(all(0 <= t < cfg.vocab_size for t in toks),
                    f"{req.id}: token outside the vocabulary")
        missing = [k for k in required[label]
                   if r["launches"].get(k, 0) <= 0]
        require(not missing, f"{cfg.name} {label} run launched no "
                f"{missing}: {r['launches']}")
    c, p = runs["contiguous"], runs["paged"]
    greedy = [i for i, r in enumerate(reqs) if r.gen.temperature <= 0]
    same = [c["tokens"][i] == p["tokens"][i] for i in range(len(reqs))]
    require(all(same[i] for i in greedy),
            f"{cfg.name}: greedy tokens differ between the contiguous and "
            "paged pools")
    log(f"  greedy tokens identical across pools ({len(greedy)} requests); "
        f"sampled identical: {all(same)}")
    return runs, all(same)


def log_weights_bound(cfg, weights):
    """The decode step's floor: ``weights`` bytes read once at 3.35 TB/s."""
    ms = 1e3 * weights / HBM_BYTES_PER_S
    log(f"  weights-bound decode step: {weights / 1e9:.2f} GB of bf16 "
        f"weights read -> {ms:.3f} ms at 3.35 TB/s")
    return ms


def phase_serve(torch, dev, report):
    from repro_torch.configs import get
    from repro_torch.models import model as M
    from repro_torch.precision import tree_bytes
    attn = ["flash_attention"]
    cfg = get("qwen2-1.5b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_padded}; random "
        f"fp32 weights in {time.perf_counter() - t0:.1f}s")
    runs, sampled_equal = serve_model(
        torch, dev, cfg, params,
        {"contiguous": attn + ["decode_attention"],
         "paged": attn + ["paged_decode_attention"]})
    weights = tree_bytes(params) // 2      # fp32 storage -> bf16 copy
    report["serve"] = {"layers": cfg.n_layers, "runs": runs,
                       "sampled_equal": sampled_equal,
                       "bf16_weight_bytes": weights,
                       "weights_bound_ms_per_step":
                       log_weights_bound(cfg, weights)}
    c, p = runs["contiguous"], runs["paged"]
    report.setdefault("launches", {}).update(
        {k: c["launches"].get(k, 0) + p["launches"].get(k, 0)
         for k, (src, _) in KERNELS.items() if src == FA_SOURCE})
    del params
    torch.cuda.empty_cache()

    # the hybrid: Jamba-1.5-Large at full width, 8 layers, no experts
    cfg = jamba_serve_config(get)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    weights = tree_bytes(params)           # bf16 storage, used as it is
    log(f"  {cfg.name} without experts: {cfg.n_layers} layers "
        f"({[k for k, _, _ in M.slot_spec(cfg)]}), d {cfg.d_model}, "
        f"d_inner {2 * cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}; random bf16 weights "
        f"({weights / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f}s")
    runs, sampled_equal = serve_model(
        torch, dev, cfg, params,
        {"contiguous": attn + ["selective_scan", "decode_attention"],
         "paged": attn + ["selective_scan", "paged_decode_attention"]})
    c, p = runs["contiguous"], runs["paged"]
    # untied: a decode step reads 8 rows of the input embedding table, not
    # the table
    read = weights - tree_bytes(params["tok_embed"])
    report["serve_jamba"] = {"layers": cfg.n_layers, "runs": runs,
                             "sampled_equal": sampled_equal,
                             "bf16_weight_bytes": weights,
                             "all_weights_ms_per_step":
                             1e3 * weights / HBM_BYTES_PER_S,
                             "weights_bound_ms_per_step":
                             log_weights_bound(cfg, read)}
    report["launches"]["selective_scan"] = (
        c["launches"].get("selective_scan", 0)
        + p["launches"].get("selective_scan", 0))
    del params
    torch.cuda.empty_cache()


# -- phase 5b ------------------------------------------------------------------

# the open-loop load generator's reports, written where git does not look
LOADGEN_DIR = ROOT / "build" / "loadgen"
# the CLI as a user runs it (smoke qwen2 in fp32 on the card), and the
# kernels each run must launch: the paged preset's --compare serves the
# same trace through both pools
LOADGEN_CLI = {"full": (["--preset", "full"],
                        ("flash_attention", "decode_attention")),
               "paged_compare": (["--preset", "paged", "--compare"],
                                 ("flash_attention", "decode_attention",
                                  "paged_decode_attention"))}


def check_loadgen(path, rep, launches, need, tag):
    """The gates of one loadgen report: the schema (``validate_report`` and
    ``launch.metrics --check``), the deterministic sheds and completions,
    the kernels ``need`` names launched; prints the SLO row."""
    from repro_torch.launch import metrics
    w, slo = rep["workload"], rep["slo"]
    shed = slo["shed"]
    bad = metrics.validate_report(rep)
    rc = metrics.main(["--check", str(path)])
    log(f"    {tag}: {w['n_requests']} requests at {w['rate_rps']} req/s, "
        f"{w['slots']} slots, {'paged' if w['paged'] else 'contiguous'}"
        f"{' (blocks of %d)' % w['block_size'] if w['paged'] else ''}: TTFT "
        f"p50 / p99 {slo['ttft_ms']['p50']:.1f} / {slo['ttft_ms']['p99']:.1f}"
        f" ms at admission, {slo['ttft_stream_ms']['p50']:.1f} / "
        f"{slo['ttft_stream_ms']['p99']:.1f} ms on the stream; "
        f"{slo['tokens_per_s']:.1f} tokens/s ({slo['n_tokens']} in "
        f"{slo['wall_s']:.2f} s); queue depth p99 "
        f"{slo['queue_depth']['p99']}; shed {shed['rate']:.3f} (cache "
        f"{shed['rejected_cache']}, queue {shed['rejected_queue']}, deadline"
        f" {shed['rejected_deadline']}); peak slots "
        f"{slo['peak_slots_busy']}; completed {slo['completed']}; launches "
        f"{launches}")
    require(not bad and rc == 0, f"{tag}: the report fails its schema: "
            f"{bad}, metrics --check exit {rc}")
    require(shed["rejected_cache"] == w["oversized"],
            f"{tag}: {shed['rejected_cache']} cache sheds for "
            f"{w['oversized']} oversized requests")
    require(slo["completed"] == w["n_requests"] - w["oversized"],
            f"{tag}: {slo['completed']} of {w['n_requests']} completed")
    require(all(launches.get(k, 0) > 0 for k in need),
            f"{tag} launched none of some of {need}: {launches}")


def phase_loadgen(torch, dev, report):
    """``python -m repro_torch.launch.loadgen --preset full`` and ``--preset
    paged --compare`` through ``main`` (the smoke qwen2 in fp32, open
    loop), then the ``full`` preset's trace (48 Poisson requests at 12
    req/s, 2 oversized) against qwen2-1.5b at full width in bf16 on both
    pools, through the helper ``run_loadgen`` serves with.  TTFT and its
    p99s are printed, not gated: over 16-48 requests on a shared host they
    are noise; ``concurrency_ok`` is set by the cache budget."""
    import shutil
    from repro_torch.configs import get
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import loadgen
    from repro_torch.models import model as M
    shutil.rmtree(LOADGEN_DIR, ignore_errors=True)
    LOADGEN_DIR.mkdir(parents=True)
    out = {"card": smi_line()}
    keep = ("workload", "slo", "events", "comparison", "baseline")
    for tag, (argv, need) in LOADGEN_CLI.items():
        path = LOADGEN_DIR / f"{tag}.json"
        LAUNCHES.reset()
        t0 = time.perf_counter()
        rc = loadgen.main(argv + ["--out", str(path)])
        secs = time.perf_counter() - t0
        launches = LAUNCHES.snapshot()
        rep = json.loads(path.read_text())
        log(f"  launch.loadgen {' '.join(argv)}: exit {rc} in {secs:.1f}s")
        check_loadgen(path, rep, launches, need, tag)
        cmp_ = rep.get("comparison")
        if cmp_:
            log(f"    compare: peak slots paged {cmp_['paged_peak_slots_busy']}"
                f" against contiguous {cmp_['contiguous_peak_slots_busy']} "
                f"({cmp_['baseline_slots']} rows of the same budget): "
                f"concurrency_ok {cmp_['concurrency_ok']}; p99 TTFT "
                f"{cmp_['paged_p99_ttft_ms']:.1f} against "
                f"{cmp_['contiguous_p99_ttft_ms']:.1f} ms: ttft_ok "
                f"{cmp_['ttft_ok']} (not gated)")
            require(cmp_["concurrency_ok"], "paging held no more sessions "
                    f"than the contiguous rows: {cmp_}")
            require(rc == (0 if cmp_["ok"] else 1),
                    f"--compare exit {rc} against its verdict {cmp_['ok']}")
        else:
            require(rc == 0, f"launch.loadgen {argv} exit {rc}")
        out[tag] = dict({k: rep[k] for k in keep if k in rep}, seconds=secs,
                        launches=launches, exit=rc)

    # the full preset's trace at full width, both pools
    cfg = get("qwen2-1.5b")
    p = loadgen.PRESETS["full"]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    log(f"  the {p['n_requests']}-request full trace against {cfg.name} at "
        f"full width ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.dtype} "
        f"compute), open loop ({out['card']})")
    for paged in (False, True):
        pool = "paged" if paged else "contiguous"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        rep = loadgen._serve_trace(
            cfg, params, p, preset="full", seed=0, n=None, rate=None,
            trace_path=None, paged=paged, slots=p["slots"], device=dev)
        secs = time.perf_counter() - t0
        launches = LAUNCHES.snapshot()
        path = LOADGEN_DIR / f"{cfg.name}-{pool}.json"
        path.write_text(json.dumps(rep, indent=1))
        need = ("flash_attention", "paged_decode_attention" if paged
                else "decode_attention")
        check_loadgen(path, rep, launches, need, f"{cfg.name} {pool}")
        out[f"full_width_{pool}"] = dict(
            {k: rep[k] for k in keep if k in rep}, seconds=secs,
            launches=launches,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del params
    torch.cuda.empty_cache()
    report["loadgen"] = out


# -- phase 6 -------------------------------------------------------------------

def phase_rows(tracer, steps, batch):
    """Per trainer phase span: host wall ms, optimizer steps (``steps``:
    phase name -> steps, each span taking its phase's in turn), ms/step and
    samples/s."""
    left = dict(steps)
    rows = []
    for sp in tracer.spans:
        name = TRAIN_PHASES.get(sp.name, sp.name)
        n = left.pop(name, 0)
        ms = 1e3 * sp.dur
        rows.append({"phase": name, "wall_ms": ms, "steps": n,
                     "ms_per_step": ms / n if n else None,
                     "samples_per_s": n * batch / sp.dur if n else None})
    return rows


def log_parity(name, res, seconds):
    log(f"  paper parity {name} on the card ({seconds:.1f}s): baseline "
        f"{res['baseline_acc']:.4f}, PNN {res['pnn_acc']:.4f}, gap "
        f"{res['gap']:.4f} (budget {res['budget']}, verdict "
        f"{'PASS' if res['ok'] else 'FAIL'}), MACs ratio "
        f"{res['macs_ratio']:.4f}, {res['n_steps']} steps")


def phase_train(torch, dev, report):
    """The paper MLP at full width through ``run_paper_parity("full")``: the
    paper's own schedule (N_B 40, then N_L 5, N_R 160 and 10 recovery
    epochs) on the EMNIST-size stand-in; then a short profiled run and the
    ``tiny`` preset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.images import emnist_like
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models.mlp import MLPConfig
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import recipes
    from repro_torch.verify import paper
    cfg = MLPConfig()
    full = paper.PRESETS["full"]
    batch = recipes.paper_spec().batch_size
    tracer = Tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    res = paper.run_paper_parity("full", device=dev, tracer=tracer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    rows = phase_rows(tracer, res["steps_by_phase"], batch)
    log(f"  {cfg.name} {cfg.sizes}, cut after layer {cfg.cut}, batch {batch},"
        f" {full.n_train} train / {full.n_test} test samples resident: "
        f"{res['n_steps']} steps in {wall:.2f}s (data made on the host "
        "included), peak "
        f"{peak / 2**20:.0f} MiB, launches {launches}")
    for r in rows:
        extra = "" if r["ms_per_step"] is None else (
            f", {r['ms_per_step']:.3f} ms/step, "
            f"{r['samples_per_s']:.0f} samples/s")
        log(f"    {r['phase']:12s} {r['wall_ms']:10.1f} ms, {r['steps']:5d} "
            f"steps{extra}")
    log_parity("full", res, wall)
    require(res["baseline_acc"] >= full.floor,
            f"full baseline {res['baseline_acc']} below the floor "
            f"{full.floor}")
    require(res["losses_finite"], "a full-preset loss is not finite")
    require(res["ok"], f"full preset: PNN gap {res['gap']} over the budget "
            f"{res['budget']}")
    require(launches.get("sil_mse", 0) > 0,
            f"the train run launched no sil_mse kernel: {launches}")
    report.setdefault("launches", {})["sil_mse"] = launches["sil_mse"]

    # one epoch of each phase under the profiler: launches, device time
    data = emnist_like(n_train=full.n_train, n_test=full.n_test, seed=0,
                       noise=full.noise)
    short = recipes.paper_spec(n_baseline=1, n_left=1, n_right=1,
                               n_recovery=1)
    rt = Tracer()
    LAUNCHES.reset()
    with ranged(rt), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        profile_lead(torch)
        _, pb = recipes.run_mlp_baseline(
            cfg, data, short, torch.Generator().manual_seed(0),
            eval_every=1000, device=dev, tracer=rt)
        _, pp = recipes.run_mlp_fig3(
            cfg, data, short, torch.Generator().manual_seed(1),
            eval_every=1000, device=dev, tracer=rt)
        profile_tail(torch)
    sil_calls = LAUNCHES.get("sil_mse")
    events = raw_events(prof)
    steps = {}
    for r in pb.records + pp.records:
        if r.loss is not None:
            steps[r.phase] = steps.get(r.phase, 0) + 1
    prof_rows = phase_rows(rt, steps, batch)
    for r, sp in zip(prof_rows, rt.spans):
        host, wait, devms, n = range_split(
            events, lambda name, c=sp.name: name == c)
        r.update(host_ms=host, sync_wait_ms=wait, device_ms=devms,
                 launches=n, busy_share=devms / host if host else None)
        per = ""
        if r["steps"]:
            r.update(launches_per_step=n / r["steps"],
                     device_ms_per_step=devms / r["steps"],
                     host_ms_per_step_profiled=host / r["steps"])
            per = (f" = {n / r['steps']:.1f}/step, device "
                   f"{devms / r['steps']:.4f} ms/step")
        log(f"    profiled {r['phase']:12s} {r['steps']:4d} steps: host "
            f"{host:8.1f} ms (sync wait {wait:.1f}), device {devms:8.2f} ms "
            f"(busy {100 * devms / max(host, 1e-9):.1f}%), {n} kernel "
            f"launches{per}")
    kern = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "sil_mse" in e.key:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kern[e.key] = {"device_ms": us / 1e3, "count": e.count}
    n_kern = sum(k["count"] for k in kern.values())
    log(f"    profiled sil_mse kernels: {kern}; {sil_calls} wrapper calls, "
        f"{n_kern / max(sil_calls, 1):.2f} kernels a call")
    require(any(r.get("launches") for r in prof_rows),
            "the profile attributed no kernels to the train phases")
    require(sil_calls > 0 and len(kern) == 1 and n_kern == sil_calls,
            f"the train profile holds {n_kern} sil_mse kernels ({kern}) for "
            f"{sil_calls} wrapper calls: one a call expected")
    del data

    # the paper gate's tiny preset end to end, on the card
    t0 = time.perf_counter()
    tiny = paper.run_paper_parity("tiny", device=dev)
    log_parity("tiny", tiny, time.perf_counter() - t0)
    p = paper.PRESETS["tiny"]
    require(tiny["baseline_acc"] >= p.floor,
            f"tiny baseline {tiny['baseline_acc']} below the floor {p.floor}")
    require(tiny["losses_finite"], "a tiny-preset loss is not finite")
    report["train"] = {"batch": batch, "wall_s": wall,
                       "peak_mem_bytes": peak, "launches": launches,
                       "phases": rows, "profile": prof_rows,
                       "profile_sil_mse": kern,
                       "paper_full": res, "paper_tiny": tiny}


# -- phase 7 -------------------------------------------------------------------

# the LM train phase: qwen2-1.5b at full width as ``python -m
# repro_torch.launch.train --arch qwen2-1.5b --mode pnn --stages 2 --batch 8
# --seq 1024 --steps 16`` trains it (8 steps a stage, 4 of recovery); the
# profiled run takes 2 a stage and 1 of recovery
LM_BATCH, LM_SEQ = 8, 1024
LM_TRAIN_STEPS, LM_PROFILE_STEPS = 16, 4
LM_PHASES = ("left", "right", "recovery")


def moe_slots(cfg, tokens: int) -> int:
    """E x C: the expert rows one MoE layer computes over ``tokens``."""
    from repro_torch.models.layers import moe_capacity
    return cfg.moe.num_experts * moe_capacity(tokens, cfg.moe)


def layer_work(cfg, layer, b, s):
    """(matmul FLOPs of one forward, the sequence mixer's own forward, its
    backward) of one layer over a (b, s) batch.  An attention layer's mixer
    is causal attention (4 D FLOPs a causal pair forward, 10 D backward); a
    Mamba layer's is the selective scan, its fp32 operations weighted by
    the bf16 / fp32 peak ratio so that the floor's division by the bf16
    peak times them at the fp32 rate; its products are in_proj, x_proj,
    dt_proj and out_proj.  The FFN is dense (SwiGLU's three products, the
    GELU MLP's two), or on an MoE layer the fp32 router over every token
    and the experts over the E x C capacity slots the program computes,
    filled or not (``moe_slots``; one dispatch group).  An encoder-decoder's
    decoder layer adds its cross block: the query and output projections
    over the b * s tokens, the key and value projections over the b *
    enc_seq frames, and non-causal attention over every (token, frame)
    pair.  An xLSTM layer (``xlstm_work``) has no FFN."""
    d, tokens = cfg.d_model, b * s
    ffn = 3 if cfg.mlp_type == "swiglu" else 2
    cross = 0
    kind = cfg.block_kind(layer)
    if kind in ("mlstm", "slstm"):
        return xlstm_work(cfg, kind, b, s)
    if kind == "attn":
        hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        mix = 2 * d * h * hd + 2 * d * kv * hd
        pairs = b * h * s * (s + 1) // 2
        if cfg.enc_dec:
            cross = 2 * (2 * d * h * hd * tokens
                         + 2 * d * kv * hd * b * cfg.enc_seq)
            pairs += b * h * s * cfg.enc_seq
        fwd, bwd = 4 * hd * pairs, 10 * hd * pairs
    else:
        from repro_torch.models.layers import mamba_dims
        di, r, n, _ = mamba_dims(cfg)
        mix = d * 2 * di + di * (r + 2 * n) + r * di + di * d
        elems = tokens * di * n
        weight = PEAK_FLOPS["bfloat16"] / PEAK_FLOPS["float32"]
        fwd = SCAN_FWD_OPS * elems * weight
        bwd = SCAN_BWD_OPS * elems * weight
    if cfg.layer_is_moe(layer):
        require((cfg.moe_dispatch_groups or 1) == 1,
                "lm_step_flops counts MoE layers of one dispatch group")
        mm = 2 * (mix + d * cfg.moe.num_experts) * tokens \
            + 2 * ffn * d * cfg.d_ff * moe_slots(cfg, tokens)
    else:
        mm = 2 * (mix + ffn * d * cfg.d_ff) * tokens
    return mm + cross, fwd, bwd


def xlstm_work(cfg, kind, b, s):
    """``layer_work``'s triple for an xLSTM layer.  mLSTM: the products up,
    wq, wk, wv and down in the compute dtype and the fp32 gates w_i and
    w_f; its mixer the chunk math over the full c x c blocks the code
    computes (for each chunk and head q.C and q.n from the carried state,
    q.k^T and (s w).v, and k^T.v into the next state: 4 dh^2 + 4 c dh
    FLOPs a token and head, the elementwise work left out), backward twice
    the forward's products.  sLSTM: w_in and out in the compute dtype and
    the fp32 block-diagonal r, one (dh, 4 dh) product a head and token;
    its step's elementwise gating is left out (bytes, not operations).
    fp32 work is weighted by the bf16 / fp32 peak ratio, as the scan's."""
    d, hn, tokens = cfg.d_model, cfg.n_heads, b * s
    weight = PEAK_FLOPS["bfloat16"] / PEAK_FLOPS["float32"]
    if kind == "mlstm":
        d_up = int(cfg.xlstm.proj_factor * d)
        dh = d_up // hn
        chunk = min(cfg.xlstm.chunk_size, s)
        padded = b * -(-s // chunk) * chunk       # the last chunk padded
        mm = 2 * (d * 2 * d_up + 3 * d_up * d_up + d_up * d
                  + weight * 2 * d * hn) * tokens
        fwd = weight * hn * (4 * dh * dh + 4 * chunk * dh) * padded
        return mm, fwd, 2 * fwd
    dh = d // hn
    return 2 * (d * 4 * d + d * d + weight * hn * dh * 4 * dh) * tokens, 0, 0


def encoder_work(cfg, b):
    """``layer_work``'s triple for one encoder layer of an encoder-decoder
    over b requests' enc_seq frames: its projections and FFN, and
    non-causal self-attention over every (frame, frame) pair."""
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ffn = 3 if cfg.mlp_type == "swiglu" else 2
    frames = b * cfg.enc_seq
    mm = 2 * (2 * d * h * hd + 2 * d * kv * hd + ffn * d * cfg.d_ff) * frames
    pairs = b * h * cfg.enc_seq ** 2
    return mm, 4 * hd * pairs, 10 * hd * pairs


def lm_step_flops(cfg, bounds, b, s) -> dict:
    """{phase: FLOPs one optimizer step needs} of the 2-stage LM schedule
    (2 a multiply-add): each layer's matmuls and its sequence mixer
    (``layer_work``), and the unembedding.  Under ``remat`` a trained layer
    runs its forward twice and its backward once (dX and dW), a layer that
    only passes a gradient on (stage 1 in recovery) its forward twice and
    dX once, a prefix layer one forward.  A frozen tied unembedding needs
    its forward and dX; an untied one (Jamba) is trained with stage 1, so
    dW too, except in recovery.  Norms, rope, the conv, the losses and
    AdamW are left out (bytes, not operations).  ``parallel`` is a Fig.-5
    tick: both stages trained, stage 1 on its synthetic input with no
    frozen-prefix forward; ``right_cache`` the Fig.-3 right step on the
    stored boundary (no prefix forward either), and ``materialize`` one
    batch of the prefix forward that stores it.  An encoder-decoder's
    encoder (``encoder_work``) belongs to stage 0 and has no ``remat``: its
    forward once and, where stage 0 trains, its backward once.  A vision
    config's layers and unembedding run over its image rows too (``s`` text
    rows and ``vision_tokens`` before them), and stage 0's ``img_proj``
    runs once (no remat) forward and, where stage 0 trains, once for its
    weight gradient (the image rows take none).  ``baseline`` is the
    paper's comparison, one step of the unpartitioned network: every layer
    trained under ``remat`` and the head trained (forward, dX and dW: a
    tied embedding takes the unembedding's gradient)."""
    from repro_torch.models.model import group_size
    g = group_size(cfg)
    vision = cfg.vision_tokens if cfg.frontend == "vision" else 0
    img = 2 * cfg.d_model * cfg.d_model * b * vision
    s = s + vision
    work = [[layer_work(cfg, layer, b, s) for layer in range(g0 * g, g1 * g)]
            for g0, g1 in bounds]
    enc = [encoder_work(cfg, b)] * cfg.enc_layers if cfg.enc_dec else []

    def total(k, mm_n, fwd_n, bwd_n):
        flops = sum(mm_n * mm + fwd_n * fwd + bwd_n * bwd
                    for mm, fwd, bwd in work[k])
        if k == 0:       # the encoder: trained (3, 1, 1) or a prefix (1, 1, 0)
            flops += sum((3 * mm + fwd + bwd) if bwd_n else (mm + fwd)
                         for mm, fwd, bwd in enc)
            flops += 2 * img if bwd_n else img
        return flops
    head = 2 * cfg.d_model * cfg.vocab_padded * b * s
    head_trained = (2 if cfg.tie_embeddings else 3) * head
    return {"left": total(0, 4, 2, 1),
            "right": total(0, 1, 1, 0) + total(1, 4, 2, 1) + head_trained,
            "recovery": total(0, 4, 2, 1) + total(1, 3, 2, 1) + 2 * head,
            "parallel": total(0, 4, 2, 1) + total(1, 4, 2, 1)
            + head_trained,
            "right_cache": total(1, 4, 2, 1) + head_trained,
            "materialize": total(0, 1, 1, 0),
            "baseline": total(0, 4, 2, 1) + total(1, 4, 2, 1) + 3 * head}


def profiled_phase_rows(events, rt, hist, flops, tokens):
    """``phase_rows`` of a profiled LM run (trainer spans ``rt``, history
    ``hist``), each with its host ms, sync wait, device ms, launches and
    busy share from the profile's ``events``, and per step against the
    phase's operations floor (``flops``); logs each and fails if the
    profile attributed no kernel to a phase."""
    phases = hist.column("phase")
    rows = phase_rows(rt, {p: phases.count(p) for p in LM_PHASES}, tokens)
    for r, sp in zip(rows, rt.spans):
        host, wait, devms, n = range_split(
            events, lambda name, c=sp.name: name == c)
        r.update(host_ms=host, sync_wait_ms=wait, device_ms=devms,
                 launches=n, busy_share=devms / host if host else None)
        if r["steps"]:
            floor = 1e3 * flops[r["phase"]] / PEAK_FLOPS["bfloat16"]
            r.update(launches_per_step=n / r["steps"],
                     device_ms_per_step=devms / r["steps"],
                     host_ms_per_step_profiled=host / r["steps"],
                     bound_share=floor * r["steps"] / devms if devms
                     else None)
            log(f"    profiled {r['phase']:9s} {r['steps']} steps: host "
                f"{host:9.1f} ms (sync wait {wait:.1f}), device "
                f"{devms:9.1f} ms (busy {100 * devms / max(host, 1e-9):.1f}%)"
                f", {n} launches = {n / r['steps']:.0f}/step, device "
                f"{devms / r['steps']:.1f} ms/step = "
                f"{100 * floor * r['steps'] / max(devms, 1e-9):.1f}% of the "
                "operations floor")
    require(any(r.get("launches") for r in rows),
            "the profile attributed no kernels to the LM train phases")
    return rows


def phase_lm_train(torch, dev, report):
    from types import SimpleNamespace
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.data.lm import lm_batches, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import lm_spec
    from repro_torch.models import model as M
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import recipes
    cfg = get("qwen2-1.5b")
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    tokens = LM_BATCH * LM_SEQ

    def run(steps, tracer):
        it = lm_batches(stream, LM_BATCH, LM_SEQ, seed=0)
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0))
        spec = lm_spec(SimpleNamespace(steps=steps, lr=3e-4, accum=1,
                                       precision=None), 2)
        return recipes.run_lm_sequential(
            cfg, 2, params, lambda _: next(it), spec,
            torch.Generator(device=dev).manual_seed(1), device=dev,
            tracer=tracer)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracer = Tracer()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    joined, hist = run(LM_TRAIN_STEPS, tracer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    losses = hist.column("loss")
    phases = hist.column("phase")
    steps = {p: phases.count(p) for p in LM_PHASES}
    rows = phase_rows(tracer, steps, tokens)
    from repro_torch.core import partition
    flops = lm_step_flops(cfg, partition.make_plan(cfg, 2).bounds, LM_BATCH,
                          LM_SEQ)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_padded}, {cfg.dtype} compute, {cfg.param_dtype} params;"
        f" 2 stages, batch {LM_BATCH} x {LM_SEQ}; {len(losses)} AdamW steps "
        f"in {wall:.1f}s (init and SIL table included), peak "
        f"{peak / 2**30:.2f} GiB, launches {launches}")
    for r in rows:
        r["bound_ms_per_step"] = 1e3 * flops[r["phase"]] / PEAK_FLOPS[
            "bfloat16"]
        extra = "" if r["ms_per_step"] is None else (
            f", {r['ms_per_step']:.1f} ms/step, "
            f"{r['samples_per_s']:.0f} tokens/s")
        log(f"    {r['phase']:12s} {r['wall_ms']:10.1f} ms, {r['steps']:5d} "
            f"steps{extra}; operations floor {flops[r['phase']] / 1e12:.1f}"
            f" TFLOP = {r['bound_ms_per_step']:.1f} ms/step at 989 TFLOP/s")
    for p in LM_PHASES:
        vals = [v for ph, v in zip(phases, losses) if ph == p]
        log(f"    {p:9s} losses {[round(v, 4) for v in vals]}")
    require(steps == {"left": 8, "right": 8, "recovery": 4},
            f"LM phases ran {steps} steps")
    require(all(math.isfinite(v) for v in losses), "an LM loss is not finite")
    need = ("flash_attention", "flash_attention_bwd", "sil_mse")
    require(all(launches.get(k, 0) > 0 for k in need),
            f"the LM train run launched none of some of {need}: {launches}")
    with torch.no_grad():                 # the joined network is usable
        logits, _ = M.forward(cfg, joined, {"tokens": torch.arange(
            128, device=dev)[None]}, remat=False)
    require(bool(torch.isfinite(logits.float()).all()),
            "the joined network's logits are not finite")
    report.setdefault("launches", {})["flash_attention_bwd"] = \
        launches.get("flash_attention_bwd", 0)
    del joined, hist, logits
    torch.cuda.empty_cache()

    # a shorter run under the profiler: launches and device time by phase
    rt = Tracer()
    with ranged(rt), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        profile_lead(torch)
        _, ph = run(LM_PROFILE_STEPS, rt)
        profile_tail(torch)
    events = raw_events(prof)
    prof_rows = profiled_phase_rows(events, rt, ph, flops, tokens)
    fam, _ = event_families(events)
    for f, (ms, n) in sorted(fam.items(), key=lambda x: -x[1][0]):
        log(f"      {f:28s} {ms:10.2f} ms  {n:7d} launches")
    report["lm_train"] = {
        "batch": LM_BATCH, "seq": LM_SEQ, "wall_s": wall,
        "peak_mem_bytes": peak, "launches": launches, "phases": rows,
        "losses": losses, "profile": prof_rows,
        "profile_families": {f: {"ms": ms, "launches": n}
                             for f, (ms, n) in fam.items()}}
    del ph, prof, events
    torch.cuda.empty_cache()
    report["lm_train"]["baseline"] = lm_baseline(
        torch, dev, cfg, stream, flops["baseline"], peak,
        {r["phase"]: r for r in prof_rows})


# the paper's baseline at the LM train phase's shapes: qwen2-1.5b trained
# unpartitioned as ``python -m repro_torch.launch.train --mode baseline
# --batch 8 --seq 1024`` trains it (launch.steps.build_train_step, AdamW on
# cosine_warmup(3e-4, 10, steps)), 4 steps and then 2 under the profiler
BASELINE_STEPS, BASELINE_PROFILE_STEPS = 4, 2
# kernel launches a step: each of the 28 layers' forward twice under remat
# (the recompute), its backward once; no SIL loss
BASELINE_LAUNCHES = {"flash_attention": 56, "flash_attention_bwd": 28}


def lm_baseline(torch, dev, cfg, stream, flops, pnn_peak, pnn):
    """The unpartitioned train step at full width and depth, the paper's
    comparison for the partitioned schedule the phase ran first (``pnn``:
    its profiled rows by phase, ``pnn_peak``: its peak bytes).  4 steps
    (ms a step, peak, exact launches, every ``loss``, ``ce`` and
    ``grad_norm`` finite), then 2 profiled ones (device and host ms a step,
    activities, busy share, the operations floor ``flops``, no SDPA
    kernel), then one step at ``accum=2`` from the same params and batch,
    whose loss and gradient norm must equal the first step's at the bf16
    ``REL_TOL``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.steps import (build_train_step,
                                          pick_optimizer_name)
    from repro_torch.models import model as M
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim import cosine_warmup, make_optimizer
    tokens = LM_BATCH * LM_SEQ
    n_all = BASELINE_STEPS + BASELINE_PROFILE_STEPS
    floor_ms = 1e3 * flops / PEAK_FLOPS["bfloat16"]
    opt_name = pick_optimizer_name(cfg)

    def fresh(accum):
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0))
        opt = make_optimizer(opt_name, cosine_warmup(3e-4, 10, n_all))
        it = lm_batches(stream, LM_BATCH, LM_SEQ, seed=0)
        return params, opt.init(params), \
            build_train_step(cfg, opt, accum=accum), \
            lambda: {k: torch.as_tensor(v).long().to(dev)
                     for k, v in next(it).items()}

    def finite(ms, tag):
        rows = [{k: float(v) for k, v in m.items()} for m in ms]
        require(all(math.isfinite(v) for r in rows for v in r.values()),
                f"a baseline {tag} step's metrics are not finite: {rows}")
        return rows

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state, step, batch = fresh(1)
    tracer, metrics = Tracer(), []
    LAUNCHES.reset()
    t0 = time.perf_counter()
    for _ in range(BASELINE_STEPS):
        with tracer.span("BaselinePhase"):
            params, state, m = step(params, state, batch())
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    rows = finite(metrics, "measured")
    per_step = {k: v / BASELINE_STEPS for k, v in launches.items()}
    host = 1e3 * sum(sp.dur for sp in tracer.spans) / BASELINE_STEPS
    ms = 1e3 * wall / BASELINE_STEPS
    log(f"  baseline: {cfg.name} unpartitioned ({smi_line()}), "
        f"{cfg.n_layers} layers under remat, batch {LM_BATCH} x {LM_SEQ}, "
        f"{cfg.dtype} compute, {cfg.param_dtype} params, {opt_name}; "
        f"{BASELINE_STEPS} steps in {wall:.2f}s = {ms:.1f} ms/step "
        f"({host:.1f} ms of host issue a step), {tokens * 1e3 / ms:.0f} "
        f"tokens/s, peak {peak / 2**30:.2f} GiB, launches a step {per_step}"
        f" (predicted {BASELINE_LAUNCHES}); operations floor "
        f"{flops / 1e12:.1f} TFLOP = {floor_ms:.1f} ms/step at 989 TFLOP/s")
    log(f"    loss {[round(r['loss'], 4) for r in rows]}, ce "
        f"{[round(r['ce'], 4) for r in rows]}, grad_norm "
        f"{[round(r['grad_norm'], 3) for r in rows]}")
    require(per_step == BASELINE_LAUNCHES,
            f"baseline launches a step {per_step}, predicted "
            f"{BASELINE_LAUNCHES}")

    # the profiled steps (the run goes on: steps 5 and 6)
    rt = Tracer()
    with ranged(rt), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        profile_lead(torch)
        pm = []
        for _ in range(BASELINE_PROFILE_STEPS):
            with rt.span("BaselinePhase"):
                params, state, m = step(params, state, batch())
            pm.append(m)
        profile_tail(torch)
    rows += finite(pm, "profiled")
    events = raw_events(prof)
    k = BASELINE_PROFILE_STEPS
    fam = {}
    p_host, wait, devms, n = range_split(
        events, lambda name: name == "BaselinePhase", fam)
    all_fam, _ = event_families(events)
    del prof, events
    prof_row = {"steps": k, "host_ms_per_step": p_host / k,
                "sync_wait_ms_per_step": wait / k,
                "device_ms_per_step": devms / k, "launches_per_step": n / k,
                "busy_share": devms / p_host if p_host else None,
                "floor_share": floor_ms * k / devms if devms else None,
                "families_per_step": {f: {"ms": t / k, "launches": c / k}
                                      for f, (t, c) in fam.items()}}
    log(f"    profiled {k} steps: host {p_host / k:.1f} ms/step (sync wait "
        f"{wait / k:.1f}), device {devms / k:.1f} ms/step (busy "
        f"{100 * devms / max(p_host, 1e-9):.1f}%, "
        f"{100 * floor_ms * k / max(devms, 1e-9):.1f}% of the operations "
        f"floor), {n / k:.0f} device activities a step")
    for f, (t, c) in sorted(fam.items(), key=lambda x: -x[1][0]):
        log(f"      {f:28s} {t / k:10.2f} ms/step  {c / k:8.0f} a step")
    require(n > 0, "the profile attributed no kernels to the baseline steps")
    require(SDPA_FAMILY not in all_fam, "the baseline profile holds SDPA "
            f"kernels: {all_fam.get(SDPA_FAMILY)}")

    # the paper's comparison, beside the partitioned steps of this phase
    left, right = (pnn[p]["device_ms_per_step"] for p in ("left", "right"))
    ratios = {"peak_over_larger_stage": peak / pnn_peak,
              "device_over_left_plus_right": devms / k / (left + right)}
    log(f"    against the 2-stage PNN schedule of this phase: peak "
        f"{peak / 2**30:.2f} / {pnn_peak / 2**30:.2f} GiB = "
        f"{ratios['peak_over_larger_stage']:.3f}; device ms a step "
        f"{devms / k:.1f} / (left {left:.1f} + right {right:.1f}) = "
        f"{ratios['device_over_left_plus_right']:.3f}")
    del params, state, step
    torch.cuda.empty_cache()

    # accum=2 from the same params on the same first batch
    torch.cuda.reset_peak_memory_stats()
    params, state, step, batch = fresh(2)
    _, _, m2 = step(params, state, batch())
    acc = finite([m2], "accum=2")[0]
    peak2 = torch.cuda.max_memory_allocated()
    rel, rel_g = (abs(acc[k] - rows[0][k]) / abs(rows[0][k])
                  for k in ("loss", "grad_norm"))
    log(f"    accum=2: loss {acc['loss']:.5f} against accum=1's "
        f"{rows[0]['loss']:.5f} (relative {rel:.2e}), grad_norm "
        f"{acc['grad_norm']:.5f} against {rows[0]['grad_norm']:.5f} "
        f"(relative {rel_g:.2e}; bf16 tolerance {REL_TOL['bfloat16']:g}), "
        f"peak {peak2 / 2**30:.2f} GiB")
    # the loss is the forward's alone; the gradient norm also holds the
    # second microbatch's gradients and their accumulation to account
    for k, r in (("loss", rel), ("grad_norm", rel_g)):
        require(r <= REL_TOL["bfloat16"],
                f"the accum=2 {k} {acc[k]} differs from accum=1's "
                f"{rows[0][k]} by {r:.3g}")
    del params, state, step
    torch.cuda.empty_cache()
    return {"batch": LM_BATCH, "seq": LM_SEQ, "optimizer": opt_name,
            "steps": BASELINE_STEPS, "wall_s": wall, "ms_per_step": ms,
            "host_issue_ms_per_step": host,
            "tokens_per_s": tokens * 1e3 / ms, "peak_mem_bytes": peak,
            "launches": launches, "launches_per_step": per_step,
            "metrics": rows, "floor_tflop": flops / 1e12,
            "floor_ms_per_step": floor_ms, "profile": prof_row,
            "ratios": ratios, "accum2": dict(acc, rel_err=rel,
                                             peak_mem_bytes=peak2)}


# -- phase 9 -------------------------------------------------------------------

# Fig. 5 at full width: qwen2-1.5b as ``python -m repro_torch.launch.train
# --arch qwen2-1.5b --mode pnn --dist round_robin --devices 1 --stages 2
# --batch 8 --seq 1024 --steps 8`` trains it (both stages at once, 8
# ticks); the profiled run takes 2
LM_PAR_TICKS, LM_PAR_PROFILE_TICKS = 8, 2
# kernel launches a tick: each checkpointed layer runs its forward twice
# and its backward once (stage 0's 14 layers and stage 1's), and stage 0's
# SIL-MSE once; stage 1 runs no frozen-prefix forward
LM_PAR_LAUNCHES = {"flash_attention": 56, "flash_attention_bwd": 28,
                   "sil_mse": 1}
# the durability checks: ticks of the full-size MLP's and the smoke LM's
# Fig. 5, each stage checkpointed every tick
DURABLE_TICKS = 3


def lm_parallel_spec(ticks):
    """The launcher's ``--dist`` spec: every stage ``ticks`` AdamW steps at
    lr 3e-4, kappa 1.0, the config's bf16 compute."""
    from repro_torch.train.spec import StageSpec, TrainSpec
    return TrainSpec(n_stages=2, kappa=1.0, stages=(
        StageSpec(steps=ticks, lr=3e-4, optimizer="adamw"),) * 2)


def bitwise(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(la, lb))


def phase_lm_parallel(torch, dev, report):
    """qwen2-1.5b's Fig. 5 at full width, through the stage executor and
    through the phase's own loop (bitwise equal); a profiled 2-tick run;
    then the durability contract and one full-width stage's checkpoint."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.core import partition
    from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import recipes
    from repro_torch.tree import tree_map
    cfg = get("qwen2-1.5b")
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    tokens = LM_BATCH * LM_SEQ

    def run(ticks, dist, tracer):
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0))
        return recipes.run_lm_parallel(
            cfg, 2, params,
            lambda i: lm_batch_at(stream, LM_BATCH, LM_SEQ, i),
            lm_parallel_spec(ticks),
            torch.Generator(device=dev).manual_seed(1), dist=dist,
            dist_devices=[dev], device=dev, tracer=tracer)

    def phase_ms(tracer):
        """Host ms of the phase span (the executor's setup, the ticks, and
        the loss read at its end, the one wait for the card), and from the
        first tick's start to the span's end (the executor's ticks only)."""
        sp = next(sp for sp in tracer.spans if sp.name == "ParallelSilPhase")
        ticks = [t.ts for t in tracer.spans if t.name.startswith("tick ")]
        start = min(ticks) if ticks else sp.ts
        return 1e3 * sp.dur, 1e3 * (sp.ts + sp.dur - start)

    flops = lm_step_flops(cfg, partition.make_plan(cfg, 2).bounds, LM_BATCH,
                          LM_SEQ)["parallel"]
    floor_ms = 1e3 * flops / PEAK_FLOPS["bfloat16"]
    out, turns = {}, []
    # the loop first: the first full-width run of a process pays for what
    # later ones find ready (in turns loop, executor, executor, loop until
    # PR 28, cut to two runs for time)
    for i, (name, dist) in enumerate((("loop", None),
                                      ("executor", "round_robin"))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tracer = Tracer()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        joined, hist = run(LM_PAR_TICKS, dist, tracer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = LAUNCHES.snapshot()
        peak = torch.cuda.max_memory_allocated()
        span_ms, ticks_ms = phase_ms(tracer)
        ms = span_ms / LM_PAR_TICKS
        row = {"run": name, "wall_s": wall, "ms_per_tick": ms,
               "ms_per_tick_from_first_tick": ticks_ms / LM_PAR_TICKS,
               "tokens_per_s": tokens * 1e3 / ms, "launches": launches,
               "peak_mem_bytes": peak,
               "records": [(r.step, r.stage, r.loss) for r in hist.records]}
        turns.append(row)
        log(f"  {i}: {name:8s} {LM_PAR_TICKS} ticks in {wall:.1f}s (init "
            f"and SIL table included), {ms:.1f} ms/tick (phase span / "
            f"ticks; {ticks_ms / LM_PAR_TICKS:.1f} from the first tick), "
            f"{tokens * 1e3 / ms:.0f} tokens/s, peak {peak / 2**30:.2f} GiB,"
            f" launches {launches}")
        if name not in out:
            with torch.no_grad():         # the joined network is usable
                logits, _ = M.forward(cfg, joined, {"tokens": torch.arange(
                    128, device=dev)[None]}, remat=False)
            out[name] = dict(row, joined=tree_map(lambda t: t.cpu(), joined),
                             logits_finite=bool(torch.isfinite(
                                 logits.float()).all()))
            del logits
        del joined, hist
    ex, loop = out["executor"], out["loop"]
    losses = [v for _, _, v in ex["records"]]
    per_tick = {k: ex["launches"].get(k, 0) / LM_PAR_TICKS
                for k in LM_PAR_LAUNCHES}
    same_losses = all(r["records"] == ex["records"] for r in turns)
    same_params = bitwise(torch, ex["joined"], loop["joined"])
    log(f"  {cfg.name} Fig. 5: {cfg.n_layers} layers, d {cfg.d_model}, heads"
        f" {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_padded}, 2 stages at once on {dev}, batch {LM_BATCH} x "
        f"{LM_SEQ}; operations floor {flops / 1e12:.1f} TFLOP = "
        f"{floor_ms:.1f} ms/tick at 989 TFLOP/s; executor launches a tick "
        f"{per_tick} (predicted {LM_PAR_LAUNCHES}); executor == loop: "
        f"losses {same_losses}, params {same_params}")
    for k in (0, 1):
        log(f"    stage {k} losses "
            f"{[round(v, 4) for _, s, v in ex['records'] if s == k]}")
    require(len(losses) == 2 * LM_PAR_TICKS
            and all(math.isfinite(v) for v in losses),
            f"Fig.-5 losses: {losses}")
    require(per_tick == LM_PAR_LAUNCHES,
            f"Fig.-5 launches a tick {per_tick}, predicted {LM_PAR_LAUNCHES}")
    require(same_losses and same_params,
            "the executor and the phase's loop differ (losses "
            f"{same_losses}, params {same_params})")
    require(ex["logits_finite"] and loop["logits_finite"],
            "the joined network's logits are not finite")
    del ex["joined"], loop["joined"]
    torch.cuda.empty_cache()

    # a shorter run under the profiler: per tick, launches by kernel,
    # device ms by family, the busy share over the ticks' spans
    rt = Tracer()
    LAUNCHES.reset()
    with ranged(rt), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        profile_lead(torch)
        run(LM_PAR_PROFILE_TICKS, "round_robin", rt)
        profile_tail(torch)
    n_t = LM_PAR_PROFILE_TICKS
    wrapper = {k: v / n_t for k, v in LAUNCHES.snapshot().items()}
    fam = {}
    host, wait, devms, n = range_split(
        raw_events(prof), lambda name: name.startswith("tick "), fam)
    prof_row = {"ticks": n_t, "host_ms_per_tick": host / n_t,
                "sync_wait_ms_per_tick": wait / n_t,
                "device_ms_per_tick": devms / n_t,
                "launches_per_tick": n / n_t,
                "busy_share": devms / host if host else None,
                "floor_share": floor_ms * n_t / devms if devms else None,
                "wrapper_launches_per_tick": wrapper,
                "families_per_tick": {f: {"ms": m / n_t, "launches": c / n_t}
                                      for f, (m, c) in fam.items()}}
    log(f"    profiled {n_t} ticks: host {host / n_t:.1f} ms/tick (sync wait"
        f" {wait / n_t:.1f}), device {devms / n_t:.1f} ms/tick (busy "
        f"{100 * devms / max(host, 1e-9):.1f}%, "
        f"{100 * floor_ms * n_t / max(devms, 1e-9):.1f}% of the operations "
        f"floor), {n / n_t:.0f} device activities a tick; kernel wrappers a "
        f"tick {wrapper}")
    for f, (m, c) in sorted(fam.items(), key=lambda x: -x[1][0]):
        log(f"      {f:28s} {m / n_t:10.2f} ms/tick  {c / n_t:8.0f} "
            "launches/tick")
    require(n > 0, "the profile attributed no kernels to the ticks")
    base = report.get("lm_train", {}).get("baseline")
    if base and devms:
        prof_row["baseline_device_over_tick"] = r = \
            base["profile"]["device_ms_per_step"] / (devms / n_t)
        log(f"    the unpartitioned baseline step (lm_train) against a tick:"
            f" {base['profile']['device_ms_per_step']:.1f} / "
            f"{devms / n_t:.1f} device ms = {r:.3f}")
    require({k: wrapper.get(k, 0) for k in LM_PAR_LAUNCHES}
            == LM_PAR_LAUNCHES,
            f"profiled launches a tick {wrapper}, predicted "
            f"{LM_PAR_LAUNCHES}")
    torch.cuda.empty_cache()
    report["lm_parallel"] = {
        "batch": LM_BATCH, "seq": LM_SEQ, "ticks": LM_PAR_TICKS,
        "floor_tflop": flops / 1e12, "floor_ms_per_tick": floor_ms,
        "runs": [{k: v for k, v in r.items() if k != "records"}
                 for r in turns], "losses": ex["records"],
        "bitwise_equal": same_losses and same_params, "profile": prof_row,
        "durability": check_durability(torch, dev),
        "stage_checkpoint": time_stage_checkpoint(torch, dev, stream)}


def resume_vs_uninterrupted(torch, be, spec, params, sils, dev, root):
    """Fig. 5 through the executor, every stage checkpointed every tick;
    then again with stage 1 zeroed after tick 1, ``resume_stage(1,
    step=1)``, replayed, and the other stages run on.  Returns (params and
    optimizer state bitwise equal, losses equal, the join from the
    checkpoints bitwise equal to the live join)."""
    from repro_torch.dist import (StageExecutor, join_from_checkpoints,
                                  round_robin)
    from repro_torch.train.backends import make_optimizer_for
    from repro_torch.train.trainer import Trainer, TrainState
    from repro_torch.tree import tree_map
    n = be.n_stages
    hps = [spec.stage(k) for k in range(n)]

    def make(every):
        return StageExecutor(
            be, round_robin(n, [dev]), be.split(params), sils,
            [make_optimizer_for(hp, spec) for hp in hps], hps,
            ckpt_dir=root, ckpt_every=every)
    ref = make(1).run(DURABLE_TICKS)
    ex = make(0).run(1)
    ex.params[1] = tree_map(torch.zeros_like, ex.params[1])
    ex.opt_states[1] = tree_map(torch.zeros_like, ex.opt_states[1])
    require(ex.resume_stage(1, step=1) == 1, "resume_stage(1, step=1)")
    ex.run(DURABLE_TICKS, stages=[1])
    ex.run(DURABLE_TICKS, stages=[k for k in range(n) if k != 1])
    same = all(bitwise(torch, ref.params[k], ex.params[k])
               and bitwise(torch, ref.opt_states[k], ex.opt_states[k])
               for k in range(n))
    hists = []
    for e in (ref, ex):
        st = TrainState(stage_params=None)
        e.finalize(Trainer(be, spec), st)
        hists.append({(r.stage, r.step): r.loss for r in st.history.records
                      if r.loss is not None})
        live = be.join(st.stage_params)
    joined = join_from_checkpoints(root, be.split(params), be.join)
    return same, hists[0] == hists[1], bitwise(torch, live, joined)


def check_durability(torch, dev):
    """The port's ``checkpoint/resume_vs_uninterrupted``, bitwise on the
    card: the paper MLP's Fig. 5 at full size (3 stages, the EMNIST-size
    data on the card) and the smoke LM's (2 stages)."""
    import shutil
    from repro_torch.configs import get
    from repro_torch.core import partition
    from repro_torch.data.images import emnist_like
    from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
    from repro_torch.models import mlp as MLP
    from repro_torch.models import model as M
    from repro_torch.models.mlp import MLPConfig
    from repro_torch.train.backends import (LMBackend, MLPBackend,
                                            balanced_bounds)
    from repro_torch.train.spec import StageSpec, TrainSpec
    from repro_torch.verify import paper
    full = paper.PRESETS["full"]
    cfg = MLPConfig()
    data = emnist_like(n_train=full.n_train, n_test=full.n_test, seed=0,
                       noise=full.noise)
    spec = TrainSpec(batch_size=1410, kappa=10.0, n_stages=3, shuffle=True,
                     stages=(StageSpec(epochs=DURABLE_TICKS, lr=0.01,
                                       optimizer="sgdm", momentum=0.9),) * 3)
    be = MLPBackend(cfg, data, spec, bounds=balanced_bounds(cfg, 3),
                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    mlp = (be, spec, MLP.init_params(cfg, gen, device=dev),
           be.make_sils(gen, spec.kappa))
    lcfg = get("qwen2-1.5b", smoke=True)
    stream = synthetic_token_stream(20_000, lcfg.vocab_size, seed=0)
    lspec = TrainSpec(n_stages=2, kappa=1.0, stages=(
        StageSpec(steps=DURABLE_TICKS, lr=1e-3, optimizer="adamw"),) * 2)
    lbe = LMBackend(lcfg, partition.make_plan(lcfg, 2),
                    lambda i: lm_batch_at(stream, LM_SMOKE_BATCH,
                                          LM_SMOKE_SEQ, i), lspec,
                    device=dev)
    lgen = torch.Generator(device=dev).manual_seed(1)
    lm = (lbe, lspec, M.init_params(lcfg, lgen), lbe.make_sils(lgen, 1.0))
    out = {}
    for name, world in (("paper MLP, full size, 3 stages", mlp),
                        ("smoke LM, 2 stages", lm)):
        root = ROOT / "build" / "ckpt_durability"
        shutil.rmtree(root, ignore_errors=True)
        try:
            same, losses, join = resume_vs_uninterrupted(
                torch, *world, dev, str(root))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        log(f"  durability, {name}, {DURABLE_TICKS} ticks, checkpoint "
            f"every tick, stage 1 zeroed after tick 1 and resumed from its "
            f"tick-1 checkpoint: params and optimizer state bitwise equal "
            f"to the uninterrupted run {same}, losses equal {losses}; "
            f"join_from_checkpoints == the joined gather() {join}")
        require(same and losses and join,
                f"{name}: resume != uninterrupted (state {same}, losses "
                f"{losses}, join {join})")
        out[name] = {"bitwise": same, "losses_equal": losses,
                     "join_equal": join}
    return out


def time_stage_checkpoint(torch, dev, stream):
    """``save_stage`` + ``restore_stage`` of stage 1 of the full-width LM
    cut to ``SUPERVISED_LAYERS`` layers (params, the frozen tied copy,
    AdamW state after one tick) into ``build/``, restored onto the card and
    held bitwise; skipped, and said so, where the disk has less than twice
    its bytes free."""
    import shutil
    from repro_torch.configs import get
    from repro_torch.core import partition
    from repro_torch.data.lm import lm_batch_at
    from repro_torch.dist import StageExecutor, lifecycle, round_robin
    from repro_torch.models import model as M
    from repro_torch.plan import tree_param_bytes
    from repro_torch.train.backends import LMBackend, make_optimizer_for
    from repro_torch.tree import tree_leaves
    cfg = get("qwen2-1.5b").replace(n_layers=SUPERVISED_LAYERS)
    spec = lm_parallel_spec(1)
    be = LMBackend(cfg, partition.make_plan(cfg, 2),
                   lambda i: lm_batch_at(stream, LM_BATCH, LM_SEQ, i), spec,
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    hps = [spec.stage(k) for k in range(2)]
    ex = StageExecutor(be, round_robin(2, [dev]),
                       be.split(M.init_params(cfg, gen)),
                       be.make_sils(gen, 1.0),
                       [make_optimizer_for(hp, spec) for hp in hps], hps)
    ex.run(1)
    torch.cuda.synchronize()
    nbytes = tree_param_bytes({"params": ex.params[1],
                               "opt": ex.opt_states[1]})
    root = ROOT / "build" / "ckpt_stage_timing"
    root.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root.parent).free
    if free < 2 * nbytes:
        log(f"  full-width stage checkpoint timing not run: {free / 1e9:.1f}"
            f" GB free under build/, twice the stage's {nbytes / 1e9:.2f} GB"
            " needed")
        return {"bytes": nbytes, "free_bytes": free, "run": False}
    # the save's parts that are not the archive's write: the synchronous
    # device-to-host copy and the manifest's CRC32 of every leaf
    leaves = list(tree_leaves({"params": ex.params[1],
                               "opt": ex.opt_states[1]}))
    t0 = time.perf_counter()
    host = [t.to("cpu") for t in leaves]
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for h in host:
        zlib.crc32(h.numpy())
    crc_s = time.perf_counter() - t0
    del host
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        lifecycle.save_stage(str(root), 1, ex.ticks[1], ex.params[1],
                             ex.opt_states[1])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, opt_state, tick = lifecycle.restore_stage(
            str(root), 1, ex.params[1], ex.opt_states[1], device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = tick == 1 and bitwise(torch, ex.params[1], params) \
            and bitwise(torch, ex.opt_states[1], opt_state)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gb = nbytes / 1e9
    log(f"  stage 1 of the full-width {cfg.n_layers}-layer cut, checkpoint "
        f"(params, tied copy, AdamW state): "
        f"{gb:.2f} GB; save_stage {save_s:.2f} s = {gb / save_s:.2f} GB/s, "
        f"restore_stage onto the card {restore_s:.2f} s = "
        f"{gb / restore_s:.2f} GB/s; bitwise {same}; alone, the "
        f"device-to-host copy takes {d2h_s:.2f} s ({gb / d2h_s:.2f} GB/s) "
        f"and the CRC32 of every leaf {crc_s:.2f} s ({gb / crc_s:.2f} GB/s)")
    require(same, "the restored full-width stage differs from the saved one")
    return {"layers": cfg.n_layers, "bytes": nbytes, "free_bytes": free,
            "run": True, "save_s": save_s, "restore_s": restore_s,
            "bitwise": same, "d2h_s": d2h_s, "crc32_s": crc_s}


# -- phase 10 ------------------------------------------------------------------

# Fig. 3 at full width: 4 SIL steps of stage 0, the stored boundary of 4
# batches (step_idx 4 .. 7: cache row b j is the live phase's input at step
# 4 + j), 4 CE steps of stage 1 on it, 2 of recovery (8 / 8 / 8 / 4 until PR
# 29, cut for time); the profiled run 2 / 2 batches / 2 / 1
LM_FIG3_STEPS, LM_FIG3_PROFILE_STEPS = 4, 2
# new tokens a request of the staged-serving check (the serve phase's 32-64
# until PR 29, cut for time: the gates are per token and per decode step)
LM_FIG3_SERVE_TOKENS = 16
# kernel launches a step (a batch for the materialization): the no-grad
# prefix forward runs stage 0's 14 layers once; the right step on the cache
# runs no prefix, stage 1's 14 layers twice forward (remat) and once back
LM_FIG3_LAUNCHES = {"materialize": {"flash_attention": 14},
                    "right": {"flash_attention": 28,
                              "flash_attention_bwd": 14}}


def phase_lm_fig3(torch, dev, report):
    """qwen2-1.5b's Fig. 3 at full width on the stored boundary (the cache
    == live gate, RAM == spill), then the trained partitions checkpointed
    per stage, restored without a join and served staged against joined."""
    import shutil
    from types import SimpleNamespace
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.core import partition
    from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import lm_spec
    from repro_torch.models import model as M
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import LMBackend, Trainer
    cfg = get("qwen2-1.5b")
    plan = partition.make_plan(cfg, 2)
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    tokens = LM_BATCH * LM_SEQ
    smi = smi_line()

    def train(phases, steps, tracer=None):
        spec = lm_spec(SimpleNamespace(steps=2 * steps, lr=3e-4, accum=1,
                                       precision=None), 2)
        be = LMBackend(cfg, plan, lambda i: lm_batch_at(
            stream, LM_BATCH, LM_SEQ, i), spec, device=dev)
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0))
        return Trainer(be, spec, tracer=tracer).run(
            phases, params=params,
            gen=torch.Generator(device=dev).manual_seed(1))

    def keep_rows(into):
        def fn(state):
            c = state.boundary["h"]
            into.update(rows=np.array(c.array()), spilled=c.spilled,
                        nbytes=c.nbytes)
        return fn

    flops = lm_step_flops(cfg, plan.bounds, LM_BATCH, LM_SEQ)
    n = LM_FIG3_STEPS
    seen, marks = {}, {}

    def mark(name, extra=None):
        def fn(state):
            marks[name] = LAUNCHES.snapshot()
            if extra:
                extra(state)
        return fn
    taps = {"left": mark("left"),
            "materialize": mark("materialize", keep_rows(seen)),
            "right": mark("right"),
            "recovery": mark("recovery", lambda s: seen.update(
                stages=s.stage_params))}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracer = Tracer()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    joined, hist = train(fig3_phases(n, taps), n, tracer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    phases = hist.column("phase")
    losses = hist.column("loss")
    steps = {"left": n, "materialize": n, "right": n,
             "recovery": n // 2}
    rows = [r for r in phase_rows(tracer, steps, tokens)
            if r["phase"] != "Tap"]
    before, per_phase = {}, {}
    for p in ("left", "materialize", "right", "recovery"):
        per_phase[p] = {k: (v - before.get(k, 0)) / steps[p]
                        for k, v in marks[p].items()
                        if v - before.get(k, 0)}
        before = marks[p]
    log(f"  {cfg.name} Fig. 3 on the stored boundary ({smi}): "
        f"{cfg.n_layers} layers, d {cfg.d_model}, 2 stages, batch "
        f"{LM_BATCH} x {LM_SEQ}, bf16 compute, fp32 params, AdamW; "
        f"{len(losses)} steps and {n} stored batches in {wall:.1f}s (init "
        f"and SIL table included), peak {peak / 2**30:.2f} GiB, launches "
        f"{launches}")
    floors = {"left": flops["left"], "materialize": flops["materialize"],
              "right": flops["right_cache"], "recovery": flops["recovery"]}
    for r in rows:
        fl = floors[r["phase"]]
        r["bound_ms_per_step"] = 1e3 * fl / PEAK_FLOPS["bfloat16"]
        r["launches_per_step"] = per_phase[r["phase"]]
        unit = "batch" if r["phase"] == "materialize" else "step"
        log(f"    {r['phase']:12s} {r['wall_ms']:10.1f} ms, {r['steps']:3d} "
            f"{unit}{'es' if unit == 'batch' else 's'}, "
            f"{r['ms_per_step']:.1f} ms/{unit}, "
            f"{r['samples_per_s']:.0f} tokens/s; operations floor "
            f"{fl / 1e12:.1f} TFLOP = {r['bound_ms_per_step']:.1f} ms/{unit}"
            f" at 989 TFLOP/s; launches/{unit} {per_phase[r['phase']]}")
    for p in ("left", "right", "recovery"):
        log(f"    {p:9s} losses "
            f"{[round(v, 4) for ph, v in zip(phases, losses) if ph == p]}")
    require([phases.count(p) for p in ("left", "right", "recovery")]
            == [n, n, n // 2], f"Fig.-3 phases {phases}")
    require(all(math.isfinite(v) for v in losses),
            "a Fig.-3 loss is not finite")
    need = ("flash_attention", "flash_attention_bwd", "sil_mse")
    require(all(launches.get(k, 0) > 0 for k in need),
            f"the Fig.-3 run launched none of some of {need}: {launches}")
    for p, want in LM_FIG3_LAUNCHES.items():
        require(per_phase[p] == want, f"Fig.-3 {p} launches a step "
                f"{per_phase[p]}, predicted {want}")
    right = [(s, v) for ph, s, v in zip(phases, hist.column("step"), losses)
             if ph == "right"]
    ram = seen.pop("rows")
    row_bytes = seen["nbytes"]

    # the gate: the same SIL phase, then the boundary stored in a forced
    # memmap spill and the right phase on the LIVE frozen prefix
    spill_dir = ROOT / "build" / "lm_fig3_spill"
    shutil.rmtree(spill_dir, ignore_errors=True)
    live_seen = {}
    try:
        live_joined, live_hist = train(fig3_phases(
            n, {"materialize": keep_rows(live_seen)}, source="live",
            spill_dir=str(spill_dir), recovery=False), n)
        left_files = list(spill_dir.iterdir())
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    live = [(s, v) for ph, s, v in zip(live_hist.column("phase"),
                                       live_hist.column("step"),
                                       live_hist.column("loss"))
            if ph == "right"]
    g0, g1 = plan.bounds[1]
    stage1 = {"groups": joined["groups"][g0:g1],
              "final_norm": joined["final_norm"]}
    live1 = {"groups": live_joined["groups"][g0:g1],
             "final_norm": live_joined["final_norm"]}
    same_rows = live_seen["spilled"] and not seen["spilled"] and \
        np.array_equal(ram, live_seen["rows"])
    same_losses = right == live
    same_stage1 = bitwise(torch, stage1, live1)
    same_left = [v for ph, v in zip(phases, losses) if ph == "left"] == \
        [v for ph, v in zip(live_hist.column("phase"),
                            live_hist.column("loss")) if ph == "left"]
    log(f"    stored rows {ram.shape} {ram.dtype} ({row_bytes / 1e6:.1f} "
        f"MB, {row_bytes / n / 1e6:.1f} MB a batch): RAM == forced memmap "
        f"spill, bitwise {same_rows}; the spill removed at the run's end "
        f"{not left_files}")
    log(f"    gate, cache == live: the right phase's {len(right)} losses "
        f"(steps {right[0][0]}..{right[-1][0]}) {same_losses}, trained "
        f"stage 1 {same_stage1}, bitwise; left losses equal {same_left}")
    require(same_rows and not left_files,
            "the stored rows differ between RAM and the spill")
    require(same_losses and same_stage1 and same_left,
            "the right phase on the stored boundary differs from the live "
            f"prefix's (losses {same_losses}, stage 1 {same_stage1}, left "
            f"{same_left})")
    del live_joined, live_hist, stage1, live1, ram, live_seen
    torch.cuda.empty_cache()

    # the profiled short run: device ms, busy share, launches by family
    rt = Tracer()
    m = LM_FIG3_PROFILE_STEPS
    with ranged(rt), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        profile_lead(torch)
        train(fig3_phases(m), m, rt)
        profile_tail(torch)
    events = raw_events(prof)
    psteps = {"left": m, "materialize": m, "right": m, "recovery": m // 2}
    prof_rows = []
    for sp in rt.spans:
        p = TRAIN_PHASES.get(sp.name)
        if p is None:
            continue
        fam = {}
        host, wait, devms, cnt = range_split(
            events, lambda name, c=sp.name: name == c, fam)
        k = psteps[p]
        row = {"phase": p, "steps": k, "host_ms": host, "sync_wait_ms": wait,
               "device_ms": devms, "launches": cnt,
               "device_ms_per_step": devms / k, "launches_per_step": cnt / k,
               "busy_share": devms / host if host else None,
               "floor_share": 1e3 * floors[p] * k / PEAK_FLOPS["bfloat16"]
               / devms if devms else None,
               "families_per_step": {f: {"ms": ms / k, "launches": c / k}
                                     for f, (ms, c) in fam.items()}}
        prof_rows.append(row)
        log(f"    profiled {p:11s} {k}: host {host:8.1f} ms (sync wait "
            f"{wait:.1f}), device {devms:8.1f} ms (busy "
            f"{100 * devms / max(host, 1e-9):.1f}%), {cnt / k:.0f} "
            f"activities and {devms / k:.1f} device ms a "
            f"{'batch' if p == 'materialize' else 'step'} = "
            f"{100 * (row['floor_share'] or 0):.1f}% of the floor")
        for f, (ms, c) in sorted(fam.items(), key=lambda x: -x[1][0]):
            log(f"      {f:28s} {ms / k:9.2f} ms  {c / k:7.0f} a "
                f"{'batch' if p == 'materialize' else 'step'}")
    by = {r["phase"]: r for r in prof_rows}
    require(set(by) == {"left", "materialize", "right", "recovery"}
            and all(r["launches"] for r in prof_rows),
            f"the profile missed a Fig.-3 phase: {sorted(by)}")
    batch_bytes = row_bytes / n
    d2h = by["materialize"]["families_per_step"].get("copy DtoH", {})
    h2d = by["right"]["families_per_step"].get("copy HtoD", {})
    copies = {"d2h_ms_per_batch": d2h.get("ms"),
              "d2h_gb_per_s": batch_bytes / 1e6 / d2h["ms"]
              if d2h.get("ms") else None,
              "h2d_ms_per_step": h2d.get("ms"),
              "h2d_gb_per_s": batch_bytes / 1e6 / h2d["ms"]
              if h2d.get("ms") else None}
    log(f"    boundary copies ({smi}): device-to-host "
        f"{copies['d2h_ms_per_batch']} ms a batch = "
        f"{copies['d2h_gb_per_s']} GB/s; host-to-device "
        f"{copies['h2d_ms_per_step']} ms a cache step = "
        f"{copies['h2d_gb_per_s']} GB/s ({batch_bytes / 1e6:.1f} MB)")
    torch.cuda.empty_cache()

    serve = serve_fig3_stages(torch, dev, cfg, plan, seen.pop("stages"), smi)
    del joined, hist, seen
    torch.cuda.empty_cache()
    report["lm_fig3"] = {
        "card": smi, "batch": LM_BATCH, "seq": LM_SEQ, "wall_s": wall,
        "peak_mem_bytes": peak, "launches": launches, "phases": rows,
        "losses": losses, "boundary_bytes": row_bytes,
        "cache_equals_live": True, "ram_equals_spill": True,
        "profile": prof_rows, "copies": copies, "serve": serve}


def capped_requests(cfg, new_tokens):
    """The serve phase's 10 requests with at most ``new_tokens`` new tokens
    each."""
    from repro_torch.serve import GenerationConfig, Request
    return [dataclasses.replace(q, gen=q.gen.replace(
        max_new_tokens=min(new_tokens, q.gen.max_new_tokens)))
        for q in serve_requests(cfg, GenerationConfig, Request)]


def serve_fig3_stages(torch, dev, cfg, plan, stages, smi):
    """The trained partitions as a user deploys them: the tied snapshot
    refreshed, each stage checkpointed on its own, restored without a join
    and served staged after the joined tree on each pool (a warm-up run,
    then joined, staged; joined, staged, staged, joined until PR 28, cut to
    two runs for time), ``LM_FIG3_SERVE_TOKENS`` new tokens a request."""
    import shutil
    from repro_torch.core import partition
    from repro_torch.dist import lifecycle
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.plan import tree_param_bytes
    from repro_torch.serve import (Engine, GenerationConfig, Request,
                                   stage_params_from_checkpoints)
    partition.refresh_tied_unembed(cfg, plan, stages)
    nbytes = tree_param_bytes(stages)
    root = ROOT / "build" / "lm_fig3_ckpt"
    root.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root.parent).free
    require(free > 2 * nbytes, f"{free / 1e9:.1f} GB free under build/, "
            f"twice the stages' {nbytes / 1e9:.2f} GB needed")
    shutil.rmtree(root, ignore_errors=True)
    try:
        save_s = []
        for k, sp in enumerate(stages):
            t0 = time.perf_counter()
            lifecycle.save_stage(str(root), k, 0, sp)
            save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        restored = stage_params_from_checkpoints(cfg, plan, str(root),
                                                 devices=[dev, dev])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = bitwise(torch, stages, restored)
    gb = nbytes / 1e9
    log(f"  per-stage checkpoints of the trained stages ({smi}): "
        f"{[round(tree_param_bytes(s) / 1e9, 2) for s in stages]} GB fp32;"
        f" save_stage {sum(save_s):.2f} s = {gb / sum(save_s):.2f} GB/s, "
        f"stage_params_from_checkpoints onto the card {restore_s:.2f} s = "
        f"{gb / restore_s:.2f} GB/s; restored bitwise {same}")
    require(same, "the restored stages differ from the saved ones")
    del stages
    torch.cuda.empty_cache()
    joined = partition.join_stage_params(cfg, plan, restored)
    reqs = capped_requests(cfg, LM_FIG3_SERVE_TOKENS)
    greedy = [i for i, r in enumerate(reqs) if r.gen.temperature <= 0]
    out = {"checkpoint": {"bytes": nbytes, "save_s": save_s,
                          "restore_s": restore_s, "bitwise": same}}
    for paged in (False, True):
        pool = "paged" if paged else "contiguous"
        engines = {"joined": Engine(cfg, joined, device=dev,
                                    precision="bf16", max_slots=8,
                                    paged=paged),
                   "staged": Engine(cfg, plan=plan, stage_params=restored,
                                    device=dev, precision="bf16",
                                    max_slots=8, paged=paged)}
        engines["joined"].generate(reqs)   # warm-up: cuBLAS picks per shape
        runs = []
        for mode in ("joined", "staged"):
            r = run_engine(torch, engines[mode], reqs, LAUNCHES)
            r["mode"] = mode
            runs.append(r)
            log(f"    {pool:10s} {mode:6s}: {r['n_generated']} tokens in "
                f"{r['wall_s']:.2f}s = {r['tokens_per_s']:.1f} tok/s, TTFT "
                f"p50 {r['ttft_p50_ms']:.1f} ms (max {r['ttft_max_ms']:.1f})"
                f", {r['ms_per_decode_step']:.2f} ms/decode step over "
                f"{r['decode_steps']} steps, peak {r['peak_mem_gib']:.2f} "
                f"GiB, launches {r['launches']}")
        want = runs[0]
        for r in runs[1:]:
            require(all(r["tokens"][i] == want["tokens"][i] for i in greedy),
                    f"{pool}: {r['mode']} greedy tokens differ from joined")
            per = {k: v / r["decode_steps"] for k, v in r["launches"].items()}
            per0 = {k: v / want["decode_steps"]
                    for k, v in want["launches"].items()}
            require(per == per0, f"{pool}: {r['mode']} launches a decode "
                    f"step {per}, joined {per0}")
        need = ["flash_attention", "paged_decode_attention" if paged
                else "decode_attention"]
        require(all(runs[1]["launches"].get(k, 0) > 0 for k in need),
                f"{pool}: the staged run launched none of some of {need}")
        prof = {}
        if not paged:
            short = [dataclasses.replace(q, gen=q.gen.replace(
                max_new_tokens=16)) for q in reqs[:4]]
            for mode in ("joined", "staged"):
                prof[mode] = p = profile_run(torch, engines[mode], short)
                d = p["decode_per_step"]
                log(f"      profiled {mode:6s} ({smi}): per decode step "
                    f"device {d['device_ms']:.3f} ms, {d['launches']:.0f} "
                    f"activities, host {d['host_ms_unprofiled']:.2f} ms "
                    f"unprofiled; busy {100 * p['busy_share']:.1f}%")
        same_sampled = all(r["tokens"] == want["tokens"] for r in runs)
        log(f"    {pool}: greedy tokens staged == joined over "
            f"{len(greedy)} requests in {len(runs)} runs; sampled equal too "
            f"{same_sampled}")
        out[pool] = {"runs": [{k: v for k, v in r.items() if k != "tokens"}
                              for r in runs], "profile": prof,
                     "sampled_equal": same_sampled}
        del engines
        torch.cuda.empty_cache()
    return out


# -- phase 11 ------------------------------------------------------------------

# granite-moe-3b-a800m at full width (32 MoE layers, d 1536, 24/8 heads of
# 64, 40 experts of d_ff 512, top 8, tied; 3.299 B parameters) from seeded
# random weights: served as the serve phase serves (10 requests, 8 slots,
# bf16, both pools), and trained as ``python -m repro_torch.launch.train
# --arch granite-moe-3b-a800m --mode pnn --stages 2 --batch 8 --seq 1024
# --steps 8`` trains it (4 steps a stage, 2 of recovery); the profiled run
# takes 2 a stage and 1 of recovery, the repeat gate 2 SIL steps twice
MOE_ARCH = "granite-moe-3b-a800m"
# (SIL, CE on the live prefix, recovery) steps: launch/train.py --mode pnn
# --stages 2 --steps 8's split, and --steps 4's for the profiled run
MOE_TRAIN_STEPS, MOE_PROFILE_STEPS, MOE_REPEAT_STEPS = (4, 4, 2), (2, 2, 1), 2
MOE_TOP_KERNELS = 15
# new tokens a request that ``serve_cut`` serves (the serve phase's 32-64,
# cut for time: 30-170 ms of host a decode step at these models' widths)
SERVE_CUT_TOKENS = 16


@contextlib.contextmanager
def recording_aux(torch, out):
    """While in effect, every objective that adds the MoE aux terms
    (``losses.moe_aux_loss``: each stage loss and recovery) appends its
    (lb, z) to ``out`` as one fp32 device tensor, without a host read."""
    from repro_torch.core import losses
    inner = losses.moe_aux_loss

    def recorded(cfg, loss, aux):
        out.append(torch.stack([aux["lb_loss"].detach(),
                                aux["z_loss"].detach()]))
        return inner(cfg, loss, aux)
    losses.moe_aux_loss = recorded
    try:
        yield out
    finally:
        losses.moe_aux_loss = inner


def serve_cut(torch, dev, cfg, required):
    """A model (with experts or dense) from seeded random weights, served
    as the serve phase serves (8 greedy and 2 sampled requests on each
    pool, at most ``SERVE_CUT_TOKENS`` new tokens each; a profiled
    short run of 8 tokens a request: a decode step makes
    thousands of launches, and the profile's processing grows with them);
    sampled streams must agree across the pools.  Its decode floor reads every
    weight of the engine's compute copy once (bf16 but for the leaves it
    keeps in their storage type; at decode every expert computes its C
    slots), except an untied input embedding, of which a step reads one
    row a request, and reads and writes every slot's recurrent state once
    (Mamba's, mLSTM's and sLSTM's at 8 slots; not an attention cache)."""
    from repro_torch.models import model as M
    from repro_torch.precision import tree_bytes
    from repro_torch.serve.kv_cache import PAGED_LEAVES
    from repro_torch.tree import tree_leaves, tree_map
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    kinds = [k for k, _, _ in M.slot_spec(cfg)]
    ffn = (f"{cfg.moe.num_experts} experts of d_ff {cfg.d_ff}, top "
           f"{cfg.moe.top_k} every {cfg.moe.every}" if cfg.moe else
           f"dense {cfg.mlp_type} d_ff {cfg.d_ff}" if cfg.d_ff else "no FFN")
    log(f"  {cfg.name}: {cfg.n_layers} layers ({kinds}), d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, {cfg.norm}, "
        f"{ffn}, vocab {cfg.vocab_padded} "
        f"{'tied' if cfg.tie_embeddings else 'untied'}; {n / 1e9:.3f} B "
        f"random {cfg.param_dtype} params in "
        f"{time.perf_counter() - t0:.1f}s")
    runs, sampled_equal = serve_model(
        torch, dev, cfg, params, required, profile_tokens=8,
        reqs=capped_requests(cfg, SERVE_CUT_TOKENS))
    require(sampled_equal, f"{cfg.name}: sampled streams differ between the "
            "contiguous and paged pools")
    copy = M.compute_copy(tree_map(lambda t: t.to("meta"), params),
                          torch.bfloat16)
    weights = tree_bytes(copy)
    read = weights if cfg.tie_embeddings else \
        weights - tree_bytes([copy["tok_embed"]])
    state = tree_bytes([t for c in M.init_cache(cfg, 8, 1, device="meta")
                        .values() for name, t in c.items()
                        if name not in PAGED_LEAVES])
    ms = 1e3 * (read + 2 * state) / HBM_BYTES_PER_S
    log(f"  decode floor: {read / 1e9:.4f} GB of the compute copy's weights "
        f"read and {state / 1e6:.1f} MB of recurrent state read and written "
        f"at 8 slots -> {ms:.4f} ms at 3.35 TB/s")
    out = {"params": n, "runs": runs, "sampled_equal": sampled_equal,
           "weight_bytes": weights, "state_bytes": state,
           "all_weights_ms_per_step": 1e3 * weights / HBM_BYTES_PER_S,
           "weights_bound_ms_per_step": ms}
    del params
    torch.cuda.empty_cache()
    return out


def device_frames(torch, dev, cfg, b):
    """``frames_of(i)``: the entries step i's batch adds for a stubbed
    frontend, made on the card from a seed of the step (the same whenever
    step i is drawn): an encoder-decoder's (b, enc_seq, d) fp32 frames, a
    vision config's (b, vision_tokens, d) fp32 image rows; none
    otherwise."""
    def frames_of(i):
        rows = cfg.enc_seq if cfg.enc_dec else cfg.vision_tokens \
            if cfg.frontend == "vision" else 0
        if not rows:
            return {}
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        return {"frames" if cfg.enc_dec else "image_embeds": torch.randn(
            (b, rows, cfg.d_model), generator=g, device=dev) * 0.02}
    return frames_of


def train_cut(torch, dev, cfg, need, batch=LM_BATCH, seq=LM_SEQ,
              steps=MOE_TRAIN_STEPS, profile_steps=MOE_PROFILE_STEPS,
              plan=2):
    """``cfg`` trained as ``python -m repro_torch.launch.train --mode pnn
    --stages 2 --batch 8 --seq 1024 --steps 8`` trains it (4 SIL steps, 4
    CE steps on the live prefix, 2 of recovery; ``batch`` x ``seq`` tokens
    a step, an encoder-decoder's frames or a vision config's image rows
    made on the card, ``device_frames``): ms per step, tokens/s, peak
    memory, launches (each kernel ``need`` names must be launched), the
    operations floor, and with experts the load-balance and z-losses of
    each phase's first and last step; then a profiled run of
    ``profile_steps`` (2 / 2 / 1; None: no profiled run): device ms, busy
    share and device time by family (with experts, their batched products
    apart), and the seconds the profile took to collect and read.
    ``steps`` and ``profile_steps`` are (SIL, live CE, recovery) steps, in
    the CLI's spec otherwise; ``plan`` what ``recipes.resolve_plan`` takes
    (2: the uniform split)."""
    from types import SimpleNamespace
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.lm import lm_batches, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import lm_spec
    from repro_torch.models import model as M
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import recipes
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    tokens = batch * seq
    frames_of = device_frames(torch, dev, cfg, batch)

    def run(counts, tracer):
        it = lm_batches(stream, batch, seq, seed=0)
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0))
        spec = lm_spec(SimpleNamespace(steps=4, lr=3e-4, accum=1,
                                       precision=None), 2)
        spec = dataclasses.replace(spec, stages=tuple(
            dataclasses.replace(st, steps=k)
            for st, k in zip(spec.stages, counts[:2])),
            recovery=dataclasses.replace(spec.recovery, steps=counts[2]))
        return recipes.run_lm_sequential(
            cfg, split, params, lambda i: {**next(it), **frames_of(i)},
            spec, torch.Generator(device=dev).manual_seed(1), device=dev,
            tracer=tracer)

    split = recipes.resolve_plan(cfg, plan)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracer, aux = Tracer(), []
    LAUNCHES.reset()
    t0 = time.perf_counter()
    with recording_aux(torch, aux) if cfg.moe else contextlib.nullcontext():
        joined, hist = run(steps, tracer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    phases, losses = hist.column("phase"), hist.column("loss")
    counts = {p: phases.count(p) for p in LM_PHASES}
    rows = phase_rows(tracer, counts, tokens)
    flops = lm_step_flops(cfg, split.bounds, batch, seq)
    log(f"  {cfg.name}: {cfg.n_layers} layers "
        f"({[k for k, _, _ in M.slot_spec(cfg)]} a group), 2 stages "
        f"{split.bounds}, batch "
        f"{batch} x {seq}, {cfg.dtype} compute, {cfg.param_dtype} "
        f"params; {len(losses)} AdamW steps in {wall:.1f}s (init and SIL "
        f"table included), peak {peak / 2**30:.2f} GiB, launches "
        f"{launches}")
    slots = pairs = None
    if cfg.moe:
        slots = moe_slots(cfg, tokens)
        pairs = tokens * cfg.moe.top_k
        log(f"    a layer's experts compute {slots} slots (E x C) for "
            f"{pairs} routed (token, pick) pairs: {pairs / slots:.1%} of "
            "them useful")
    for r in rows:
        r["bound_ms_per_step"] = 1e3 * flops[r["phase"]] / PEAK_FLOPS[
            "bfloat16"]
        extra = "" if r["ms_per_step"] is None else (
            f", {r['ms_per_step']:.1f} ms/step, "
            f"{r['samples_per_s']:.0f} tokens/s")
        log(f"    {r['phase']:12s} {r['wall_ms']:10.1f} ms, {r['steps']:5d} "
            f"steps{extra}; operations floor {flops[r['phase']] / 1e12:.1f}"
            f" TFLOP = {r['bound_ms_per_step']:.1f} ms/step at 989 TFLOP/s")
    lbz = torch.stack(aux).tolist() if aux else []
    require(len(lbz) == (len(losses) if cfg.moe else 0),
            f"{len(lbz)} aux records for {len(losses)} steps")
    for p in LM_PHASES:
        vals = [(loss, *lz) for ph, loss, lz in
                zip(phases, losses, lbz or [()] * len(losses)) if ph == p]
        log(f"    {p:9s} losses {[round(v[0], 4) for v in vals]}" + (
            f"; lb first {vals[0][1]:.4f} last {vals[-1][1]:.4f}, z first "
            f"{vals[0][2]:.4f} last {vals[-1][2]:.4f}" if lbz else ""))
    want = dict(zip(LM_PHASES, steps))
    require(counts == want, f"{cfg.name}: the phases ran {counts} steps, "
            f"not {want}")
    require(all(math.isfinite(v) for v in losses)
            and all(math.isfinite(v) for r in lbz for v in r),
            f"{cfg.name}: a loss or aux term is not finite")
    require(all(launches.get(k, 0) > 0 for k in need),
            f"the {cfg.name} train run launched none of some of {need}: "
            f"{launches}")
    with torch.no_grad():                 # the joined network is usable
        logits, _ = M.forward(cfg, joined, {"tokens": torch.arange(
            128, device=dev)[None], **device_frames(torch, dev, cfg, 1)(0)},
            remat=False)
    require(bool(torch.isfinite(logits.float()).all()),
            f"the joined {cfg.name} network's logits are not finite")
    del joined, hist, logits
    torch.cuda.empty_cache()
    out = {"batch": batch, "seq": seq, "bounds": split.bounds,
           "wall_s": wall, "peak_mem_bytes": peak, "launches": launches,
           "phases": rows, "losses": losses, "lb_z": lbz,
           "expert_slots": slots, "routed_pairs": pairs}
    if profile_steps is None:
        return out

    # a shorter run under the profiler: launches, device time and busy
    # share by phase, device time by family with the experts' products apart
    rt = Tracer()
    with ranged(rt), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        profile_lead(torch)
        _, ph = run(profile_steps, rt)
        profile_tail(torch)
        t_run = time.perf_counter()
    t_stop = time.perf_counter()
    events = raw_events(prof)
    t_read = time.perf_counter()
    prof_rows = profiled_phase_rows(events, rt, ph, flops, tokens)
    fam, by_name = event_families(events, experts=cfg.moe is not None)
    cost = {"stop_s": t_stop - t_run, "read_s": t_read - t_stop,
            "split_s": time.perf_counter() - t_read, "events": len(events)}
    log(f"    the profile: stopping and collecting {cost['stop_s']:.1f} s, "
        f"reading {cost['events']} events {cost['read_s']:.1f} s, splitting "
        f"them {cost['split_s']:.1f} s")
    for f, (ms, n) in sorted(fam.items(), key=lambda x: -x[1][0]):
        log(f"      {f:28s} {ms:10.2f} ms  {n:7d} launches")
    top = sorted(by_name.items(), key=lambda x: -x[1][0])[:MOE_TOP_KERNELS]
    log(f"    the {MOE_TOP_KERNELS} kernels with the most device time:")
    for name, (ms, n) in top:
        log(f"      {ms:10.2f} ms {n:7d}x  {name[:110]}")
    require(not cfg.moe or fam.get(EXPERT_FAMILY, (0, 0))[1] > 0,
            "the profile attributed no kernel to the experts' products")
    del ph, prof, events
    torch.cuda.empty_cache()
    out.update(profile=prof_rows, profile_cost=cost,
               profile_families={f: {"ms": ms, "launches": n}
                                 for f, (ms, n) in fam.items()},
               profile_top_kernels=[{"name": k, "ms": ms, "launches": n}
                                    for k, (ms, n) in top])
    return out


def stage0_sil_runs(torch, dev, cfg, steps, contexts, batch=LM_BATCH,
                    seq=LM_SEQ):
    """Stage 0's first ``steps`` SIL steps from the same params, SIL table
    and batches (``batch`` x ``seq`` tokens, an encoder-decoder's frames
    from ``device_frames``), once inside each context manager of
    ``contexts`` (made anew for each run): [(losses, trained params,
    launches)]."""
    from repro_torch.core import partition
    from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.optim import make_optimizer
    from repro_torch.train import LMBackend, StageSpec, TrainSpec
    from repro_torch.tree import tree_map
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    spec = TrainSpec(n_stages=2, kappa=1.0, stages=(StageSpec(
        steps=steps, lr=3e-4, optimizer="adamw"),) * 2)
    frames_of = device_frames(torch, dev, cfg, batch)
    be = LMBackend(cfg, partition.make_plan(cfg, 2),
                   lambda i: {**lm_batch_at(stream, batch, seq, i),
                              **frames_of(i)}, spec, device=dev)
    stage0 = be.split(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)))[0]
    sil = be.make_sils(torch.Generator(device=dev).manual_seed(1), 1.0)[0]
    runs = []
    for context in contexts:
        sp = tree_map(torch.clone, stage0)
        opt = make_optimizer("adamw", 3e-4)
        st = opt.init(be.trainable(sp))
        step = be.build_stage_step(0, opt, sil)
        losses = []
        LAUNCHES.reset()
        with context():
            for i in range(steps):
                b = be.batch_fn(i)
                sp, st, loss = step(sp, st, b, b["labels"])
                losses.append(loss.detach())
            torch.cuda.synchronize()
        runs.append((torch.stack(losses), sp, LAUNCHES.snapshot()))
        del st, opt
    del stage0, sil
    return runs


def repeat_gate(torch, dev, cfg, batch=LM_BATCH, seq=LM_SEQ,
                steps=MOE_REPEAT_STEPS):
    """Two identical runs of stage 0's first ``steps`` SIL steps from the
    same params, SIL table and batches: the losses and the trained params
    bit for bit (the MoE backward gathers each token's slot grads in a
    fixed order; the scan's backward sums its partials in a fixed order)."""
    runs = stage0_sil_runs(torch, dev, cfg, steps,
                           [contextlib.nullcontext] * 2, batch, seq)
    (la, pa, _), (lb, pb, _) = runs
    same = torch.equal(la, lb) and bitwise(torch, pa, pb)
    log(f"  repeat gate: two {steps}-step SIL runs of stage 0, "
        f"losses {la.tolist()} / {lb.tolist()}; losses and params bitwise "
        f"equal: {same}")
    require(same, f"two identical {cfg.name} SIL runs differ bitwise")
    del runs, pa, pb
    torch.cuda.empty_cache()
    return {"steps": steps, "losses": la.tolist(), "bitwise": same}


@contextlib.contextmanager
def plain_scan_backward():
    """The scan's backward kernel swapped, inside the block, for its plain
    version on the same device (``ref.selective_scan_bwd``, the gradient
    ``tests/test_torch_scan_bwd.py`` holds against ``jax.vjp`` and torch
    autograd of ``ref.selective_scan``); the forward stays the kernel.  A
    training run's h0 is None, so no dh0 is asked for."""
    from repro_torch.kernels.selective_scan import kernel as K
    from repro_torch.kernels.selective_scan import ref as R
    kernel_bwd = K.selective_scan_bwd_cuda

    def plain(u, dt, a, b, c, d, states, dy, *, dh_last=None,
              want_dh0=False):
        require(not want_dh0, "the plain backward run was asked for dh0")
        return R.selective_scan_bwd(u, dt, a, b, c, d, dy, dh_last=dh_last)
    K.selective_scan_bwd_cuda = plain
    try:
        yield
    finally:
        K.selective_scan_bwd_cuda = kernel_bwd


def plain_backward_run(torch, dev, cfg):
    """Stage 0's SIL steps of the train cut's left phase, from the same
    params, SIL table and batches, once through the scan's backward kernel
    and once through its plain version: whether the plain backward's losses
    follow the kernel's step by step (the first is the same forward)."""
    from repro_torch.tree import tree_leaves
    steps = MOE_TRAIN_STEPS[0]                 # the left phase's
    runs = stage0_sil_runs(torch, dev, cfg, steps,
                           [contextlib.nullcontext, plain_scan_backward])
    (lk, pk, nk), (lp, pp, np_) = runs
    kernel, plain = lk.tolist(), lp.tolist()
    rel = [abs(a - b) / abs(a) for a, b in zip(kernel, plain)]
    moved = max(((x.float() - y.float()).abs().max().item()
                 for x, y in zip(tree_leaves(pk), tree_leaves(pp))),
                default=0.0)
    log(f"  stage 0, {steps} SIL steps: the backward kernel's "
        f"losses {kernel}; the plain backward's {plain}; |kernel - plain| "
        f"/ |kernel| {[f'{r:.2e}' for r in rel]}; the trained params "
        f"differ by at most {moved:.3e}; backward launches "
        f"{nk.get('selective_scan_bwd', 0)} / "
        f"{np_.get('selective_scan_bwd', 0)}")
    require(nk.get("selective_scan_bwd", 0) == steps
            and np_.get("selective_scan_bwd", 0) == 0,
            f"the backward ran {nk} / {np_}: not one kernel a step, then "
            "the plain version alone")
    require(all(map(math.isfinite, kernel + plain)),
            "a loss of the plain backward comparison is not finite")
    require(kernel[0] == plain[0], "the first loss differs: the two runs "
            "did not start from the same forward")
    del runs, pk, pp
    torch.cuda.empty_cache()
    return {"steps": steps, "kernel_losses": kernel,
            "plain_losses": plain, "rel_diff": rel,
            "params_max_abs_diff": moved}


def phase_moe(torch, dev, report):
    from repro_torch.configs import get
    cfg = get(MOE_ARCH)
    out = report["moe"] = {}
    attn = ["flash_attention"]
    for part, fn in (
            ("serve", lambda: serve_cut(torch, dev, cfg, {
                "contiguous": attn + ["decode_attention"],
                "paged": attn + ["paged_decode_attention"]})),
            ("train", lambda: train_cut(torch, dev, cfg, (
                "flash_attention", "flash_attention_bwd", "sil_mse"))),
            ("repeat", lambda: repeat_gate(torch, dev, cfg))):
        t0 = time.perf_counter()
        out[part] = fn()
        log(f"   (moe {part}: {time.perf_counter() - t0:.1f}s)")


HYBRID_ARCH, HYBRID_LAYERS = "jamba-1.5-large-398b", 2
ATTENTION_KERNELS = ("flash_attention", "flash_attention_bwd",
                     "decode_attention", "paged_decode_attention")


def phase_hybrid(torch, dev, report):
    """Jamba-1.5-Large's 2-layer full-width cut, which has no attention
    layer: with its experts (Mamba + MoE, then Mamba + dense) served on
    both pools, without them (two 1-layer groups, one a stage) trained
    stage by stage, the bitwise repeat gate, and stage 0's left steps
    through the scan's backward kernel beside its plain version.  No run may launch an
    attention kernel; each trained Mamba layer's backward must run through
    the scan's backward kernel exactly once a step."""
    from repro_torch.configs import get
    full = get(HYBRID_ARCH)
    serve_cfg = full.replace(n_layers=HYBRID_LAYERS)
    train_cfg = full.replace(n_layers=HYBRID_LAYERS, moe=None)
    out = report["hybrid"] = {}
    for part, fn in (
            ("serve", lambda: serve_cut(torch, dev, serve_cfg, {
                "contiguous": ["selective_scan"],
                "paged": ["selective_scan"]})),
            ("train", lambda: train_cut(torch, dev, train_cfg, (
                "selective_scan", "selective_scan_bwd", "sil_mse"))),
            ("repeat", lambda: repeat_gate(torch, dev, train_cfg)),
            ("plain_backward", lambda: plain_backward_run(torch, dev,
                                                          train_cfg))):
        t0 = time.perf_counter()
        out[part] = fn()
        log(f"   (hybrid {part}: {time.perf_counter() - t0:.1f}s)")
    seen = [out["train"]["launches"]] + [
        r["launches"] for r in out["serve"]["runs"].values()]
    require(not any(ln.get(k, 0) for ln in seen for k in ATTENTION_KERNELS),
            f"the attention-free cut launched an attention kernel: {seen}")
    # trained Mamba layers a step: stage 0 (left), stage 1 (right), both
    # (recovery), one layer each
    want = 4 * 1 + 4 * 1 + 2 * 2
    got = out["train"]["launches"].get("selective_scan_bwd", 0)
    log(f"  the scan's backward kernel ran {got} times in the train run "
        f"(one a trained Mamba layer a step: {want})")
    require(got == want, f"selective_scan_bwd launched {got} times, not "
            f"{want}")
    report.setdefault("launches", {})["selective_scan_bwd"] = got


DENSE_TRAIN_ARCH, DENSE_SERVE_ARCH = "stablelm-3b", "chatglm3-6b"


def phase_dense(torch, dev, report):
    """The dense slice at full width: stablelm-3b (32 layers, d 2560, 32/32
    heads of 80, partial rotary, LayerNorm, SwiGLU, untied; 2.80 B seeded
    random params) served on both pools against its weights floor, then
    trained stage by stage as ``python -m repro_torch.launch.train --arch
    stablelm-3b --mode pnn --stages 2 --batch 8 --seq 1024 --steps 8``
    trains it (two stages of 16 layers, 4 SIL steps, 4 CE steps on the
    live prefix, 2 of recovery), the profiled 2 / 2 / 1 run and the bitwise
    repeat gate; chatglm3-6b (28 layers, d 4096, 32/2 heads of 128, half
    rotary, QKV bias; 6.24 B params) served on both pools.  Every attention
    launch of stablelm's runs is at head dim 80 and every decode launch of
    chatglm3's at 16 query heads a KV head; no profile may hold a kernel of
    PyTorch's fused attention (SDPA)."""
    from repro_torch.configs import get
    out = report["dense"] = {}
    serve_need = {"contiguous": ["flash_attention", "decode_attention"],
                  "paged": ["flash_attention", "paged_decode_attention"]}
    train_cfg, serve_cfg = get(DENSE_TRAIN_ARCH), get(DENSE_SERVE_ARCH)
    require((train_cfg.hd, serve_cfg.q_per_kv) == (80, 16),
            "the dense phase's models no longer reach D 80 and G 16")
    for part, fn in (
            ("serve", lambda: serve_cut(torch, dev, train_cfg, serve_need)),
            ("train", lambda: train_cut(torch, dev, train_cfg, (
                "flash_attention", "flash_attention_bwd", "sil_mse"))),
            ("repeat", lambda: repeat_gate(torch, dev, train_cfg)),
            ("serve " + DENSE_SERVE_ARCH,
             lambda: serve_cut(torch, dev, serve_cfg, serve_need))):
        t0 = time.perf_counter()
        out[part] = fn()
        log(f"   (dense {part}: {time.perf_counter() - t0:.1f}s)")
    serves = [out["serve"], out["serve " + DENSE_SERVE_ARCH]]
    families = {f for sv in serves for r in sv["runs"].values()
                if "profile" in r for f in r["profile"]["families"]}
    families |= set(out["train"]["profile_families"])
    require(SDPA_FAMILY not in families,
            f"a dense profile holds an SDPA kernel: {sorted(families)}")
    log(f"  no SDPA kernel in the profiles; attention launches at D 80 "
        f"({DENSE_TRAIN_ARCH}): "
        f"{[r['launches'] for r in serves[0]['runs'].values()]}, train "
        f"{out['train']['launches']}; at G 16 ({DENSE_SERVE_ARCH}): "
        f"{[r['launches'] for r in serves[1]['runs'].values()]}")


# Whisper's published decoder context (448 tokens) against 30 s of audio
# (1500 frames), 32 such segments a step
WHISPER_BATCH, WHISPER_SEQ = 32, WHISPER_DEC


def whisper_requests(cfg, GenerationConfig, Request):
    """Speech recognition's traffic: 8 greedy and 2 sampled requests, short
    prompts (4-64 tokens), 32-128 new tokens, each with its own (1500, 384)
    frames of a 30 s segment from a seeded generator."""
    import numpy as np
    rng = np.random.RandomState(0)
    greedy = [(4, 32), (8, 48), (16, 64), (24, 128), (32, 40), (40, 96),
              (56, 72), (64, 128)]
    reqs = [Request(tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
                    gen=GenerationConfig(max_new_tokens=nn), id=f"g{i}",
                    frames=request_frames(cfg, rng))
            for i, (ln, nn) in enumerate(greedy)]
    for i, (ln, nn) in enumerate(((12, 64), (48, 96))):
        reqs.append(Request(
            tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
            gen=GenerationConfig(max_new_tokens=nn, temperature=0.8,
                                 top_k=50, top_p=0.95, seed=100 + i),
            id=f"s{i}", frames=request_frames(cfg, rng)))
    return reqs


def serve_whisper(torch, dev, cfg):
    """whisper-tiny from seeded random weights served as ``serve_model``
    serves (both pools, greedy tokens equal) on ``whisper_requests``.  An
    admission group's prefill makes one ``flash_attention`` launch a layer
    each for the encoder's self-attention, the decoder's and its cross-
    attention (3 x 4); a decode step one attention launch a decoder layer
    for the self cache (``decode_attention``, or ``paged_decode_attention``
    on the paged pool) and one ``decode_attention`` over the 1500 cross
    slots (2 x 4).  The decode floor reads the decoder's bf16 weights (its
    layers, the final norm and the untied unembedding; not the encoder, nor
    more than a row of the input and position tables) and every slot's
    cross K/V once."""
    from repro_torch.models import model as M
    from repro_torch.serve import GenerationConfig, Request
    from repro_torch.tree import tree_leaves
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"  {cfg.name}: {cfg.enc_layers} encoder + {cfg.n_layers} decoder "
        f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.hd}, {cfg.enc_seq} frames, vocab {cfg.vocab_padded} untied; "
        f"{n / 1e6:.2f} M random {cfg.param_dtype} params")
    attn = ["flash_attention"]
    runs, sampled_equal = serve_model(
        torch, dev, cfg, params,
        {"contiguous": attn + ["decode_attention"],
         "paged": attn + ["decode_attention", "paged_decode_attention"]},
        profile_tokens=16,
        reqs=whisper_requests(cfg, GenerationConfig, Request))
    layers = cfg.n_layers
    for label, r in runs.items():
        ln, steps, admits = r["launches"], r["decode_steps"], \
            r["admit_groups"]
        want = {"flash_attention": 3 * layers * admits}
        if label == "paged":
            want.update(decode_attention=layers * steps,
                        paged_decode_attention=layers * steps)
        else:
            want.update(decode_attention=2 * layers * steps)
        got = {k: ln.get(k, 0) for k in want}
        log(f"  {label}: {admits} admission groups, {steps} decode steps: "
            f"attention launches {got} (expected {want})")
        require(got == want, f"{cfg.name} {label} attention launches {got}, "
                f"expected {want}")
    decoder = {k: params[k] for k in ("groups", "final_norm", "unembed")}
    weights = 2 * sum(t.numel() for t in tree_leaves(decoder))
    cross = 2 * 2 * layers * 8 * cfg.enc_seq * cfg.n_kv_heads * cfg.hd
    log(f"  cross K/V a decode step reads at 8 slots: {cross / 1e6:.1f} MB;"
        f" every bf16 weight (the encoder's and the tables' too) "
        f"{2 * n / 1e6:.1f} MB")
    out = {"params": n, "runs": runs, "sampled_equal": sampled_equal,
           "bf16_weight_bytes": 2 * n,
           "all_weights_ms_per_step": 1e3 * 2 * n / HBM_BYTES_PER_S,
           "decoder_bf16_weight_bytes": weights, "cross_kv_bytes": cross,
           "weights_bound_ms_per_step": log_weights_bound(cfg,
                                                          weights + cross)}
    del params
    torch.cuda.empty_cache()
    return out


def phase_whisper(torch, dev, report):
    """whisper-tiny at full width (4 encoder and 4 decoder layers, d 384,
    6/6 heads of 64, 1500 frames, LayerNorm, GELU, learned decoder
    positions; 69.04 M seeded random params): served on both pools
    (``serve_whisper``), then trained stage by stage at B32 x S448 with
    1500 frames a request (two stages of 2 decoder layers, the encoder in
    stage 0; 4 SIL steps on the 384 x 51,968 table, 4 CE steps on the live
    prefix, 2 of recovery; AdamW, bf16 compute, fp32 params), the profiled
    2 / 2 / 1 run and the bitwise repeat gate.  Every attention of these
    runs goes through the hand-written kernels: the encoder's and the
    cross-attention's non-causal prefill and backward at 1500 keys, decode
    over the 1500 cross slots; no profile may hold an SDPA kernel."""
    from repro_torch.configs import get
    cfg = get(WHISPER_ARCH)
    out = report["whisper"] = {}
    for part, fn in (
            ("serve", lambda: serve_whisper(torch, dev, cfg)),
            ("train", lambda: train_cut(torch, dev, cfg, (
                "flash_attention", "flash_attention_bwd", "sil_mse"),
                WHISPER_BATCH, WHISPER_SEQ)),
            ("repeat", lambda: repeat_gate(torch, dev, cfg, WHISPER_BATCH,
                                           WHISPER_SEQ))):
        t0 = time.perf_counter()
        out[part] = fn()
        log(f"   (whisper {part}: {time.perf_counter() - t0:.1f}s)")
    want = whisper_train_launches(cfg)
    got = {k: out["train"]["launches"].get(k, 0) for k in want}
    log(f"  train launches {got} (expected {want})")
    require(got == want, f"whisper train launches {got}, expected {want}")
    families = {f for r in out["serve"]["runs"].values() if "profile" in r
                for f in r["profile"]["families"]}
    families |= set(out["train"]["profile_families"])
    require(SDPA_FAMILY not in families,
            f"a whisper profile holds an SDPA kernel: {sorted(families)}")
    log("  no SDPA kernel in the whisper profiles")


XLSTM_ARCH = "xlstm-125m"
# the (SIL, live CE, recovery) steps of the timed train run (the CLI's
# --steps 4 gives 2 / 2 / 1, cut for time: 5-11 s a step on the host), and
# the repeat gate's SIL steps; no profiled train run: a profiled step makes
# 2-4 x 10^5 launches, whose events took ~85 s to collect and read, cut for
# the llava phase's time
XLSTM_TRAIN_STEPS, XLSTM_PROFILE_STEPS, XLSTM_REPEAT_STEPS = (1, 1, 1), \
    None, 1
SCAN_KERNELS = ("selective_scan", "selective_scan_bwd")


def phase_xlstm(torch, dev, report):
    """xlstm-125m at full width (12 layers alternating mLSTM and sLSTM, d
    768, 4 heads, d_up 1536, chunk 64, LayerNorm, no FFN, a tied 50,304
    vocabulary; 123.6 M seeded random params): served as the moe phase
    serves granite (``serve_cut``: its floor reads the weights, ``r`` and
    the gates fp32, and reads and writes the 114 MB of state at 8 slots),
    then trained stage by stage at B8 x S1024 as
    ``python -m repro_torch.launch.train --arch xlstm-125m --mode pnn
    --stages 2 --batch 8 --seq 1024 --steps 4`` trains it, cut to one step
    a phase (two stages of 3 groups, a SIL step on the 768 x 50,304 table,
    a CE step on the live prefix, one of recovery; AdamW, bf16 compute, fp32 params; no profiled
    run, ``XLSTM_PROFILE_STEPS``) and the bitwise repeat gate.  The reference computes
    xLSTM without a kernel: no run may launch an attention or scan kernel,
    and the SIL-MSE kernel runs once a SIL step."""
    from repro_torch.configs import get
    cfg = get(XLSTM_ARCH)
    out = report["xlstm"] = {}
    for part, fn in (
            ("serve", lambda: serve_cut(torch, dev, cfg, {"contiguous": [],
                                                          "paged": []})),
            ("train", lambda: train_cut(torch, dev, cfg, ("sil_mse",),
                                        steps=XLSTM_TRAIN_STEPS,
                                        profile_steps=XLSTM_PROFILE_STEPS)),
            ("repeat", lambda: repeat_gate(torch, dev, cfg,
                                           steps=XLSTM_REPEAT_STEPS))):
        t0 = time.perf_counter()
        out[part] = fn()
        log(f"   (xlstm {part}: {time.perf_counter() - t0:.1f}s)")
    seen = [out["train"]["launches"]] + [
        r["launches"] for r in out["serve"]["runs"].values()]
    require(not any(ln.get(k, 0) for ln in seen
                    for k in ATTENTION_KERNELS + SCAN_KERNELS),
            f"an xLSTM run launched an attention or scan kernel: {seen}")
    sil = out["train"]["launches"].get("sil_mse", 0)
    want = XLSTM_TRAIN_STEPS[0]
    log(f"  launches of the port's kernels: serve {seen[1:]}, train "
        f"{seen[0]} (SIL-MSE once a SIL step: {want})")
    require(sil == want, f"sil_mse launched {sil} times in {want} SIL steps")


def whisper_train_launches(cfg, left=4, right=4, recovery=2):
    """The attention launches of the whisper train run: an encoder layer
    runs once forward (no remat) and once backward where stage 0 trains; a
    decoder layer's two attentions (self and cross) run forward twice
    (remat) and backward once where a gradient passes through it, forward
    once in a frozen prefix.  Stage 0: the encoder and 2 decoder layers,
    stage 1: 2 decoder layers; the SIL-MSE kernel once a SIL step."""
    enc, dec = cfg.enc_layers, cfg.n_layers // 2
    trained = {"fwd": enc + 2 * 2 * dec, "bwd": enc + 2 * dec}   # stage 0
    stage1 = {"fwd": 2 * 2 * dec, "bwd": 2 * dec}
    prefix = enc + 2 * dec
    fwd = left * trained["fwd"] + right * (prefix + stage1["fwd"]) \
        + recovery * (trained["fwd"] + stage1["fwd"])
    bwd = left * trained["bwd"] + right * stage1["bwd"] \
        + recovery * (trained["bwd"] + stage1["bwd"])
    return {"flash_attention": fwd, "flash_attention_bwd": bwd,
            "sil_mse": left}


# llava-next-34b (hf:llava-hf/llava-v1.6-mistral-7b-hf): 60 layers, d 7168,
# 56 query heads on 8 KV heads of 128 (G 7, the first odd group above 1 on
# the card), 2,880 image rows (anyres: 4 tiles + the base, 576 patches
# each) before every request's text.  Served at full width and depth on 2
# slots: 4 requests, prompts of 64-512 text tokens (2,944-3,392 rows a
# prefill, the longest in the port; 3,080 and 3,213 end in ragged tiles),
# 32 new tokens each.  Trained: a 4-layer full-width cut, 2 stages on the
# plan ``make_plan(strategy="auto")`` searched, at B1 x 512 text tokens
# plus the 2,880 image rows (2 SIL steps, 2 CE steps on the live prefix, 1
# of recovery, a profiled 1 / 1 / 1 run).
LLAVA_ARCH = "llava-next-34b"
LLAVA_H, LLAVA_KV = 56, 8
LLAVA_IMAGE, LLAVA_TEXT = 2880, 512
LLAVA_LAYER = (1, LLAVA_IMAGE + LLAVA_TEXT, LLAVA_H, LLAVA_KV, D)
LLAVA_RAGGED = LLAVA_IMAGE + 333              # 3213 = 50 * 64 + 13
LLAVA_PROMPTS, LLAVA_NEW, LLAVA_SLOTS = (64, 200, 333, 512), 32, 2
# decode over the serve run's caches: two requests, at the last position of
# the shortest and the longest (2880 + 64 + 31, 2880 + 512 + 31) in a
# 3,456-slot cache (216 blocks of 16)
LLAVA_DECODE_POS, LLAVA_LC = (2975, 3423), 3456
# the train cut's stage-0 SIL: 512 text rows, d 7168, 64,000 classes
SIL_LLAVA = (LLAVA_TEXT, 7168, 64000)
LLAVA_TRAIN_LAYERS = 4
LLAVA_TRAIN_STEPS, LLAVA_PROFILE_STEPS = (2, 2, 1), (1, 1, 1)
# what earlier phases may leave allocated on the card when this one starts
# (the kernels' workspaces); the serve run needs ~70 of its 80 GB
LLAVA_HELD_BYTES = 2**30


@contextlib.contextmanager
def recording_sil_rows(out):
    """While in effect, every SIL stage loss (``losses.sil_stage_loss``)
    appends the shapes of its boundary and its labels to ``out``."""
    from repro_torch.core import losses
    inner = losses.sil_stage_loss

    def recorded(boundary_act, sil, labels):
        out.append((tuple(boundary_act.shape), tuple(labels.shape)))
        return inner(boundary_act, sil, labels)
    losses.sil_stage_loss = recorded
    try:
        yield out
    finally:
        losses.sil_stage_loss = inner


def llava_kernels(torch, dev, report):
    """Every kernel of the llava paths against its plain version at their
    shapes (G 7): the prefill with its lse at the train cut's B1 S3392, and
    the serve prefill there and at a ragged S3213; the backward at B1
    S3392; decode and paged decode at B2 over 3,456 slots (paged ==
    contiguous, bitwise); SIL-MSE at T512 d7168 M64,000 in fp32 and bf16.
    Then each timed beside its plain version, the library call (SDPA with
    GQA, its backward) and its bound.  The worst errors join the report's
    ``max_abs_err``."""
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {k: 0.0 for k in KERNELS}
    rel_errs = {k: {} for k in KERNELS}
    checks = []
    check = kernel_checker(errs, rel_errs, checks)
    b, s, h, kv, d = LLAVA_LAYER
    checks += check_prefill_lse(torch, dev, gen, check, cases=[
        ((b, s, s, h, kv, d), "bfloat16", True),
        ((1, LLAVA_RAGGED, LLAVA_RAGGED, h, kv, d), "bfloat16", True)])
    checks += check_attention_bwd(torch, dev, errs, rel_errs, cases=[
        ((b, s, s, h, kv, d), "bfloat16", 0, True)])
    check_decode(torch, dev, gen, check, torch.bfloat16, h, kv, d,
                 LLAVA_DECODE_POS, LLAVA_LC)
    checks += check_sil_mse(torch, dev, errs, rel_errs, cases=[
        ("LM SIL llava-next-34b", SIL_LLAVA, None)])
    worst = report.setdefault("max_abs_err", {})
    for k, e in errs.items():
        worst[k] = max(worst.get(k) or 0.0, e)
    report.setdefault("kernel_checks", []).extend(checks)
    torch.cuda.empty_cache()
    timing = {
        "flash_attention@llava_lse": time_prefill(
            torch, dev, gen, b, s, s, h, kv, d, True, True),
        "flash_attention_bwd@llava": time_attention_bwd(
            torch, dev, gen, b, s, s, h, kv, d, True)}
    timing["decode_attention@llava"], \
        timing["paged_decode_attention@llava"] = time_decode(
            torch, dev, gen, h, kv, d, LLAVA_LC, LLAVA_DECODE_POS)
    timing.update(time_sil_mse(torch, dev, gen, cases=[
        ("sil_mse@llava", SIL_LLAVA, torch.bfloat16)]))
    finish_timing(timing)
    c, p = timing["decode_attention@llava"], \
        timing["paged_decode_attention@llava"]
    log(f"  paged / contiguous decode at G 7, device time: "
        f"{p['device_ms'] / c['device_ms']:.3f}")
    torch.cuda.empty_cache()
    return {"checks": checks, "max_abs_err": errs,
            "max_row_rel_err": rel_errs, "timing": timing}


def llava_requests(torch, dev, cfg, GenerationConfig, Request):
    """4 greedy requests, prompts of ``LLAVA_PROMPTS`` text tokens and
    ``LLAVA_NEW`` new tokens, each with its own (2880, 7168) fp32 image
    rows drawn on the card from a seed (x 0.02, as the reference's tests
    draw them)."""
    import numpy as np
    rng = np.random.RandomState(0)
    g = torch.Generator(device=dev).manual_seed(0)
    return [Request(tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
                    gen=GenerationConfig(max_new_tokens=LLAVA_NEW),
                    id=f"v{i}", image_embeds=torch.randn(
                        (cfg.vision_tokens, cfg.d_model), generator=g,
                        device=dev) * 0.02)
            for i, ln in enumerate(LLAVA_PROMPTS)]


def serve_llava(torch, dev, cfg):
    """llava-next-34b at full width and depth from seeded random bf16
    weights (34.44 B params, 68.88 GB) served as ``serve_model`` serves, on
    ``LLAVA_SLOTS`` slots (greedy tokens equal across the pools), on
    ``llava_requests``: an admission group's prefill makes one
    ``flash_attention`` launch a layer, a decode step one attention launch
    a layer (``decode_attention``, or ``paged_decode_attention`` on the
    paged pool).  The decode floor: every bf16 weight read once (20.6 ms
    at 3.35 TB/s); beside it, the weights but the input table (a step reads
    a row a request of it) and both slots' K/V at the longest request."""
    from repro_torch.models import model as M
    from repro_torch.precision import tree_bytes
    from repro_torch.serve import GenerationConfig, Request
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    weights = tree_bytes(params)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd} (G "
        f"{cfg.q_per_kv}), {cfg.vision_tokens} image rows, vocab "
        f"{cfg.vocab_padded} untied; {n / 1e9:.3f} B random "
        f"{cfg.param_dtype} params ({weights / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f}s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    reqs = llava_requests(torch, dev, cfg, GenerationConfig, Request)
    runs, _ = serve_model(
        torch, dev, cfg, params,
        {"contiguous": ["flash_attention", "decode_attention"],
         "paged": ["flash_attention", "paged_decode_attention"]},
        profile_tokens=8, reqs=reqs, max_slots=LLAVA_SLOTS)
    for label, r in runs.items():
        log(f"  {label}: TTFT a request (ms, in request order) "
            f"{[round(t, 1) for t in r['ttft_ms']]}")
        ln, steps, admits = r["launches"], r["decode_steps"], \
            r["admit_groups"]
        dec = "paged_decode_attention" if label == "paged" \
            else "decode_attention"
        want = {"flash_attention": cfg.n_layers * admits,
                dec: cfg.n_layers * steps}
        got = {k: ln.get(k, 0) for k in want}
        log(f"  {label}: {admits} admission groups, {steps} decode steps: "
            f"attention launches {got} (expected {want})")
        require(got == want, f"{cfg.name} {label} attention launches {got}, "
                f"expected {want}")
    read = weights - tree_bytes([params["tok_embed"]])
    longest = LLAVA_IMAGE + max(LLAVA_PROMPTS) + LLAVA_NEW
    kv_bytes = 2 * 2 * cfg.n_layers * LLAVA_SLOTS * longest \
        * cfg.n_kv_heads * cfg.hd
    out = {"params": n, "runs": runs, "weight_bytes": weights,
           "all_weights_ms_per_step": 1e3 * weights / HBM_BYTES_PER_S,
           "kv_bytes_longest": kv_bytes,
           "weights_bound_ms_per_step": 1e3 * (read + kv_bytes)
           / HBM_BYTES_PER_S}
    log(f"  decode floor: every bf16 weight read once {weights / 1e9:.2f} GB"
        f" -> {out['all_weights_ms_per_step']:.3f} ms at 3.35 TB/s; the "
        f"weights but the input table {read / 1e9:.2f} GB and both slots' "
        f"K/V at {longest} rows {kv_bytes / 1e9:.3f} GB -> "
        f"{out['weights_bound_ms_per_step']:.3f} ms")
    del params, reqs
    torch.cuda.empty_cache()
    return out


def train_llava(torch, dev, cfg):
    """llava-next-34b cut to ``LLAVA_TRAIN_LAYERS`` layers at full width
    (3.20 B params), trained by ``train_cut`` at B1 x 512 text tokens with
    2,880 image rows a sequence on the plan ``make_plan(cfg, 2,
    strategy="auto")`` searched (printed beside the uniform split).  Every
    SIL step's loss reads the 512 text rows alone (``recording_sil_rows``);
    the attention launches are exact: a trained layer forward twice
    (remat) and backward once, a prefix layer forward once, a layer that
    only passes the gradient on (stage 1 in recovery) forward twice and
    backward once."""
    from repro_torch.core import partition
    cut = cfg.replace(n_layers=LLAVA_TRAIN_LAYERS)
    auto = partition.make_plan(cut, 2, strategy="auto")
    uniform = partition.make_plan(cut, 2)
    log(f"  plan: make_plan(strategy='auto') bounds {auto.bounds}, the "
        f"uniform split {uniform.bounds}")
    rows = []
    with recording_sil_rows(rows):
        out = train_cut(torch, dev, cut, (
            "flash_attention", "flash_attention_bwd", "sil_mse"), 1,
            LLAVA_TEXT, steps=LLAVA_TRAIN_STEPS,
            profile_steps=LLAVA_PROFILE_STEPS, plan=auto)
    text = ((1, LLAVA_TEXT, cut.d_model), (1, LLAVA_TEXT))
    log(f"  SIL losses read boundaries and labels of {sorted(set(rows))} "
        f"(the text rows: {text})")
    require(rows and all(r == text for r in rows),
            f"a SIL loss read other rows than the text's: {sorted(set(rows))}")
    (a0, a1), (b0, b1) = auto.bounds
    n0, n1 = a1 - a0, b1 - b0
    left, right, rec = LLAVA_TRAIN_STEPS
    want = {"flash_attention": left * 2 * n0 + right * (n0 + 2 * n1)
            + rec * 2 * (n0 + n1),
            "flash_attention_bwd": left * n0 + right * n1 + rec * (n0 + n1),
            "sil_mse": left}
    got = {k: out["launches"].get(k, 0) for k in want}
    log(f"  train launches {got} (expected {want})")
    require(got == want, f"llava train launches {got}, expected {want}")
    out.update(auto_bounds=auto.bounds, uniform_bounds=uniform.bounds,
               sil_rows=sorted(set(rows)))
    return out


def phase_llava(torch, dev, report):
    """llava-next-34b: the kernels at its G-7 shapes (``llava_kernels``),
    served at full width and depth with 2,880 image rows a request on both
    pools (``serve_llava``), and its 4-layer full-width cut trained stage
    by stage on the searched plan (``train_llava``).  The phase first
    fails if earlier phases still hold more than ``LLAVA_HELD_BYTES`` on
    the card: the served weights take 68.88 of its 80 GB."""
    from repro_torch.configs import get
    cfg = get(LLAVA_ARCH)
    require((cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vision_tokens) == (
        LLAVA_H, LLAVA_KV, D, LLAVA_IMAGE),
        "the llava phase's shapes no longer match llava-next-34b's")
    out = report["llava"] = {}
    held = torch.cuda.memory_allocated()
    log(f"  held on the card by earlier phases: {held / 2**20:.1f} MiB "
        f"(at most {LLAVA_HELD_BYTES / 2**20:.0f})")
    require(held <= LLAVA_HELD_BYTES, f"earlier phases still hold "
            f"{held / 2**30:.2f} GiB on the card")
    out["held_bytes"] = held
    for part, fn in (("kernels", lambda: llava_kernels(torch, dev, report)),
                     ("serve", lambda: serve_llava(torch, dev, cfg)),
                     ("train", lambda: train_llava(torch, dev, cfg))):
        t0 = time.perf_counter()
        out[part] = fn()
        log(f"   (llava {part}: {time.perf_counter() - t0:.1f}s)")
        held = torch.cuda.memory_allocated()
        require(held <= LLAVA_HELD_BYTES, f"the llava {part} run left "
                f"{held / 2**30:.2f} GiB allocated")


def reference_llava(torch, dev):
    """llava-next-34b's smoke config (2 layers, d 256, 4/2 heads of 64, 16
    image rows) at fp32 on the card against the CPU (``reference_lm``:
    prefill and decode logits after the image rows, greedy engine tokens
    on both pools, each request with its own image rows)."""
    from repro_torch.configs import get
    tag = "smoke llava"
    worst, launches = reference_lm(
        torch, dev, get(LLAVA_ARCH, smoke=True).replace(dtype="float32"), tag)
    require(all(launches.get(k, 0) > 0 for k in (
        "flash_attention", "decode_attention", "paged_decode_attention")),
        f"{tag}: the card's runs missed an attention kernel: {launches}")
    return {"logits_max_abs_err": worst, "launches": launches}


# -- phase 17 ------------------------------------------------------------------

# the chaos matrix: ``launch.chaos``'s full preset (the paper MLP at full
# width, 2 stages, 6 ticks, every cell)
CHAOS_PRESET = "full"
# qwen2-1.5b at full width cut to 4 of its 28 layers (2 stages of 2), B8 x
# S1024, AdamW as ``lm_parallel_spec``; 4 ticks without faults, then under
# the supervisor: checkpoints every 2 ticks (the executor keeps 2 a stage)
# and a fixed schedule of one fault of each recoverable kind
SUPERVISED_LAYERS, SUPERVISED_TICKS = 4, 4
SUPERVISED_CKPT_EVERY, SUPERVISED_KEEP = 2, 2
# kernel launches a stage tick, per layer of the stage: each forward twice
# (remat) and backward once; SIL-MSE once a tick of stage 0 (stage 1 trains
# with CE)
SUPERVISED_LAUNCHES = {"flash_attention": 2, "flash_attention_bwd": 1}
LOST_STATE = ("crash", "ckpt_corruption")


def supervised_schedule():
    from repro_torch.resilience import (CheckpointCorruption, FaultSchedule,
                                        StageCrash, StragglerDelay,
                                        TransientError)
    return FaultSchedule([TransientError(0, 1, failures=2),
                          StragglerDelay(1, 1, 0.7), StageCrash(1, 3),
                          CheckpointCorruption(0, 3, "truncate_manifest")])


def chaos_matrix(torch, dev):
    """``launch.chaos.run_matrix`` at the full preset on the card: every
    cell ok, no unrecovered fault, no fault that never fired, SIL-MSE
    launched (counts zeroed just before, read just after)."""
    import shutil
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import chaos
    root = ROOT / "build" / "chaos"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    try:
        rep = chaos.run_matrix(CHAOS_PRESET, 0, str(root), device=dev)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    for c in rep["cells"]:
        log(f"    {c['cell']:36s} ok {c['ok']}  {c['seconds']:.2f}s  seen "
            f"{c['faults_seen']}  ticks {c['final_ticks']}")
    bad = [c["cell"] for c in rep["cells"] if not c["ok"]
           or c["unrecovered"] or c["never_fired"]]
    log(f"  chaos matrix ({CHAOS_PRESET}: the paper MLP at full width, 2 "
        f"stages, {rep['n_ticks']} ticks): {rep['n_passed']}/"
        f"{rep['n_cells']} cells ok in {wall:.1f}s, "
        f"{rep['n_unrecovered_faults']} unrecovered; launches {launches}")
    require(not bad and rep["n_passed"] == rep["n_cells"],
            f"chaos cells not ok: {bad}")
    require(launches.get("sil_mse", 0) > 0,
            f"the chaos matrix launched no SIL-MSE kernel: {launches}")
    return {"seconds": wall, "launches": launches,
            "cells": [{k: c[k] for k in ("cell", "ok", "seconds",
                                         "faults_seen", "final_ticks")}
                      for c in rep["cells"]]}


class RecoveryClock:
    """Wall time of the supervisor's recoveries, read from its event tuples
    (``_emit``), its restores (``_try_restore``) and its saves
    (``StageExecutor.checkpoint``), each wrapped on the instance.  A lost
    stage's recovery runs from its fault until the stage is back at the
    faulted tick (synced there), split into the restore (bytes read, GB/s)
    and the replay after it; the other stage's ticks meanwhile are
    counted."""

    def __init__(self, torch, sup):
        from repro_torch.plan import tree_param_bytes
        self.torch, self.ex = torch, sup.ex
        self.open, self.done, self.saves = {}, [], []
        self.stage_ticks = [0] * sup.ex.n
        emit, restore, save = sup._emit, sup._try_restore, sup.ex.checkpoint

        def _emit(*event):
            emit(*event)
            self.on_event(event)

        def _try_restore(k):
            t0 = time.perf_counter()
            ok = restore(k)
            torch.cuda.synchronize()
            rec = self.open.get(k)
            if rec is not None and ok:
                rec["restore_s"] = time.perf_counter() - t0
                rec["restore_bytes"] = tree_param_bytes(
                    {"params": self.ex.params[k],
                     "opt": self.ex.opt_states[k]})
                rec["restored_tick"] = self.ex.ticks[k]
                rec["t_restored"] = time.perf_counter()
                self.close_if_back(k)
            return ok

        def checkpoint(stages=None):
            t0 = time.perf_counter()
            save(stages=stages)
            self.saves.append((list(stages or range(self.ex.n)),
                               time.perf_counter() - t0))

        sup._emit, sup._try_restore = _emit, _try_restore
        sup.ex.checkpoint = checkpoint

    def on_event(self, event):
        kind = event[0]
        if kind == "fault" and event[1] in LOST_STATE:
            _, what, k, i = event[:4]
            self.open[k] = {"fault": what, "stage": k, "tick": i,
                            "t0": time.perf_counter(), "other_ticks": 0}
        elif kind == "tick":
            _, k, i = event
            self.stage_ticks[k] += 1
            for j, rec in self.open.items():
                if j != k:
                    rec["other_ticks"] += 1
            self.close_if_back(k)

    def close_if_back(self, k):
        """Stage k's recovery ends where its restored state has replayed
        up to the faulted tick."""
        rec = self.open.get(k)
        if rec is None or "t_restored" not in rec \
                or self.ex.ticks[k] != rec["tick"]:
            return
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        del self.open[k]
        rec["recover_s"] = t - rec.pop("t0")
        rec["replay_s"] = t - rec.pop("t_restored")
        rec["wait_s"] = rec["recover_s"] - rec["restore_s"] \
            - rec["replay_s"]
        self.done.append(rec)


def supervised_lm(torch, dev, cfg, batch, seq, ticks, root):
    """``cfg`` trained by Fig. 5 for ``ticks`` ticks through the
    ``StageExecutor`` on ``dev``, without faults and then under the
    ``SupervisedExecutor`` (``FakeClock``, checkpoints under ``root``) with
    ``supervised_schedule``.  Returns the numbers and gates' inputs."""
    import shutil
    from repro_torch.core import partition
    from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
    from repro_torch.dist import StageExecutor, round_robin
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.plan import tree_param_bytes
    from repro_torch.resilience import (FakeClock, RetryPolicy,
                                        SupervisedExecutor)
    from repro_torch.train.backends import LMBackend, make_optimizer_for
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    spec = lm_parallel_spec(ticks)
    plan = partition.make_plan(cfg, 2)
    be = LMBackend(cfg, plan,
                   lambda i: lm_batch_at(stream, batch, seq, i), spec,
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = be.split(M.init_params(cfg, gen))
    sils = be.make_sils(gen, 1.0)
    hps = [spec.stage(k) for k in range(2)]

    def make(ckpt_dir=None):
        return StageExecutor(be, round_robin(2, [dev]), stages, sils,
                             [make_optimizer_for(hp, spec) for hp in hps],
                             hps, ckpt_dir=ckpt_dir,
                             ckpt_keep_last=SUPERVISED_KEEP)

    out = {"n_params": sum(tree_param_bytes(s, 1) for s in stages),
           "stage_layers": [b1 - b0 for b0, b1 in plan.bounds]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    ref = make().run(ticks)
    torch.cuda.synchronize()
    out["fault_free_s"] = time.perf_counter() - t0
    out["fault_free_launches"] = LAUNCHES.snapshot()
    # the disk the supervisor needs: two kept ticks of each stage, and the
    # temporary archive of the save in flight
    stage_bytes = [tree_param_bytes({"params": ref.params[k],
                                     "opt": ref.opt_states[k]})
                   for k in range(2)]
    need = SUPERVISED_KEEP * sum(stage_bytes) + max(stage_bytes)
    shutil.rmtree(root, ignore_errors=True)
    Path(root).mkdir(parents=True)
    free = shutil.disk_usage(root).free
    out.update(stage_bytes=stage_bytes, disk_need=need, disk_free=free)
    log(f"  checkpoints: stages of {[round(b / 1e9, 3) for b in stage_bytes]}"
        f" GB, {need / 1e9:.2f} GB needed on the disk, {free / 1e9:.1f} GB "
        f"free under {root}")
    require(free >= need, f"{free} bytes free under {root}, the supervised "
            f"run needs {need}")
    clk = FakeClock()
    schedule = supervised_schedule()
    ex = make(str(root))
    sup = SupervisedExecutor(ex, schedule=schedule, clock=clk.monotonic,
                             sleep=clk.sleep,
                             ckpt_every=SUPERVISED_CKPT_EVERY,
                             policy=RetryPolicy(max_retries=4), strict=True)
    rc = RecoveryClock(torch, sup)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    try:
        sup.run(ticks)
        torch.cuda.synchronize()
        out["supervised_s"] = time.perf_counter() - t0
        out["launches"] = LAUNCHES.snapshot()
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["report"] = sup.report()
        out["bitwise_params"] = bitwise(torch, ref.params, ex.params)
        out["bitwise_opt"] = bitwise(torch, ref.opt_states, ex.opt_states)
        out["bitwise_gather"] = bitwise(torch, ref.gather(), ex.gather())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(recoveries=rc.done, open_recoveries=list(rc.open),
               stage_ticks=rc.stage_ticks, saves=rc.saves,
               fake_clock_s=clk.t, faults=schedule.describe())
    del ref, ex, sup, rc
    torch.cuda.empty_cache()
    return out


def check_supervised(out):
    """The gates on ``supervised_lm``'s run: every scheduled fault seen and
    only those (the transient twice), no dispatch error, nothing
    unrecovered, every lost stage back at its tick, the exact launches of
    the ticks run, and the result bitwise the run without faults."""
    rep = out["report"]
    seen = sorted(map(tuple, rep["faults_seen"]))
    want = sorted([("transient", 0, 1), ("transient", 0, 1),
                   ("straggler", 1, 1), ("crash", 1, 3),
                   ("ckpt_corruption", 0, 3)])
    require(seen == want, f"faults seen {seen}, scheduled {want}")
    require(not any(f[0] == "error" for f in rep["faults_seen"]),
            f"a real dispatch error was seen: {rep['faults_seen']}")
    require(not rep["unrecovered"] and not rep["never_fired"],
            f"unrecovered {rep['unrecovered']}, never fired "
            f"{rep['never_fired']}")
    require(len(out["recoveries"]) == 2 and not out["open_recoveries"],
            f"recoveries {out['recoveries']}, open {out['open_recoveries']}")
    layer_ticks = sum(n * t for n, t in zip(out["stage_layers"],
                                            out["stage_ticks"]))
    want_l = {k: v * layer_ticks for k, v in SUPERVISED_LAUNCHES.items()}
    want_l["sil_mse"] = out["stage_ticks"][0]
    got = {k: out["launches"].get(k, 0) for k in want_l}
    require(got == want_l, f"launches {got}, expected {want_l} for the "
            f"{out['stage_ticks']} stage ticks run")
    require(out["bitwise_params"] and out["bitwise_opt"]
            and out["bitwise_gather"],
            "the supervised run differs from the run without faults "
            f"(params {out['bitwise_params']}, optimizer state "
            f"{out['bitwise_opt']}, gather {out['bitwise_gather']})")


def log_supervised(out, tag):
    n = sum(out["stage_ticks"])
    log(f"  {tag}: {out['fault_free_s']:.1f}s without faults, "
        f"{out['supervised_s']:.1f}s supervised ({out['stage_ticks']} stage "
        f"ticks, fake clock {out['fake_clock_s']:.3f}), peak "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB; faults {out['faults']}; "
        f"seen {out['report']['faults_seen']}")
    log(f"    launches a stage tick "
        f"{ {k: v / n for k, v in out['launches'].items()} } (stage 0 "
        f"ticks {out['stage_ticks'][0]}); without faults "
        f"{out['fault_free_launches']}")
    for r in out["recoveries"]:
        gbs = r["restore_bytes"] / 1e9 / max(r["restore_s"], 1e-9)
        log(f"    time to recover, {r['fault']} of stage {r['stage']} at "
            f"tick {r['tick']}: {r['recover_s']:.2f}s = waiting "
            f"{r['wait_s']:.2f}s (the other stage ran {r['other_ticks']} "
            f"ticks) + restore of tick {r['restored_tick']} "
            f"{r['restore_s']:.2f}s ({r['restore_bytes'] / 1e9:.2f} GB, "
            f"{gbs:.2f} GB/s) + replay {r['replay_s']:.2f}s")
    saves = [s for _, s in out["saves"]]
    log(f"    {len(saves)} saves, {sum(saves):.1f}s in all "
        f"({[round(s, 2) for s in saves]}); bitwise equal to the run "
        f"without faults: params {out['bitwise_params']}, optimizer state "
        f"{out['bitwise_opt']}, gather() {out['bitwise_gather']}")


def phase_resilience(torch, dev, report):
    """The chaos matrix on the full-width paper MLP (``chaos_matrix``), then
    qwen2-1.5b at full width cut to 4 layers recovering from a crash, a
    damaged checkpoint, a transient error and a straggler, bitwise
    (``supervised_lm``)."""
    from repro_torch.configs import get
    out = report["resilience"] = {}
    t0 = time.perf_counter()
    out["chaos"] = chaos_matrix(torch, dev)
    log(f"   (resilience chaos: {time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    cfg = get("qwen2-1.5b").replace(n_layers=SUPERVISED_LAYERS)
    lm = supervised_lm(torch, dev, cfg, LM_BATCH, LM_SEQ, SUPERVISED_TICKS,
                       ROOT / "build" / "ckpt_supervised")
    log_supervised(lm, f"{cfg.name} at full width, {cfg.n_layers} layers "
                   f"in 2 stages, B{LM_BATCH} x S{LM_SEQ}, "
                   f"{SUPERVISED_TICKS} ticks")
    check_supervised(lm)
    out["lm"] = {k: v for k, v in lm.items() if k != "report"}
    out["lm"]["faults_seen"] = lm["report"]["faults_seen"]
    log(f"   (resilience lm: {time.perf_counter() - t0:.1f}s)")


# -- phase 18 ------------------------------------------------------------------

VERIFY_ARCHS = ("qwen2-1.5b", "jamba-1.5-large-398b")
# the paper gate runs in the train phase (both presets); the
# auto-partitioner's parity runs at full only: at tiny's 80 right-stage
# epochs the hand cut has not separated (the port's tiny gap, as the
# paper gate's: 0.3124 on the card), so its tiny run is cut for time
VERIFY_LEFT_OUT = ("paper/emnist_parity",)
VERIFY_FULL_ONLY = ("plan/auto_vs_hand",)
VERIFY_KERNELS = ("flash_attention", "decode_attention",
                  "paged_decode_attention", "selective_scan", "sil_mse")


def phase_verify(torch, dev, report):
    """The conformance sweep on the card (``launch.verify.sweep``): every
    oracle at ``tiny`` for qwen2-1.5b, the arch-aware ones again for
    Jamba's smoke config, ``plan/auto_vs_hand`` at ``full`` only; each
    result required ok, its seconds printed, a report written under
    ``build/verify``; the counterparts of the five TPU kernels launched
    (counts zeroed just before the sweep, read just after)."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import verify as launch_verify
    from repro_torch.verify import all_oracles, write_report
    out = report["verify"] = {}
    log("  paper/emnist_parity is left to the train phase, which runs both "
        "presets (full passes, tiny misses: the port's known tiny gap); "
        "plan/auto_vs_hand runs at full only (its tiny run misses by the "
        "same gap)")
    runs = [(arch, "tiny", [o for o in all_oracles()
                            if o.name not in VERIFY_LEFT_OUT
                            and o.name not in VERIFY_FULL_ONLY
                            and (arch == VERIFY_ARCHS[0] or o.arch_aware)])
            for arch in VERIFY_ARCHS]
    runs.append((VERIFY_ARCHS[0], "full", [o for o in all_oracles()
                                           if o.name in VERIFY_FULL_ONLY]))
    LAUNCHES.reset()
    failed = []
    for arch, preset, oracles in runs:
        log(f"  {arch}, {preset}, {len(oracles)} oracles on {dev}:")
        results = launch_verify.sweep(oracles, preset=preset, arch=arch,
                                      device=dev)
        failed += [f"{arch}/{preset}/{r.name}" for r in results if not r.ok]
        path = ROOT / "build" / "verify" / f"CONFORMANCE_{arch}_{preset}.json"
        rep = write_report(str(path), results, preset=preset, arch=arch,
                           extra={"device": str(dev)})
        out[f"{arch}/{preset}"] = rep["oracles"]
    launches = LAUNCHES.snapshot()
    log(f"  sweep launches {launches}")
    out["launches"] = launches
    require(not failed, f"oracles failed: {failed}")
    missing = [k for k in VERIFY_KERNELS if launches.get(k, 0) == 0]
    require(not missing, f"the sweep launched no {missing} kernel")

# -- phase 8 -------------------------------------------------------------------

def time_ms(torch, fn, arg_sets, iters=50):
    """Mean ms per call with CUDA events, cycling over ``arg_sets`` (sized
    past the 50 MB L2, so every call reads its inputs from HBM)."""
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# spin kernels launched at the start of a profile, which are not counted,
# and the profiles taken before a measurement that misses launches fails
PROFILE_LEAD = 256
LEAD_KERNEL = "spin_kernel"           # what torch.cuda._sleep launches
PROFILE_TRIES = 3
# the profiler maps the card's timestamps onto the host's clock and drops
# the activities that land outside its session; in a process that has run
# for minutes the two clocks drift apart by milliseconds (whole sessions of
# 50 calls lost, PR 20), so each profiled loop has this much idle time on
# both sides
PROFILE_PAD_S = 0.25


def profile_lead(torch):
    """The start of a profiled loop: the uncounted spin kernels, then
    ``PROFILE_PAD_S`` of idle time."""
    for _ in range(PROFILE_LEAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(PROFILE_PAD_S)


def profile_tail(torch):
    """The end of a profiled loop: every launch done, then idle time."""
    torch.cuda.synchronize()
    time.sleep(PROFILE_PAD_S)


def device_kernels(torch, fn, arg_sets, iters=50):
    """{kernel name: (device ms a call, launches a call)} of every CUDA
    kernel that ``fn`` launches, over ``iters`` calls, from the profiler:
    the kernels' own
    time, without the host's issue cost that ``time_ms`` measures instead
    wherever the host takes longer to issue a call than the device takes to
    run it.  Every launch must be recorded: each kernel's count is a whole
    multiple of ``iters``.  In a process that has run for minutes the
    profiler drops the first few kernels of a session (about a dozen after
    the serve and train phases, now and then a whole session), so each
    profile starts with ``PROFILE_LEAD`` spin kernels that are not counted,
    and a profile that still misses a launch is taken again, at most
    ``PROFILE_TRIES`` times in all, then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profile_lead(torch)
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            profile_tail(torch)
        total, count = {}, {}
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA and e.count
                    and LEAD_KERNEL not in e.key):
                t = getattr(e, "self_device_time_total", None)
                us = e.self_cuda_time_total if t is None else t
                total[e.key] = total.get(e.key, 0.0) + us / 1e3
                count[e.key] = count.get(e.key, 0) + e.count
        short = {k: n for k, n in count.items() if n % iters}
        if count and not short:
            return {k: (total[k] / iters, count[k] // iters) for k in total}
        log(f"  profile {attempt + 1} of {PROFILE_TRIES} missed launches "
            f"({sum(count.values())} recorded over {iters} calls; not a "
            f"whole number a call: {sorted(short.values())})")
    require(False, f"the profiler missed launches in {PROFILE_TRIES} "
                   "profiles in a row")


def device_ms(torch, fn, arg_sets, name, iters=50):
    """Device ms per call of the kernels whose name holds ``name``: the
    port's wrappers launch each of their kernels once a call.  Fails if
    the profiler recorded none."""
    per = device_kernels(torch, fn, arg_sets, iters)
    keys = [k for k in per if name in k]
    require(bool(keys), f"the profiler recorded no launch of {name}")
    return sum(per[k][0] for k in keys)


def sdpa_backend(kernel_names) -> str:
    """Which SDPA backend ran, from the names of the kernels it launched."""
    joined = " ".join(kernel_names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in joined:
            return backend
    return "math"


def time_library(torch, fn, sets, row):
    """One PyTorch call's CUDA-event time, and the device time a call of
    every kernel it launches, summed, with the SDPA backend they show."""
    kern = device_kernels(torch, fn, sets)
    row.update(library_ms=time_ms(torch, fn, sets),
               library_device_ms=sum(ms for ms, _ in kern.values()),
               library_backend=sdpa_backend(kern),
               library_kernels=sorted(kern, key=lambda k: -kern[k][0])[:4])


def n_sets(bytes_per_set: int) -> int:
    return max(2, -(-200 * 2**20 // bytes_per_set))


def time_prefill(torch, dev, gen, b, sq, sk, h, kv, d, lse, causal):
    """The bf16 prefill kernel at (b, sq, sk, h, kv, d), with the rows' lse
    (the training forward) or without (serving), causal or not: CUDA-event
    and device ms, the plain version's ms and SDPA's (GQA), over input sets
    past the L2; its bytes and its 4 D FLOPs a (q, k) pair under the
    mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    dtype, dn, item = torch.bfloat16, "bfloat16", 2
    per = item * (2 * b * sq * h * d + 2 * b * sk * kv * d)
    if lse:
        per += 4 * b * h * sq                # the fp32 lse written
    sets = [prefill_inputs(torch, gen, dev, dtype, sq, sk, b=b, h=h, kv=kv,
                           d=d) for _ in range(n_sets(per))]
    pairs = sq * (sq + 1) // 2 if causal else sq * sk

    def fn(q, k, v):
        return K.flash_attention_cuda(q, k, v, causal=causal, return_lse=lse)

    def plain(q, k, v):
        return R.chunked_attention(q, k, v, causal=causal)
    shape = (f"B{b} S{sq}" if sq == sk else f"B{b} Sq{sq} Sk{sk}") + \
        f" H{h} KV{kv} D{d} {'causal' if causal else 'non-causal'} {dn}"
    row = {"shape": shape, "ms": time_ms(torch, fn, sets),
           "device_ms": device_ms(torch, fn, sets, "prefill"),
           "plain_ms": time_ms(torch, plain, sets, iters=10),
           "bytes": per, "flops": 4 * d * h * b * pairs}
    time_library(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True), sets, row)
    return row


def time_attention_bwd(torch, dev, gen, b, sq, sk, h, kv, d, causal):
    """The bf16 attention backward at (b, sq, sk, h, kv, d): q, k, v, lse
    and dO read, dq, dk, dv written; 10 D FLOPs a (q, k) pair under the
    mask (5 products of 2 D each: S, dP, dV, dK, dQ); each kernel's own
    device time, the plain version's ms and SDPA's backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    dtype, dn, item = torch.bfloat16, "bfloat16", 2
    per = item * (3 * b * sq * h * d + 4 * b * sk * kv * d) + 4 * b * h * sq

    def bwd(q, k, v, lse, do):
        return K.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal)

    def plain_bwd(q, k, v, lse, do):
        return R.flash_attention_bwd(q, k, v, lse, do, causal=causal)

    def sdpa_bwd(o_t, qt, kt, vt, do_t):
        return torch.autograd.grad(o_t, (qt, kt, vt), do_t,
                                   retain_graph=True)
    sets, lib_sets = [], []
    for _ in range(n_sets(per)):
        q, k, v = prefill_inputs(torch, gen, dev, dtype, sq, sk, b=b, h=h,
                                 kv=kv, d=d)
        _, lse = K.flash_attention_cuda(q, k, v, causal=causal,
                                        return_lse=True)
        do = _rand(torch, gen, tuple(q.shape), dtype, dev)
        sets.append((q, k, v, lse, do))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_sets.append((F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), qt, kt, vt,
            do.transpose(1, 2)))
    per_kernel = {k: ms for k, (ms, _) in
                  device_kernels(torch, bwd, sets, iters=10).items()
                  if "attn_bwd" in k}
    require(bool(per_kernel), "the profiler recorded no launch of attn_bwd")
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    shape = (f"B{b} S{sq}" if sq == sk else f"B{b} Sq{sq} Sk{sk}") + \
        f" H{h} KV{kv} D{d} {'causal' if causal else 'non-causal'} {dn}"
    row = {"shape": shape, "ms": time_ms(torch, bwd, sets, iters=10),
           "device_ms": sum(per_kernel.values()),
           # each kernel's own device time: dQ (and delta), then dK/dV
           "kernels_ms": {k.split("::")[-1].split("(")[0]: ms
                          for k, ms in per_kernel.items()},
           "plain_ms": time_ms(torch, plain_bwd, sets, iters=2),
           "bytes": per, "flops": 10 * d * h * b * pairs}
    time_library(torch, sdpa_bwd, lib_sets, row)
    return row


def time_decode(torch, dev, gen, h, kv, d, lc=LC, positions=DECODE_POS):
    """Decode and paged decode in bf16, one request a position of
    ``positions`` over ``lc`` slots: (contiguous row, paged row), each
    with its CUDA-event and device ms, the plain version's and (contiguous
    only) SDPA's with a boolean mask; bytes: the valid K/V rows, q, the
    output and pos (and the block table)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    dtype, dn, item = torch.bfloat16, "bfloat16", 2
    b = len(positions)

    def paged(q_, k_, v_, b_, p_):
        return K.paged_decode_attention_cuda(q_, k_, v_, b_, p_,
                                             logical_len=lc)

    def plain_paged(q_, k_, v_, b_, p_):
        return R.paged_decode_attention(q_, k_, v_, b_, p_, logical_len=lc)
    q, kp, vp, bt, pos, kc, vc = decode_inputs(
        torch, gen, dev, dtype, h=h, kv=kv, d=d, lc=lc, positions=positions)
    valid = [min(p + 1, lc) for p in positions]
    kv_bytes = item * 2 * kv * d * sum(valid)
    qo_bytes = item * 2 * b * h * d + 4 * b
    dec_flops = 4 * d * h * sum(valid)
    per = item * (kc.numel() + vc.numel())
    k_sets = [(q, kc.clone(), vc.clone(), pos) for _ in range(n_sets(per))]
    p_sets = [(q, kp.clone(), vp.clone(), bt, pos)
              for _ in range(n_sets(item * (kp.numel() + vp.numel())))]
    slot = torch.arange(lc, device=dev)
    mask = (slot[None, :] <= pos[:, None].long())[:, None, None, :]
    _, n_split = K.split_plan(lc, b, kv)
    at = "ragged pos" if positions == DECODE_POS else f"pos {list(positions)}"
    row = {"shape": f"B{b} Lc{lc} H{h} KV{kv} D{d} {at} {dn}, "
                    f"{n_split} splits",
           "ms": time_ms(torch, K.decode_attention_cuda, k_sets),
           "device_ms": device_ms(torch, K.decode_attention_cuda, k_sets,
                                  "decode_kernel"),
           "plain_ms": time_ms(torch, R.decode_attention, k_sets),
           "bytes": kv_bytes + qo_bytes, "flops": dec_flops}
    time_library(torch, lambda q_, k_, v_, p_: F.scaled_dot_product_attention(
        q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
        attn_mask=mask, enable_gqa=True), k_sets, row)
    tbl = 4 * sum(-(-v // BLOCK) for v in valid)
    paged_row = {
        "shape": f"B{b} Lc{lc} BS{BLOCK} H{h} KV{kv} D{d} {dn}",
        "ms": time_ms(torch, paged, p_sets),
        "device_ms": device_ms(torch, paged, p_sets, "decode_kernel"),
        "plain_ms": time_ms(torch, plain_paged, p_sets),
        "library_ms": None,      # no single PyTorch call gathers pages
        "bytes": kv_bytes + qo_bytes + tbl, "flops": dec_flops}
    return row, paged_row


def finish_timing(out):
    """Each row's bound (the larger of its bytes at 3.35 TB/s and its
    operations at the peak of their type; for the scan, its exponentials
    too) and what bounds it, logged beside its times."""
    for name, t in out.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S
        t_ops = t["flops"] / PEAK_FLOPS[t.get("flops_dtype", "bfloat16")]
        if "exp_per_s" in t:              # the scan's exponentials
            t["flops_s"], t["exp_s"] = t_ops, t["exps"] / t["exp_per_s"]
            t_ops = max(t_ops, t["exp_s"])
            t["sfu_bound_ms"] = 1e3 * max(t_bytes, t["flops_s"], t["exps"]
                                          / t["sfu_exp_per_s"])
        t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = t["library_ms"]
        if "device_ms" in t:
            log(f"  {name:24s} kernel's own device time (profiler) "
                f"{t['device_ms']:.4f} ms" + "".join(
                    f"; {k} {ms:.4f}" for k, ms in t.get("kernels_ms",
                                                         {}).items()))
        if t.get("library_device_ms") is not None:
            log(f"  {name:24s} library's device time (every kernel it "
                f"launched, profiler) {t['library_device_ms']:.4f} ms, "
                f"backend {t['library_backend']}: kernel / library "
                f"{t['device_ms'] / t['library_device_ms']:.3f}")
        log(f"  {name:24s} {t['shape']:40s} kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
            + (f", SFU-only bound {t['sfu_bound_ms']:.4f} ms"
               if "sfu_bound_ms" in t else ""))


def phase_timing(torch, dev, report):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    gen = torch.Generator(device=dev).manual_seed(2)
    dtype, dn = torch.bfloat16, "bfloat16"
    item = 2
    out = {}

    # prefill, causal: the yardstick shape (B2 S1024, qwen2's 12/2 heads)
    # and the serve phase's longest prompt on each model (B1 S512), all as
    # the serve path calls it (no lse); and the LM train phase's layer (B8
    # S1024) as its forward calls it, with the rows' lse, on qwen2's heads,
    # on granite's (24/8 of 64, the moe phase's) and on stablelm's (32/32
    # of 80, the dense phase's); the dense phase's longest prompt on
    # stablelm's and chatglm3's heads (32/2 of 128).  Non-causal (every
    # (q, k) pair): whisper-tiny's training forward with its lse, the
    # encoder over 1500 frames and the decoder's 448 tokens against them,
    # at B8 (``WHISPER_ATTN``)
    for key, (b, sq, sk, h, kv, d), lse, causal in (
            ("flash_attention", (B_PREFILL, 1024, 1024, H, KV, D), False,
             True),
            ("flash_attention@serve_qwen2", (1, 512, 512, H, KV, D), False,
             True),
            ("flash_attention@serve_jamba",
             (1, 512, 512, JAMBA_H, JAMBA_KV, D), False, True),
            ("flash_attention@train_lse", BWD_FULL[:2] + BWD_FULL[1:], True,
             True),
            ("flash_attention@granite_lse",
             GRANITE_LAYER[:2] + GRANITE_LAYER[1:], True, True),
            ("flash_attention@serve_stablelm",
             (1, 512, 512, STABLELM_H, STABLELM_KV, STABLELM_D), False,
             True),
            ("flash_attention@stablelm_lse",
             STABLELM_LAYER[:2] + STABLELM_LAYER[1:], True, True),
            ("flash_attention@serve_chatglm3",
             (1, 512, 512, CHATGLM_H, CHATGLM_KV, D), False, True),
            ("flash_attention@whisper_enc_lse", WHISPER_ATTN[0][:6], True,
             False),
            ("flash_attention@whisper_cross_lse", WHISPER_ATTN[1][:6], True,
             False)):
        out[key] = time_prefill(torch, dev, gen, b, sq, sk, h, kv, d, lse,
                                causal)

    # the backward at the LM train phase's layer shape, at granite's and at
    # stablelm's (causal), and at whisper-tiny's encoder and cross-attention
    # (non-causal)
    for key, (b, sq, sk, h, kv, d), causal in (
            ("flash_attention_bwd", BWD_FULL[:2] + BWD_FULL[1:], True),
            ("flash_attention_bwd@granite",
             GRANITE_LAYER[:2] + GRANITE_LAYER[1:], True),
            ("flash_attention_bwd@stablelm",
             STABLELM_LAYER[:2] + STABLELM_LAYER[1:], True),
            ("flash_attention_bwd@whisper_enc", WHISPER_ATTN[0][:6], False),
            ("flash_attention_bwd@whisper_cross", WHISPER_ATTN[1][:6],
             False)):
        out[key] = time_attention_bwd(torch, dev, gen, b, sq, sk, h, kv, d,
                                      causal)

    # decode and paged decode: B=8, Lc=1056, ragged pos, on qwen2's heads,
    # granite's (24/8 of 64), stablelm's (32/32 of 80), chatglm3's (32/2 of
    # 128, 256 threads a block) and mistral-large's (96/8 of 128)
    for tag, h, kv, d in (("", H, KV, D),
                          ("@granite", GRANITE_H, GRANITE_KV, GRANITE_D),
                          ("@stablelm", STABLELM_H, STABLELM_KV, STABLELM_D),
                          ("@chatglm3", CHATGLM_H, CHATGLM_KV, D),
                          ("@mistral", MISTRAL_H, MISTRAL_KV, D)):
        out["decode_attention" + tag], out["paged_decode_attention" + tag] \
            = time_decode(torch, dev, gen, h, kv, d)
    # whisper-tiny's cross-attention decode: every one of 1500 encoder slots
    # (pos 1499) at B8, 6/6 heads of 64; the library call attends to every
    # key without a mask
    b, lc = B_DECODE, WHISPER_ENC
    h, kv, d = WHISPER_H, WHISPER_KV, WHISPER_D
    per = item * 2 * b * lc * kv * d
    k_sets = [(_rand(torch, gen, (b, 1, h, d), dtype, dev),
               _rand(torch, gen, (b, lc, kv, d), dtype, dev),
               _rand(torch, gen, (b, lc, kv, d), dtype, dev), lc - 1)
              for _ in range(n_sets(per))]
    _, n_split = K.split_plan(lc, b, kv)
    out["decode_attention@whisper_cross"] = row = {
        "shape": f"B{b} Lc{lc} H{h} KV{kv} D{d} pos {lc - 1} {dn}, "
                 f"{n_split} splits",
        "ms": time_ms(torch, K.decode_attention_cuda, k_sets),
        "device_ms": device_ms(torch, K.decode_attention_cuda, k_sets,
                               "decode_kernel"),
        "plain_ms": time_ms(torch, R.decode_attention, k_sets),
        "bytes": per + item * 2 * b * h * d + 4 * b,
        "flops": 4 * d * h * b * lc}
    time_library(torch, lambda q_, k_, v_, p_: F.scaled_dot_product_attention(
        q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
        enable_gqa=True), k_sets, row)
    del k_sets
    out.update(time_sil_mse(torch, dev, gen))
    out.update(time_selective_scan(torch, dev, gen))
    out.update(time_selective_scan_bwd(torch, dev, gen))
    finish_timing(out)
    for name in ("sil_mse", "sil_mse@lm", SIL_LM_FIRST_ROWS,
                 "sil_mse@granite"):
        t = out[name]
        log(f"  {name:24s} {t['kernels_per_call']} kernel a call; bound "
            f"{t['bound_ms']:.5f} ms, floor (an empty kernel of the same "
            f"grid, same profile) {t['floor_ms']:.4f} ms, kernel "
            f"{t['device_ms']:.4f} ms = {t['bound_ms'] / t['device_ms']:.1%} "
            f"of the bound")
        require(t["kernels_per_call"] == 1, f"{name}: "
                f"{t['kernels_per_call']} sil_mse kernels a call, not one")
    log("  sil_mse host split (us a call, paper shape): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["sil_mse"]["host_split_us"].items()))
    c, p = out["decode_attention"], out["paged_decode_attention"]
    log(f"  paged / contiguous decode, device time: "
        f"{p['device_ms'] / c['device_ms']:.3f}")
    report["timing"] = out


def sil_host_split(torch, K, act, sil, lab, n=300, reps=5):
    """Host us a call of each step of ``K.sil_mse_cuda`` on these inputs,
    each step run ``n`` times back to back (the median of ``reps`` runs),
    and of the whole call; "rest" is the whole call less its steps (the
    launch count, the error check, Python's calls between the steps).  Takes
    this checkout's wrapper and the two-kernel one before it (its C entry
    point still has the partial-buffer size query), so ``scan_ab.py`` can
    split another checkout's wrapper in the same process layout."""
    dev = act.device
    t, d = act.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    grad = torch.empty_like(act)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    steps = {"checks": lambda: K._checks(act, sil, lab)}
    if hasattr(K, "sil_plan"):
        index = dev.index
        plan, ws = K._plan(act, sil, index), K._workspace(index, stream)
        steps.update({
            "plan": lambda: K._plan(act, sil, index),
            "alloc grad": lambda: torch.empty_like(
                act, memory_format=torch.contiguous_format),
            "alloc loss": lambda: act.new_empty((), dtype=torch.float32),
            "stream lookup": lambda: torch._C._cuda_getCurrentRawStream(
                index),
            "workspace": lambda: K._workspace(index, stream),
            "device check": lambda: index == torch.cuda.current_device(),
            "launch": lambda: K._launch(act, sil, lab, grad, loss, plan,
                                        stream, ws)})
    else:
        lib = K._lib()
        n_part = lib.repro_sil_mse_blocks(t)
        part = torch.empty((n_part,), dtype=torch.float32, device=dev)
        code, label_bytes = K._DTYPE_CODE[act.dtype], K._LABEL_BYTES[lab.dtype]

        def guard():
            with torch.cuda.device(dev):
                pass

        steps.update({
            "size query": lambda: lib.repro_sil_mse_blocks(t),
            "alloc grad": lambda: torch.empty((t, d), dtype=act.dtype,
                                              device=dev),
            "alloc partials": lambda: torch.empty((n_part,),
                                                  dtype=torch.float32,
                                                  device=dev),
            "alloc loss": lambda: torch.empty((), dtype=torch.float32,
                                              device=dev),
            "device guard": guard,
            "stream lookup": lambda: torch.cuda.current_stream(dev)
            .cuda_stream,
            "launch": lambda: lib.repro_sil_mse(
                act.data_ptr(), act.stride(0), sil.data_ptr(), sil.stride(0),
                sil.stride(1), lab.data_ptr(), label_bytes, grad.data_ptr(),
                part.data_ptr(), loss.data_ptr(), code, t, d, sil.shape[1],
                stream)})

    def host_us(fn):
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append(1e6 * (time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
        return sorted(runs)[reps // 2]

    out = {name: host_us(fn) for name, fn in steps.items()}
    whole = host_us(lambda: K.sil_mse_cuda(act, sil, lab))
    out["rest"] = whole - sum(out.values())
    out["whole call"] = whole
    return out


def empty_launcher(K):
    """A launch of the port's empty kernel (``repro_empty_launch``) on the
    current stream with ``blocks`` x ``K.THREADS`` threads, or None where
    the checkout's library has none."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.load("sil_mse")
    if not hasattr(lib, "repro_empty_launch"):
        return None
    fn = lib.repro_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(torch, blocks):
        build.check(fn(blocks, K.THREADS, torch.cuda.current_stream()
                       .cuda_stream), "empty kernel")
    return launch


def time_sil_mse(torch, dev, gen, cases=None):
    """SIL-MSE at the train path's shape (fp32 act, the trainer's (M, d)
    table, int64 labels) and at the LM SILs' of qwen2 and granite (bf16
    act).  Bytes: act read,
    the table rows of the distinct labels read once, the labels read, the
    grad and the loss written; three fp32 operations an element.  The LM
    shape again with the labels a permutation of [0, T) (``SIL_LM_FIRST_ROWS``).
    Beside
    the kernel's device time, in the same profile, an empty kernel of the
    same grid: the floor any one launch of it reaches.  At the paper shape,
    the wrapper's host time a call, step by step (``sil_host_split``).
    ``cases``: (key, (T, d, M), act dtype) in place of those."""
    from repro_torch.kernels.sil_mse import kernel as K
    from repro_torch.kernels.sil_mse import ref as R
    empty = empty_launcher(K)

    def plain(a, s_, lab):
        return R.sil_mse(a, s_, lab), R.sil_mse_grad_act(a, s_, lab).to(
            a.dtype)

    out = {}
    for key, (t, d, m), dtype in cases or (
            ("sil_mse", SIL_PAPER, torch.float32),
            ("sil_mse@lm", SIL_LM, torch.bfloat16),
            (SIL_LM_FIRST_ROWS, SIL_LM, torch.bfloat16),
            ("sil_mse@granite", SIL_GRANITE, torch.bfloat16)):
        item = torch.finfo(dtype).bits // 8
        table = (torch.rand((m, d), generator=gen, device=dev) * 10).t()
        per = 2 * t * d * item + 8 * t
        sets = []
        for _ in range(n_sets(per)):
            act = torch.randn((t, d), generator=gen, device=dev).to(dtype)
            lab = torch.randperm(t, generator=gen, device=dev) \
                if key == SIL_LM_FIRST_ROWS else \
                torch.randint(0, m, (t,), generator=gen, device=dev)
            sets.append((act, table, lab))
        rows = sum(int(torch.unique(s_[2]).numel()) for s_ in sets) \
            / len(sets)
        blocks = K._plan(act, table, dev.index).blocks if empty else None

        def with_floor(a, s_, lab_):
            K.sil_mse_cuda(a, s_, lab_)
            if empty:
                empty(torch, blocks)

        per_kernel = device_kernels(torch, with_floor, sets)
        ours = [v for k, v in per_kernel.items() if "sil_mse" in k]
        require(bool(ours), "the profiler recorded no sil_mse kernel")
        floor = [v[0] for k, v in per_kernel.items() if "empty_kernel" in k]
        out[key] = {
            "shape": f"T{t} d{d} M{m} {str(dtype)[6:]} act, (M,d) table"
                     + (", labels a permutation of [0, T)"
                        if key == SIL_LM_FIRST_ROWS else ""),
            "ms": time_ms(torch, K.sil_mse_cuda, sets),
            "device_ms": sum(ms for ms, _ in ours),
            "kernels_per_call": sum(n for _, n in ours),
            "floor_ms": floor[0] if floor else None,
            "grid_blocks": blocks,
            "plain_ms": time_ms(torch, plain, sets, iters=20),
            # no single PyTorch call computes the loss and its grad with
            # the label gather fused
            "library_ms": None,
            "bytes": int(2 * t * d * item + rows * d * 4 + 8 * t + 4),
            "bytes_one_row_per_token": 2 * t * d * item + t * d * 4 + 8 * t
            + 4,
            "distinct_labels": rows,
            "flops": 3 * t * d, "flops_dtype": "float32"}
        if key == "sil_mse":
            out[key]["host_split_us"] = sil_host_split(torch, K, *sets[0])
        del sets, table
        torch.cuda.empty_cache()
    return out


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def two_pipe_exp_rate(fma_per_elem: int) -> float:
    """Exponentials a clock an SM when the SFU (MUFU.EX2, 16 a clock) and
    the issue slots both run full, for a loop that issues ``fma_per_elem``
    FP32-pipe instructions an element besides its exponential: e_sfu = 16 T
    and F E + e_sfu + c (E - e_sfu) = 128 T, for T clocks an SM, F =
    ``fma_per_elem`` and c = EX2_FMA_PIPE."""
    return ((ISSUE_PER_CLK_PER_SM + (EX2_FMA_PIPE - 1) * SFU_PER_CLK_PER_SM)
            / (fma_per_elem + EX2_FMA_PIPE))


def kernel_short_name(key: str) -> str:
    """A profiler's kernel name without its namespace, template arguments
    and parameters: ``void (anonymous namespace)::scan_bwd_kernel<...>(...)``
    -> ``scan_bwd_kernel``."""
    m = re.search(r"(\w+)(?=[<(])", key)
    return m.group(1) if m else key


def scan_bwd_sets(torch, K, gen, dev, views):
    """Argument sets of ``selective_scan_bwd_cuda`` at ``SCAN_TRAIN`` (bf16
    u and dy, no h0 or dh_last), each on the states its saving forward
    wrote; with ``views`` B and C are column views of one (Ba, S, R + 2N)
    tensor, as the train cut hands them over.  Enough sets to pass the L2."""
    ba, s, di, n = SCAN_TRAIN
    sets = []
    for _ in range(n_sets(ba * s * di * 8)):
        u, dt, a, b, c, d, _ = scan_inputs(torch, gen, dev, ba, s, di, n,
                                           views=views)
        u = u.to(torch.bfloat16)
        dy = torch.randn((ba, s, di), generator=gen, device=dev).to(
            torch.bfloat16)
        _, _, states = K.selective_scan_fwd_saving_cuda(u, dt, a, b, c, d)
        sets.append((u, dt, a, b, c, d, states, dy))
    return sets


def time_selective_scan_bwd(torch, dev, gen):
    """The scan's backward at the hybrid phase's train layer (Ba 8, S 1024,
    Di 16384, N 16, bf16 u, no h0 or dh_last), on the states its forward
    saved, with B and C contiguous and, as a second row, as column views of
    one (Ba, S, R + 2N) tensor, as the train cut hands them over.  Bytes: u,
    dt and dy read, du and ddt written, B and C read, dB and dC written, A,
    D, dA and dD; the saved states are the kernel's own traffic, not the
    function's.  Operations: one exponential a (b, t, d, n), which the
    states' recompute and the gradient's recurrence can share, and the
    forward's and the backward's fp32 operations (``SCAN_FWD_OPS +
    SCAN_BWD_OPS``), of which the kernel issues ``SCAN_BWD_OPS`` FP32-pipe
    instructions an element beside the exponential.  No single PyTorch call
    computes a scan's gradient."""
    from repro_torch.kernels.selective_scan import kernel as K
    from repro_torch.kernels.selective_scan import ref as R
    ba, s, di, n = SCAN_TRAIN
    clock = max_sm_clock_hz()
    exp_rate = two_pipe_exp_rate(SCAN_BWD_OPS)
    elems = ba * s * di
    out = {}
    for key, views in (("selective_scan_bwd", False),
                       ("selective_scan_bwd@bc_views", True)):
        sets = scan_bwd_sets(torch, K, gen, dev, views)
        per = {k: ms for k, (ms, _) in
               device_kernels(torch, K.selective_scan_bwd_cuda, sets,
                              iters=10).items() if "scan_bwd" in k}
        require(bool(per), "the profiler recorded no launch of scan_bwd")

        def plain(u, dt, a, b, c, d, states, dy):
            return R.selective_scan_bwd(u, dt, a, b, c, d, dy)
        row = {"shape": f"Ba{ba} S{s} Di{di} N{n} bf16 u, no h0 or dh_last"
                        + (", B/C column views" if views else ""),
               "ms": time_ms(torch, K.selective_scan_bwd_cuda, sets,
                             iters=10),
               "device_ms": sum(per.values()),
               # each kernel's own device time
               "kernels_ms": {kernel_short_name(k): ms
                              for k, ms in per.items()},
               "plain_ms": time_ms(torch, plain, sets[:1], iters=2),
               "library_ms": None,   # no single PyTorch call computes it
               "bytes": elems * (2 + 4 + 2 + 2 + 4) + 4 * ba * s * n * 4
               + 2 * (di * n * 4 + di * 4),
               "flops": (SCAN_FWD_OPS + SCAN_BWD_OPS) * elems * n,
               "flops_dtype": "float32", "exps": elems * n,
               "sm_clock_hz": clock, "exp_rate": exp_rate,
               "exp_per_s": exp_rate * H100_SMS * clock,
               "sfu_exp_per_s": SFU_PER_CLK_PER_SM * H100_SMS * clock,
               "warps": K.bwd_plan(ba, s, di, n).warps,
               "blocks_per_sm": K.bwd_blocks_per_sm(
                   torch.bfloat16, n, K.vector_loads(*sets[0][:2],
                                                     *sets[0][3:5]))}
        out[key] = row
        del sets
        torch.cuda.empty_cache()
    return out


def time_selective_scan(torch, dev, gen):
    """The selective scan at each ``SCAN_TIMED`` shape (bf16 u, zero h0): the
    timing shape and the serve phase's Jamba prefills.  Bytes: u, dt and y
    once each, B, C, A, D and h_last; operations: ``SCAN_FWD_OPS`` fp32 flops and one
    exponential a (b, t, d, n), at the card's maximum SM clock.  The bound
    lets a kernel compute a share of the exponentials on the FMA pipe:
    ``exp_rate`` is the exponentials a clock an SM when the SFU (MUFU.EX2,
    16 a clock) and the issue slots both run full; ``sfu_bound_ms`` is this
    kernel's design bound, every exponential on the SFU.  No single PyTorch
    call computes a selective scan."""
    from repro_torch.kernels.selective_scan import kernel as K
    from repro_torch.kernels.selective_scan import ref as R
    clock = max_sm_clock_hz()
    exp_rate = two_pipe_exp_rate(SCAN_FMA_PER_ELEM)
    out = {}
    for key, (ba, s, di, n) in SCAN_TIMED.items():
        per = ba * s * di * (2 + 4)
        sets = []
        for _ in range(n_sets(per)):
            u, dt, a, b, c, d, _ = scan_inputs(torch, gen, dev, ba, s, di, n)
            sets.append((u.to(torch.bfloat16), dt, a, b, c, d))
            del u
        elems = ba * s * di
        out[key] = {
            "shape": f"Ba{ba} S{s} Di{di} N{n} bf16 u, zero h0",
            "ms": time_ms(torch, K.selective_scan_cuda, sets),
            "device_ms": device_ms(torch, K.selective_scan_cuda, sets,
                                   "scan_kernel"),
            "plain_ms": time_ms(torch, R.selective_scan, sets, iters=3),
            "library_ms": None,   # no single PyTorch call computes the scan
            "bytes": elems * (2 + 4 + 2) + 2 * ba * s * n * 4 + di * n * 4
            + di * 4 + ba * di * n * 4,
            "flops": SCAN_FWD_OPS * elems * n + 3 * elems,
            "flops_dtype": "float32",
            "exps": elems * n, "sm_clock_hz": clock, "exp_rate": exp_rate,
            "exp_per_s": exp_rate * H100_SMS * clock,
            "sfu_exp_per_s": SFU_PER_CLK_PER_SM * H100_SMS * clock,
            "warps": K.scan_plan(ba, s, di, n).warps}
        del sets
        torch.cuda.empty_cache()
    return out


# -- main ------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; the port's kernels run "
              "only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no {SRC / 'repro_torch'}; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    report = {}
    t_start = time.perf_counter()
    failed = []
    for phase in PHASES:
        if phase not in phases:
            continue
        log(f"== {phase}")
        t0 = time.perf_counter()
        try:
            if phase == "device":
                phase_device(torch, report)
            elif phase == "build":
                phase_build(report)
            elif phase == "kernels":
                phase_kernels(torch, dev, report)
            elif phase == "reference":
                phase_reference(torch, dev, report)
            elif phase == "serve":
                phase_serve(torch, dev, report)
            elif phase == "loadgen":
                phase_loadgen(torch, dev, report)
            elif phase == "train":
                phase_train(torch, dev, report)
            elif phase == "lm_train":
                phase_lm_train(torch, dev, report)
            elif phase == "lm_parallel":
                phase_lm_parallel(torch, dev, report)
            elif phase == "lm_fig3":
                phase_lm_fig3(torch, dev, report)
            elif phase == "timing":
                phase_timing(torch, dev, report)
            elif phase == "moe":
                phase_moe(torch, dev, report)
            elif phase == "hybrid":
                phase_hybrid(torch, dev, report)
            elif phase == "dense":
                phase_dense(torch, dev, report)
            elif phase == "whisper":
                phase_whisper(torch, dev, report)
            elif phase == "xlstm":
                phase_xlstm(torch, dev, report)
            elif phase == "llava":
                phase_llava(torch, dev, report)
            elif phase == "resilience":
                phase_resilience(torch, dev, report)
            elif phase == "verify":
                phase_verify(torch, dev, report)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- report every phase's fault
            import traceback
            traceback.print_exc()
            failed.append(phase)
            log(f"FAILED phase {phase}: {type(e).__name__}: {e}")
        took = time.perf_counter() - t0
        report.setdefault("phase_seconds", {})[phase] = took
        log(f"   ({phase}: {took:.1f}s)")
    report["failed"] = failed
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1
    if set(phases) != set(PHASES):
        log(f"chip_smoke: partial run ({','.join(phases)}), no result")
        return 0

    kernels = []
    timing = report.get("timing", {})
    for name, (source, replaces) in KERNELS.items():
        t = timing.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": report.get("launches", {}).get(name),
            "max_abs_err": report.get("max_abs_err", {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            "device_ms": t.get("device_ms"),
            "library_device_ms": t.get("library_device_ms")})
    log(smi_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
