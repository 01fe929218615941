#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. the card's name and power limit; build the nine CUDA kernels from the
   sources in this checkout (nvcc, one process per source); the
   ``-Xptxas -v`` report's registers, static shared memory and spills,
   over all kernels and for ``kvd_partial`` (kv_decode and
   paged_attention's body) alone, with the dynamic shared memory a
   block of it takes at the phase-2 shapes; the same for
   ``pmm_kernel`` and ``pmm_t_mma_kernel`` (packed_matmul and
   packed_matmul_batched's two orientations), with each orientation's
   dynamic shared memory per width and x dtype (the transposed one's at
   slices of 2,048 columns, the tied heads').
2. each kernel against its plain PyTorch version on the card, at the
   shapes full-width serving gives it (qwen3-8b for the dense-path
   kernels and paged_attention, deepseek-moe-16b's expert banks for
   packed_matmul_batched, both orientations, plus a ragged shape), with
   the stated tolerance; kernel, plain and library-call times (CUDA
   events, operands rotated through enough copies to defeat the 50 MB
   L2) and the bound (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s). kv_decode is also held to its plain version on AF8 and
   AF32 caches of qwen3-8b's tick shape (checked, not timed: no tick
   runs them). The speculative draft's AF12 path at qwen3-8b's tick
   shapes, each beside its plain version, bound and library call
   (``per_width`` in the kernels line): kv_decode, paged_attention
   (tick case) and the KV append (dense and paged) on AF12 caches, and
   packed_matmul over the draft's whole weight pass at AF12 (wq, wk,
   wv, wo, w_in, w_gate, w_out and lm_head; cuBLAS on the decoded bf16
   weights). take_rows is timed at the tick with the same rows every
   call and with fresh rows (past the L2), held to its plain version on
   NaN codes to bf16 at all 7 widths, and for qwen3-8b also checked and
   timed at the (B, T) embed shape, slots x max_seq_len = 2,048 rows, to
   bf16 and f32 (``many_rows`` in its kernels entry). packed_matmul is also checked and timed at AF8 and AF12
   on qwen3-8b's w_up shape (bf16 x; no plain tick runs them).
   paged_attention is also held bit for bit to kv_decode over the same
   rows laid out dense, and against poison on the scrap page. ``pack``
   (``ops.pack``, f32 and bf16) also against its library call at AF16,
   ``x.to(torch.float16).view(torch.int32)``; its decode-tick launch,
   the KV append (``ops.append_kv_rows``), at all 7 widths, dense and
   paged, clamped and scrap rows included, and timed per layer beside
   the eager composition it replaced (a cast, a pack and index writes
   per row), each with its host issue time.
2b. unpack, convert and truncate, which no serving path calls (unpack
   is on the training path: 2e, 3c; convert and truncate on the
   calibration's: 3d), once: bit
   for bit (tolerance 0, bit patterns compared, so -0.0 and NaN bits
   count) against their plain versions at qwen3-8b's w_up leaf (4096,
   12288) and a ragged (7, 1000), all 7 widths; convert also on every
   code of AF8-AF20, truncate on the round-to-nearest-even ties of
   AF8-AF16 and every 4099th f32 bit pattern; each timed at AF16 on
   the w_up shape beside its bound, plain and library times; unpack
   also at AF8 and AF12 and to bf16 at AF16.
2c. the four other families at their full-width decode tick
   (paligemma-3b, whisper-small, falcon-mamba-7b, recurrentgemma-9b;
   bf16 activations, AF16 weights and KV, caches of 64 rows): every
   packed product of the body (``tick_products``; the tied heads of
   paligemma and recurrentgemma in the transposed orientation, whisper's
   untied head, mamba's four projections; paligemma's head also at AF12,
   the AF12 draft's, which no plain tick runs), the KV append and kv_decode
   of each self-attention layer (recurrentgemma over its ring), whisper's
   cross attention over its 1,500 rows, the embedding gather, and
   paligemma's paged_attention (head_dim 256, 8 query heads a KV head)
   on the check case and its paged drain's tick, also held bit for bit
   to kv_decode over the same rows: each held to its plain version and
   timed beside its bound and library call.
2d. the prefill path's kernels at the rows a prefill of B = 2, T = 512
   gives them, bf16 x, AF16: packed_matmul at qwen3-8b's seven products
   (five shapes) at M = 1,024 and paligemma-3b's tied head, transposed,
   at M = 512; packed_matmul_batched at deepseek-moe-16b's banks at the
   capacity of 1,024 tokens; take_rows at 1,024 rows: each held to its
   plain version and timed beside its bound (FLOPs over TF32's
   495 TFLOP/s where x is bf16 against AF8-AF16, or bytes) and
   torch.matmul, torch.bmm or F.embedding on the decoded weights
   (``prefill`` in the kernels line).
2e. the training path's kernels at the rows a train step of B = 2,
   T = 512 gives them (whisper T = 256), bf16 x, AF16: the transposed
   packed_matmul as the dx of qwen3-8b's five product shapes at
   M = 1,024 (its untied head's, contracting over the vocabulary, among
   them) and of whisper-small's untied head at M = 512; the normal
   orientation as the dx of a tied head (paligemma-3b's table, K =
   257,216; on no trained model's path); packed_matmul_batched,
   transposed, as the dx of deepseek-moe-16b's banks at the capacity of
   1,024 tokens; pack and unpack over one AF16 moment leaf of qwen3-8b's
   w_up shape: each held to its plain version (pack and unpack bit for
   bit) and timed beside its bound and library call (``train`` in the
   kernels line, with ``calls_per_train_step``).
2f. the five zoo configs' decode ticks (``check_zoo``, ``ZOO_ARCHS`` at
   phase 3g's depths and shapes, bf16 activations): every packed
   product, the KV append, kv_decode and the embedding gather of the
   tick (``check_family``), paged_attention (``zoo_paged_cases``: a
   check case up to 4,096 rows and the drain's tick), arctic-480b's
   expert banks at E = 128 and its decode capacity (C = 1); and at the
   new shapes' other widths: the drafts' whole weight pass (phi3-medium-
   14b AF12, stablelm-12b AF8), kv_decode on AF12 (timed), AF8 and AF32
   (checked) caches of the dense three, paged_attention on AF12, AF8 and
   bf16 rows, the append at all 7 widths for stablelm-12b's head_dim
   160 (80 words a head at AF16). paper_native's one kernel is
   paged_attention on bf16 rows (head_dim 64, 2 query heads a KV head).
   Each held to its plain version, timed beside its bound and library
   call (``per_tick_by_model`` in the kernels line).
3. serve full-width qwen3-8b (36 layers, bf16, AF16 weights and AF16 KV,
   random weights from a torch.Generator packed leaf by leaf on the
   card), 8 slots, max_seq_len 256, shared-prefix traffic (8 requests
   of one 64-token system prompt plus 8-32 token suffixes, 16 new
   tokens each): first with the dense KV cache, then paged (pages of 16
   rows, prefix pages shared) on the dense engine's weights; the greedy
   tokens must agree and the pool must drain back to empty. Then serve
   full-width deepseek-moe-16b (28 layers, 64 routed experts top-6 and 2
   shared, the same widths): 8 requests with prompts of 8-32 tokens, 8
   new tokens each, 8 slots, max_seq_len 64; then the four other
   families the same way (random weights packed on the card; the
   recurrent families feed their prompts a token a tick), paligemma also
   paged on the dense drain's weights with the same tokens. Before
   deepseek, on the
   qwen3 dense drain's weights, two speculative drains of the same
   requests (AF16 target, AF12 draft weights and AF12 draft KV, k = 4,
   greedy), dense then paged: the tokens must be the plain dense
   drain's, the counters the speculative path's (per tick k+1 draft
   bodies with k heads and k+1 verify bodies with k+1 heads; the draft
   prefills every position the target does) and a pool must drain to
   empty; each prints ms per tick, host issue time per tick,
   acceptance, tokens per slot-tick, ms per committed token beside the
   plain drain's and peak memory. For each drain the launch
   counters are zeroed just before it and read just after; every kernel
   of its path must have launched, exactly as often as the path's shape
   says (one pack launch, the KV append, per layer and decode call;
   of the packed_matmul launches, one transposed a decode call where
   the head is tied, by the wrapper's own count of that orientation),
   and unpack, convert and truncate not at all; the drain's last
   decode call is replayed under torch.profiler, as it runs and with
   the append as the eager composition, to count its device launches.
3g. the five zoo configs (``zoo_phase``), after the other drains:
   phi3-medium-14b (40 layers) and stablelm-12b (40) dense, paged and
   speculatively with their drafts (AF12, AF8; k = SPEC_K, dense KV);
   granite-34b at all 88 layers and arctic-480b cut to 2 of its 35, dense
   and paged; paper_native (plain bf16 weights and KV, no packing) dense
   and paged. 8 requests of 4-12 tokens (numpy seed 0), 4 new tokens,
   max_seq_len 64; the packing engines draw their weights slice by slice
   straight into the packed words. The tokens must agree across modes,
   each drain's launches be its path's (paper_native's dense path runs
   no kernel; its paged one, paged_attention on bf16 rows) and every
   peak stay under ZOO_PEAK_GB; ms per tick, host issue, launches a
   decode call, prefill s and peak memory printed per drain.
3b. after each model's drains, on the same engine's weights: ``LM.prefill``
   and then ``LM.loss`` of a batch of B = 2, T = 512 text tokens
   (whisper: T = 256 over 1,500 frames; paligemma adds its 256 image
   tokens), from a seeded generator, at full width and depth: seconds
   to a device sync, prefill tokens per second, peak memory, the loss,
   the launches (zeroed just before, read just after, held to the
   path's: ``prefill_launches``), and per kernel the event time around
   its calls in the prefill and in the loss (CUDA events around each
   wrapper call: its device time, plus the host's issue of the call
   where the stream was idle, so not a device time) beside the bound of
   its calls; the logits and the loss must be finite.
3c. training at full width through the port's ``Trainer``: qwen3-8b at 4
   layers, deepseek-moe-16b at 2 and whisper-small at its full depth,
   each for TRAIN_STEPS packed-master steps (repack every step, the
   staleness probe every step) and as many dense steps from the same
   seed; B = 2, T = 512 (whisper 256 over 1,500 random frames: the
   Trainer's zero frames overflow the encoder's gradient at this
   depth, in the reference too), lr 1e-3, bf16 weights and
   activations, AF16 codes and moments. Launch counters are zeroed just
   before each run and read just after; every step's launches must be
   the path's (``train_launches``: both matmul orientations, the banks,
   one take_rows, pack and unpack per leaf and moment), the run's the
   init's encodes plus the steps'. Held: packed losses within 1e-2 of
   dense at every step, staleness 0.0 after each repack, the final
   ``train.metrics`` event's keys exactly ``TRAIN_FINAL_KEYS``. Prints
   per run the step seconds to a device sync, tokens/s, peak memory,
   losses, staleness, weight-read bytes and a step's launches.
3d. calibration at full width: qwen3-8b cut to 4 layers, random
   weights from seed 0 (the engine's), calibrated through
   ``core.calibrate`` at the launchers' defaults (loss_delta 0.05 nats
   over 2 batches of B = 2, T = 16; max_seq_len 256). The search's
   trials are recorded; the launch counters, zeroed just before and read
   just after, must be one truncate and one convert (the tuner's round
   trip) per leaf below AF32 in each trial and in each of the two
   ``metric_at`` calls, and no other kernel; the plan must pass its
   gate. Prints seconds to a device sync, peak memory, evaluations, the
   plan's width histogram, metric and uniform metric, mean width and
   footprint, the int widths, and truncate and convert's event time a
   call. Each is held bit for bit to its plain version on the tuned
   plan's leaves and timed at the three largest leaves beside its bound
   and plain version (``calibrate`` in the kernels line). Then the
   calibrated plan, and a hand-written plan cycling the leaves through
   all seven widths (AF32 leaves stay plain), are served on the same
   weights with phase 3's qwen3-8b traffic: every leaf at its plan
   width, the drain's launches the path's (``plan_path_launches``;
   unpack, convert and truncate at 0), and the drain's last decode call
   replayed through the plain versions on the card, its logits within
   PLAIN_LOGIT_TOL of their largest magnitude.
3e. the paper's kernel-granularity flow (Fig. 7) on torch twins of the
   reference suite's Deferred, Hotspot, CFD and IMGVF kernels
   (``benchmarks/kernel_suite.py``, in its operation order). At the
   suite's 16 x 16 (inputs from numpy, seed 0), ``compress_kernel`` on
   the card and on the CPU at paper_suite.py's perfect and high
   thresholds, every trial's metric recorded: where the searches take
   the same decisions, the formats, int bits, both pressures, split
   counts and indirection-table words must be equal; a differing
   decision must lie within FLOW_GATE_MARGIN of the gate, is named, and
   then only the flow's properties are held. Trials within the margin
   are named either way. At 1,024 x 1,024 (Rodinia hotspot's largest
   grid), ``tune_kernel`` of each twin at high on the card: seconds to
   a device sync, evaluations, peak memory, and B8's launches, zeroed
   just before and read just after, held to one truncate and one
   convert per value below 32 bits in every recorded run; each tuned
   kernel's run with the CUDA B8 bit for bit against its run through
   B8's plain versions on the card; truncate and convert timed at one
   grid beside their bound and plain versions. Each allocation's
   ``PackedRegisterFile`` written and read across a warp's lanes on the
   card and on the CPU: the same lanes, storage and fetch and
   double-fetch counters. Then the paper's arithmetic on the host:
   Table 1's occupancy chain, the area table, and Fig. 9, 10 and 12's
   numbers from the flow's pressures (the cycle-level model of the
   paper's Fermi SM, not a measurement of this card).
3f. the static-analysis lint gate (``repro_torch.analysis``) on the
   card: ``run_lint`` of qwen3-8b (cut to 4 layers) and deepseek-moe-16b
   (2 layers) at full width, random weights from seed 0, the uniform
   AF16 plan: each report one info finding from each of the five passes
   (no warning: every entry point ran to its end, the donation pass's
   trace did not fail) and valid for the port's validator, the
   dispatch window's launches (zeroed just before, read just after)
   covering B1-B5 and, for deepseek, B6, and the proven KV widths and
   bounds (printed beside AF16's 65,504) those of the activation pass on
   the CPU over the same leaves. The reduced configs linted on the card
   and on the CPU from the same parameters: the same verdict, (check,
   severity, path) findings, KV widths and bounds. The lint CLI on the
   card, reduced qwen3-8b: the reference's broken plan exits 1 with its
   4 plan_soundness errors on their paths, and ``--inject-fallback``
   exits 1 with one "fell off the fused path" error finding (the card's
   refusal of the operand, recorded). Reports land in build/lint/.
4. cross-device parity, for each of the six models at 2 layers (the
   hybrid at 4: a group and a tail layer; whisper's encoder at 2) in
   f32: PARITY_STEPS decode_steps at full width on the card (kernels)
   against the CPU (plain versions) with the same packed weights,
   whisper over a cross cache of random values, then ``prefill`` and
   ``loss`` of one sequence of 64 tokens (the same tolerance, argmax
   equal); also the five zoo configs (arctic-480b at ZOO_PARITY_EXPERTS
   of its 128 experts; paper_native with its plain weights and KV); for
   deepseek and arctic also the number of routing choices
   (token, k) that differ between the two; for qwen3's reduced config
   (2 layers, f32) also the paged engine, card against CPU: the same
   tokens and pool counters, and every decode call of the card's drain
   replayed on the CPU from the same state; and for qwen3's reduced
   config the three speculative-serving paths: sampled drains (plain and
   speculative) with a fixed seed, twice on the card, the same tokens;
   one decode call with per-layer KV widths (16, 12), dense and paged,
   card against CPU (logits, cache words, each width's attention
   dispatched); greedy speculative drains, card tokens against the
   CPU's; and recurrentgemma's reduced config with a window of 8 and 4
   layers, drained on the card and on the CPU past its window (its
   attention ring wraps): the same tokens. Then one packed-master
   gradient of qwen3-8b, deepseek-moe-16b and whisper-small at 2 layers,
   full width, f32, over PARITY_T tokens, on the same AF16 codes and
   masters on the card and on the CPU: the loss within 1e-4 relative
   and every master's gradient within 1e-3 relative L2; deepseek's
   differing routing choices counted. Last, qwen3-8b's reduced config
   calibrated on the card and on the CPU from the same parameters and
   batches: the same plan and evaluations, the losses and metrics within
   CALIB_PARITY_RTOL of the loss, and no trial's metric within
   CALIB_GATE_MARGIN of the gate (the smallest distance printed). The
   kernel flow's card-against-CPU parity is phase 3e's.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds every kernel's numbers. Without a card, or without the rest of the
repository beside it (``src/repro_torch``), the script exits 2 before
printing either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM, TF32 on the tensor cores
L2_BYTES = 50 * 2**20
SLOTS, MAX_SEQ, NEW_TOKENS = 8, 256, 16
SPEC_K = 4                       # drafted tokens per speculative tick
# the prefill phase's batch: sequences, text tokens (whisper's decoder
# takes WHISPER_T over its 1,500 frames); the parity's tokens
PREFILL_B, PREFILL_T, WHISPER_T, PARITY_T = 2, 512, 256, 64
PARITY_STEPS = 2                 # full-width decode steps held to the CPU
# phase 3c: depth of each trained model (whisper: all of it), steps of
# each run, the packed-master losses' tolerance against dense
# (BENCH_train_packed.json's loss_rtol); phase 4's gradient tolerance
TRAIN_LAYERS = {"qwen3-8b": 4, "deepseek-moe-16b": 2}
TRAIN_STEPS, TRAIN_LOSS_RTOL, GRAD_RTOL = 3, 1e-2, 1e-3
# phase 3d: the calibration gate (loss_delta, nats; the launchers'
# default); elements per chunk of the plain versions' bit checks; the
# largest leaf whose plain versions are timed whole; a plan-served decode
# call's logits against the plain versions, relative to their largest
# magnitude. Phase 4: card-against-CPU calibration metrics, relative to
# the loss, and the least distance of any trial's metric from the gate
CALIB_GATE, CALIB_CHECK_CHUNK, CALIB_PLAIN_TIMED_MAX = 0.05, 2**25, 2**28
PLAIN_LOGIT_TOL = 2e-2
CALIB_PARITY_RTOL, CALIB_GATE_MARGIN = 1e-4, 5e-4
# the qwen3-8b drains: a system prompt shared by every request, suffix
# lengths from, to; the paged drain's page size
SYSTEM_PROMPT, SUFFIXES, PAGE = 64, (8, 32), 16
# the deepseek-moe-16b drain: (prompt lengths from, to), new tokens, max_seq_len
MOE_PROMPTS, MOE_NEW_TOKENS, MOE_MAX_SEQ = (8, 32), 8, 64
# the four other families, drained as deepseek-moe-16b is (its prompt
# lengths, new tokens and max_seq_len); paligemma also paged
FAMILY_ARCHS = ("paligemma_3b", "whisper_small", "falcon_mamba_7b",
                "recurrentgemma_9b")
# phases 2f, 3g and 4: the five zoo configs, each drained on 8 requests
# of (prompt lengths from, to) tokens, new tokens, max_seq_len;
# arctic-480b cut to ZOO_LAYERS of its 35 layers (all 35 take 954 GB at
# AF16), the others at full depth (granite-34b's 88 layers through the
# packed init, held under ZOO_PEAK_GB); the speculating configs and
# their draft widths (granite-34b's AF12 draft would not fit beside its
# 68 GB: it speculates on the CPU only); phase 4's arctic at
# ZOO_PARITY_EXPERTS of its 128 experts (f32 at full width holds two
# copies of ~13 B expert parameters a layer otherwise)
ZOO_ARCHS = ("phi3_medium_14b", "stablelm_12b", "granite_34b", "arctic_480b",
             "paper_native")
ZOO_PROMPTS, ZOO_NEW_TOKENS, ZOO_MAX_SEQ = (4, 12), 4, 64
ZOO_LAYERS = {"arctic-480b": 2}
ZOO_DRAFTS = {"phi3-medium-14b": 12, "stablelm-12b": 8}
ZOO_PEAK_GB, ZOO_PARITY_EXPERTS = 80.0, 16
BANK_CHUNK = 2**31                # f32 bytes of a bank decoded at once
BF16_TOL = 2.0 ** -8             # one bf16 rounding of the f32 result
FLOAT_MANTISSA = {16: 10, 12: 7}  # AF16 e5m10, AF12 e4m7

KERNELS = {
    "packed_matmul": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                      "src/repro/kernels/packed_matmul.py:160"),
    "pack": ("src/repro_torch/kernels/csrc/pack.cu",
             "src/repro/kernels/pack.py:37"),
    "kv_decode": ("src/repro_torch/kernels/csrc/kv_decode.cu",
                  "src/repro/kernels/kv_decode.py:85"),
    "take_rows": ("src/repro_torch/kernels/csrc/unpack.cu",
                  "src/repro/kernels/take.py:51"),
    "packed_matmul_batched": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                              "src/repro/kernels/packed_matmul.py:279"),
    "paged_attention": ("src/repro_torch/kernels/csrc/kv_decode.cu",
                        "src/repro/kernels/paged_attention.py:111"),
    "unpack": ("src/repro_torch/kernels/csrc/unpack.cu",
               "src/repro/kernels/unpack.py:42"),
    "convert": ("src/repro_torch/kernels/csrc/convert.cu",
                "src/repro/kernels/convert.py:49"),
    "truncate": ("src/repro_torch/kernels/csrc/convert.cu",
                 "src/repro/kernels/convert.py:61"),
}
WIDTHS = (8, 12, 16, 20, 24, 28, 32)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def matmul_rate(x_dtype, bits: int) -> float:
    """The peak rate of packed_matmul's multiplies: TF32 on the tensor
    cores for bf16 x against AF8-AF16 codes (both exact in TF32), f32
    FMAs otherwise."""
    import torch
    return TF32_FLOPS if x_dtype == torch.bfloat16 and bits <= 16 \
        else F32_FLOPS


def _window_ms(torch, calls, iters: int, hold_cycles: int = 0):
    """Event time of ``iters`` calls cycling through ``calls``, and the
    host's time to issue them; with ``hold_cycles`` the stream first
    spins that long, so the calls queue up behind it and the events time
    the card's work alone."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_cycles:
        torch.cuda._sleep(hold_cycles)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        calls[i % len(calls)]()
    issue = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), issue


def time_ms(torch, calls, iters: int):
    """(ms, issue_ms) per call, after a warm-up. ``ms`` is the card's
    time: the calls are issued while the stream spins (torch.cuda._sleep)
    for longer than issuing them takes, so host launch overhead is out
    of the window. ``issue_ms`` is the host's time to issue one call;
    where it exceeds ``ms``, a loop of such calls is bound by the host.
    Should the host still be issuing when the spin ends, ``ms`` includes
    some of its time and is an upper bound on the card's."""
    for c in calls[:2]:
        c()
    _, issue = _window_ms(torch, calls, iters)
    # ~2 cycles per ns at the H100's clocks: hold for 3x the issue time
    hold = int((3 * issue + 2.0) * 2e6)
    ms, _ = _window_ms(torch, calls, iters, hold)
    return ms / iters, issue / iters


def copies_for(nbytes: int) -> int:
    """Operand copies whose total exceeds the L2 three times over."""
    return max(1, math.ceil(3 * L2_BYTES / max(nbytes, 1)))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def tick_summary(per_call):
    """One kernel's numbers per decode tick: the calls of a tick times
    one call's time, over the shapes the tick runs; the error over every
    shape checked."""
    tick = [r for r in per_call if r["calls_per_tick"]]
    lib = [r["library_ms"] for r in tick]
    return {
        "max_abs_err": max(r["max_err"] for r in per_call),
        "ms": sum(r["calls_per_tick"] * r["kernel_ms"] for r in tick),
        "plain_ms": sum(r["calls_per_tick"] * r["plain_ms"] for r in tick),
        "bound_ms": sum(r["calls_per_tick"] * r["bound_ms"] for r in tick),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in tick)
        else "operations",
        "library_ms": None if None in lib else sum(
            r["calls_per_tick"] * r["library_ms"] for r in tick),
        "calls_per_tick": sum(r["calls_per_tick"] for r in tick),
    }


def width_summary(recs, calls_key):
    """One width's numbers per pass: ``calls_key`` calls of each record
    times its one-call numbers, summed."""
    lib = [r["library_ms"] for r in recs]
    return {
        "max_abs_err": max(r["max_err"] for r in recs),
        "ms": sum(r[calls_key] * r["kernel_ms"] for r in recs),
        "plain_ms": sum(r[calls_key] * r["plain_ms"] for r in recs),
        "bound_ms": sum(r[calls_key] * r["bound_ms"] for r in recs),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in recs)
        else "operations",
        "library_ms": None if None in lib else sum(
            r[calls_key] * r["library_ms"] for r in recs),
        "calls": sum(r[calls_key] for r in recs),
    }


def matmul_case(torch, ops, ref, gen, model, k, n, calls, transpose, xdt,
                bits, draft_calls=0, rows=SLOTS, prefill_calls=0,
                train_calls=0):
    """One product x (rows, K) @ W at ``bits``, W (K, N), or (N, K)
    packed along K when ``transpose``: held to the plain version, timed
    with W rotated past the L2, beside the plain version, cuBLAS on the
    decoded bf16 W and the bound (``matmul_rate``)."""
    wshape = (n, k) if transpose else (k, n)
    w = torch.randn(wshape, generator=gen, device="cuda") / math.sqrt(k)
    wp = ops.pack(w, bits)
    w_lib = (ref.unpack_ref(wp, bits, k if transpose else n)
             .to(torch.bfloat16))
    del w
    x = torch.randn((rows, k), generator=gen, device="cuda").to(xdt)
    got = ops.packed_matmul(x, wp, bits, n, transpose)
    want = ref.packed_matmul_ref(x, wp, bits, n, transpose)
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    tol = (BF16_TOL if xdt == torch.bfloat16 else 1e-5) * scale + 1e-4
    assert got.dtype == xdt and got.shape == (rows, n)
    assert torch.isfinite(got).all().item()
    if err > tol:
        raise AssertionError(f"packed_matmul K={k} N={n} T={transpose} "
                             f"{xdt} AF{bits}: max err {err} > tol {tol}")
    wbytes = wp.numel() * 4
    reps = [wp] + [wp.clone() for _ in range(copies_for(wbytes) - 1)]
    libs = [w_lib] + [w_lib.clone() for _ in range(
        copies_for(w_lib.numel() * 2) - 1)]
    calls_k = [lambda r=r: ops.packed_matmul(x, r, bits, n, transpose)
               for r in reps]
    ms, issue = time_ms(torch, calls_k, 50)
    plain = time_ms(torch, [lambda: ref.packed_matmul_ref(
        x, wp, bits, n, transpose)], 3)[0]
    lib = time_ms(torch, [lambda r=r: torch.matmul(
        x.to(torch.bfloat16), r.t() if transpose else r) for r in libs],
        50)[0]
    b_ms, b_by = bound(wbytes + x.numel() * x.element_size()
                       + got.numel() * got.element_size(),
                       2.0 * rows * n * k, matmul_rate(xdt, bits))
    rec = {"kernel": "packed_matmul", "model": model, "M": rows, "K": k,
           "N": n, "transpose": transpose, "x_dtype": str(xdt).split(".")[-1],
           "bits": bits, "calls_per_tick": calls,
           "draft_calls_per_pass": draft_calls,
           "calls_per_prefill": prefill_calls,
           "calls_per_train_step": train_calls, "max_err": err,
           "tol": tol, "kernel_ms": ms, "host_issue_ms": issue,
           "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib}
    log(json.dumps(rec))
    del reps, libs, wp, w_lib, got, want
    torch.cuda.empty_cache()
    return rec


def check_packed_matmul(torch, ops, ref, gen, cfg):
    """Every 2-D product of a decode tick, M = slots, bf16 x (f32 for the
    MoE router), AF16 W; for qwen3-8b also f32 x, the tied-head
    orientation, AF8 W on the w_up shape (no tick runs it) and every
    product of the speculative draft's pass at AF12 (the seven per-layer
    weights, four shapes, and lm_head), beside cuBLAS on the decoded
    bf16 weights."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    L = cfg.n_layers
    bf, f32 = torch.bfloat16, torch.float32
    # (K, N, calls per decode tick, transpose, x dtype, bits); the AF12
    # cases are the draft's, with their calls per draft pass
    draft_calls = {}
    if cfg.family == "moe":
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        cases = [(d, hq, 2 * L, False, bf, 16),           # wq, wo
                 (d, hkv, 2 * L, False, bf, 16),          # wk, wv
                 (d, cfg.n_experts, L, False, f32, 16),   # router
                 (d, fs, 2 * L, False, bf, 16),           # shared w_in, w_gate
                 (fs, d, L, False, bf, 16),               # shared w_out
                 (d, v, 1, False, bf, 16)]                # lm_head
    else:
        cases = [(d, hq, 2 * L, False, bf, 16),           # wq, wo
                 (d, hkv, 2 * L, False, bf, 16),          # wk, wv
                 (d, f, 2 * L, False, bf, 16),            # w_in, w_gate
                 (f, d, L, False, bf, 16),                # w_out
                 (d, v, 1, False, bf, 16),                # lm_head
                 (d, hkv, 0, False, f32, 16),             # f32 activations
                 (d, d, 0, True, bf, 16),                 # tied head
                 (d, f, 0, False, bf, 8)]                 # w_up at AF8
        draft_calls = {(d, hq): 2 * L, (d, hkv): 2 * L, (d, f): 2 * L,
                       (f, d): L, (d, v): 1}
        cases += [(k, n, 0, False, bf, 12) for k, n in draft_calls]
    per_call = [matmul_case(torch, ops, ref, gen, cfg.name, k, n, calls,
                            transpose, xdt, bits,
                            draft_calls.get((k, n), 0) if bits == 12 else 0)
                for k, n, calls, transpose, xdt, bits in cases]
    w_up = {r["bits"]: r["kernel_ms"] for r in per_call
            if (r["K"], r["N"], r["transpose"]) == (d, f, False)
            and r["x_dtype"] == "bfloat16"}
    if len(w_up) > 1:
        log(f"packed_matmul {cfg.name} w_up ({d}, {f}), bf16 x, us per call: "
            + ", ".join(f"AF{b} {w_up[b] * 1e3:.2f}" for b in sorted(w_up)))
    summary = tick_summary(per_call)
    draft = [r for r in per_call if r["draft_calls_per_pass"]]
    if draft:
        summary["per_width"] = {"AF12 draft pass": width_summary(
            draft, "draft_calls_per_pass")}
        log(f"packed_matmul {cfg.name} AF12 draft pass (one decode body "
            "with its head): " + json.dumps(
                summary["per_width"]["AF12 draft pass"]))
    return summary


def _special_rows(torch, gen, rows, n):
    x = torch.randn((rows, n), generator=gen, device="cuda")
    x = x * torch.exp2(torch.randint(-30, 30, (rows, n), generator=gen,
                                     device="cuda").float())
    sp = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1e-40,
                       65504.0, 65520.0, 5.96e-8, 2.98e-8, 1.0 + 2**-11],
                      device="cuda")
    x.view(-1)[: sp.numel()] = sp
    return x


def eager_append(ops, ref):
    """The KV append as the port ran it on the card before the append
    kernel: per row a ``.float()`` widening and a ``pack`` launch, then
    an index_put at the row (dense: a clamp and an arange; paged: the
    table gather of ``pool_row_index``). For ``ops.append_kv_rows``'s
    place in timings and launch counts."""
    def append(k_cache, v_cache, k_new, v_new, kv_len, bits, table=None):
        b = k_new.shape[0]
        rows = [ops.pack(x.reshape(b, -1).float(), bits).reshape(
            b, x.shape[1], -1) for x in (k_new, v_new)]
        if table is None:
            for cache, row in zip((k_cache, v_cache), rows):
                ref.write_rows(cache, row, kv_len)
            return
        idx = ref.pool_row_index(k_cache.shape[1], table, kv_len)
        for cache, row in zip((k_cache, v_cache), rows):
            ref.scatter_pool_rows(cache, row, idx)
    return append


def _append_case(torch, gen, layout, hkv, w, seq, lens, table_rows=None):
    """Random int32 caches (K, V) for the append and its row inputs:
    dense (slots, seq, hkv, w), or paged pools of ``seq``-row pages
    through ``table_rows``."""
    if layout == "dense":
        shape, table = (SLOTS, seq, hkv, w), None
    else:
        table = torch.tensor(table_rows, dtype=torch.int32, device="cuda")
        shape = (int(table.max().item()) + 1, seq, hkv, w)
    caches = [torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                            dtype=torch.int32, device="cuda")
              for _ in range(2)]
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return caches, kv_len, table


def _shared_rows(ref, page, kv_len, table):
    """Pool rows that two or more slots write (idle slots on the scrap
    page): which write lands there is not fixed."""
    from collections import Counter

    if table is None:
        return []
    idx = ref.pool_row_index(page, table, kv_len).tolist()
    return [r for r, c in Counter(idx).items() if c > 1]


def check_pack(torch, ops, ref, gen, cfg):
    """``ops.pack`` on the KV row operand (slots, Hkv * head_dim), f32 and
    bf16 at all 7 widths (bit-exact), timed at AF16 beside the library
    call. The KV append (``ops.append_kv_rows``, the tick's pack launch)
    against its plain version at all 7 widths, dense and paged, bf16 and
    f32 rows from strided views and contiguous ones, clamped lengths and
    idle slots on the scrap page included (bit-exact on every row that
    one slot writes);
    timed per layer at AF16 at the tick's shape, dense and paged, beside
    the eager composition it replaced, each with its host issue time."""
    hkv, d = cfg.n_kv_heads, cfg.resolved_head_dim
    n = hkv * d
    x = _special_rows(torch, gen, SLOTS, n)
    for bits in WIDTHS:
        for src in (x, x.to(torch.bfloat16)):
            got = ops.pack(src, bits)
            want = ref.pack_ref(src, bits)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pack AF{bits} {src.dtype}: words "
                                     "differ")
    # the append: (name, slot lengths, table rows); dense lengths at and
    # past S = 16 clamp to row 15; the paged case's slot 4 runs past its
    # table, and slots 5-7 are idle (table rows all the scrap page 0;
    # slots 5 and 6 write its row 0)
    mp = 4
    live = [[1 + 4 * b + j for j in range(mp)] for b in range(5)]
    cases = [("dense", [0, 1, 15, 16, 17, 40, 7, 3], None),
             ("paged", [0, 5, 15, 16, 99, 0, 4, 9],
              live + [[0] * mp] * 3)]
    checked = 0
    for bits in WIDTHS:
        w = -(-d // 32) * bits
        for layout, lens, table_rows in cases:
            seq = 16 if layout == "dense" else PAGE // 4
            (kc, vc), kv_len, table = _append_case(torch, gen, layout, hkv, w,
                                                   seq, lens, table_rows)
            shared = _shared_rows(ref, seq, kv_len, table)
            assert bool(shared) == (layout == "paged")
            for dt, dense_rows in itertools.product(
                    (torch.bfloat16, torch.float32), (False, True)):
                proj = _special_rows(torch, gen, SLOTS, 3 * n).to(dt)
                # a strided view (value stride 3) and a transposed one, or
                # contiguous rows as the model gives them
                k = proj.reshape(SLOTS, hkv, 3 * d)[:, :, ::3]
                v = (_special_rows(torch, gen, hkv * SLOTS, d).to(dt)
                     .reshape(hkv, SLOTS, d).transpose(0, 1))
                if dense_rows:
                    k, v = k.contiguous(), v.contiguous()
                got, want = [kc.clone(), vc.clone()], [kc.clone(), vc.clone()]
                ops.append_kv_rows(*got, k, v, kv_len, bits, table)
                ref.append_kv_rows_ref(*want, k, v, kv_len, bits, table)
                torch.cuda.synchronize()
                for g, wt in zip(got, want):
                    g = g.reshape((-1,) + g.shape[2:])
                    wt = wt.reshape((-1,) + wt.shape[2:])
                    if shared:
                        g[shared], wt[shared] = 0, 0
                    if not torch.equal(g, wt):
                        raise AssertionError(
                            f"append {layout} AF{bits} {dt}: words differ")
                checked += 1
    log(f"pack {cfg.name}: ops.pack f32 and bf16 and the append ({checked} "
        "cases: 7 widths, dense and paged, bf16 and f32, strided views and "
        "contiguous rows, clamped and scrap rows) bit-identical to the "
        "plain versions")

    x16 = torch.randn((SLOTS, n), generator=gen, device="cuda")
    # the library call: AF16 is IEEE half, and 32 half codes are 16
    # little-endian words (NaN inputs would differ: no NaN here)
    if not torch.equal(ops.pack(x16, 16),
                       x16.to(torch.float16).view(torch.int32)):
        raise AssertionError("pack AF16: the library call's words differ")
    ms, issue = time_ms(torch, [lambda: ops.pack(x16, 16)], 200)
    plain = time_ms(torch, [lambda: ref.pack_ref(x16, 16)], 20)[0]
    lib = time_ms(torch, [lambda: x16.to(torch.float16).view(torch.int32)],
                  200)[0]
    out_words = SLOTS * n // 32 * 16
    b_ms, b_by = bound(x16.numel() * 4 + out_words * 4, 0.0)
    per_call = [{"kernel": "pack", "case": "ops.pack", "model": cfg.name,
                 "shape": [SLOTS, n], "widths": "all 7", "calls_per_tick": 0,
                 "max_err": 0.0, "tol": 0.0, "kernel_ms": ms,
                 "host_issue_ms": issue, "plain_ms": plain, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib}]
    log(json.dumps(per_call[0]))

    # the append per layer at the tick's shape: bf16 rows, AF16 caches,
    # lengths near the drain's; paged through pages of the drain's size
    seq = MAX_SEQ if cfg.family != "moe" else MOE_MAX_SEQ
    lens = [72, 80, 88, 96, 104, 112, 76, 92]
    mp = seq // PAGE
    tables = [[1 + mp * b + j for j in range(mp)] for b in range(SLOTS)]
    eager = eager_append(ops, ref)
    per_width = {}
    cases = [("dense", cfg.n_layers, 16), ("paged", 0, 16)]
    if cfg.family != "moe":          # the speculative draft's AF12 cache
        cases += [("dense", 0, 12), ("paged", 0, 12)]
    for layout, calls, bits in cases:
        w = -(-d // 32) * bits
        (kc, vc), kv_len, table = _append_case(
            torch, gen, layout, hkv, w, seq if layout == "dense" else PAGE,
            lens, tables)
        k, v = (torch.randn((SLOTS, 1, hkv, d), generator=gen,
                            device="cuda").to(torch.bfloat16)[:, 0]
                for _ in range(2))
        args = (kc, vc, k, v, kv_len, bits, table)
        ms, issue = time_ms(torch, [lambda: ops.append_kv_rows(*args)], 200)
        e_ms, e_issue = time_ms(torch, [lambda: eager(*args)], 200)
        plain = time_ms(torch, [lambda: ref.append_kv_rows_ref(*args)], 20)[0]
        # K and V read once, their words written once, kv_len (and the
        # table entry a slot reads)
        nbytes = 2 * SLOTS * n * 2 + 2 * SLOTS * hkv * w * 4 + SLOTS * 4 \
            + (SLOTS * 4 if table is not None else 0)
        b_ms, b_by = bound(nbytes, 0.0)
        rec = {"kernel": "pack", "case": f"append {layout}", "model": cfg.name,
               "rows": [SLOTS, hkv, d], "bits": bits, "calls_per_tick": calls,
               "max_err": 0.0, "tol": 0.0, "kernel_ms": ms,
               "host_issue_ms": issue, "eager_ms": e_ms,
               "eager_host_issue_ms": e_issue, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        log(json.dumps(rec))
        per_call.append(rec)
        if bits != 16:
            per_width[f"AF{bits} append {layout}"] = width_summary(
                [dict(rec, calls=1)], "calls")
    summary = tick_summary(per_call)
    summary["pack_call"] = {"ms": per_call[0]["kernel_ms"],
                            "library_ms": per_call[0]["library_ms"]}
    if per_width:
        summary["per_width"] = per_width
    return summary


def kv_case(torch, F, ops, ref, gen, model, h, hkv, d, seq, lens, bits,
            calls, timed=True, case="self"):
    """q (slots, h, d) bf16 against a random cache (slots, seq, hkv, d)
    packed at ``bits``, masked at ``lens``: held to the plain version
    (a slot of length 0 gives zeros); when ``timed``, timed with the
    cache rotated past the L2 beside the plain version, SDPA on the
    decoded bf16 cache and the bound."""
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((SLOTS, h, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    kv_shape = (SLOTS, seq, hkv, d)
    kp = ops.pack(torch.randn(kv_shape, generator=gen, device="cuda"), bits)
    vp = ops.pack(torch.randn(kv_shape, generator=gen, device="cuda"), bits)
    got = ops.kv_decode(q, kp, vp, kv_len, bits, d)
    want = ref.kv_decode_ref(q, kp, vp, bits, d, kv_len)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL * want.float().abs().max().item() + 1e-3
    empty = [b for b, n in enumerate(lens) if n == 0]
    if err > tol or (empty and got[empty].any().item()):
        raise AssertionError(f"kv_decode {model} {case} AF{bits}: max err "
                             f"{err} > tol {tol}, or kv_len == 0 not zero")
    if not timed:
        log(json.dumps({"kernel": "kv_decode", "model": model, "case": case,
                        "bits": bits, "q": list(q.shape), "S": seq,
                        "max_err": err, "tol": tol, "checked_only": True}))
        return {"max_err": err, "calls_per_tick": 0}
    cache_bytes = kp.numel() * 4 * 2
    reps = [(kp, vp)] + [(kp.clone(), vp.clone())
                         for _ in range(copies_for(cache_bytes) - 1)]
    calls_k = [lambda r=r: ops.kv_decode(q, r[0], r[1], kv_len, bits, d)
               for r in reps]
    ms, issue = time_ms(torch, calls_k, 100)
    plain = time_ms(torch, [lambda: ref.kv_decode_ref(
        q, kp, vp, bits, d, kv_len)], 10)[0]
    group = h // hkv
    kd, vd = (ref.unpack_ref(x, bits, d, torch.bfloat16).transpose(1, 2)
              .repeat_interleave(group, dim=1).contiguous()
              for x in (kp, vp))
    mask = (torch.arange(seq, device="cuda")[None, None, None, :]
            < kv_len[:, None, None, None])
    q4 = q[:, :, None, :]
    lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask)], 100)[0]
    live = kv_len.clamp(max=seq).sum().item()
    row_bytes = hkv * kp.shape[-1] * 4
    b_ms, b_by = bound(2 * live * row_bytes + 2 * q.numel() * 2
                       + 4 * SLOTS, 4.0 * h * d * live)
    rec = {"kernel": "kv_decode", "model": model, "case": case, "bits": bits,
           "q": list(q.shape), "S": seq, "Hkv": hkv, "kv_len": lens,
           "calls_per_tick": calls, "max_err": err, "tol": tol,
           "kernel_ms": ms, "host_issue_ms": issue, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    log(json.dumps(rec))
    del reps, kd, vd, kp, vp
    torch.cuda.empty_cache()
    return rec


def check_kv_decode(torch, F, ops, ref, gen, cfg, seq):
    """q (slots, heads, head_dim) bf16 against an AF16 cache of ``seq``
    rows (the drain's max_seq_len), mixed lengths including 0 and one
    past S; timed there. For a dense config (qwen3-8b, phase 2f's three)
    also an AF12 cache of the same shape (the speculative draft's),
    timed, and AF8 and AF32 caches, checked only (no tick runs them)."""
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lens = [0, 1, 7, seq // 4, seq * 25 // 64, seq * 25 // 32, seq, seq + 3]
    per_call, per_width = [], {}
    for bits in ((8, 32, 12, 16) if cfg.family != "moe" else (16,)):
        rec = kv_case(torch, F, ops, ref, gen, cfg.name, h, hkv, d, seq,
                      lens, bits, cfg.n_layers if bits == 16 else 0,
                      timed=bits in (12, 16))
        per_call.append(rec)
        if bits == 12:
            per_width["AF12"] = width_summary([dict(rec, calls=1)], "calls")
    summary = tick_summary(per_call)
    if per_width:
        summary["per_width"] = per_width
    return summary


def _paged_layout(np, lens, page, max_pages, shared):
    """A (slots, max_pages) page table for ``lens``: each slot's live
    pages are distinct shuffled ids from 1, except that slot b2 shares
    slot b1's first n pages for each (b1, b2, n) of ``shared``; entries
    past a slot's live pages are the scrap page 0. Returns (table, pool
    pages with the scrap page, distinct live pages)."""
    live = [-(-n // page) for n in lens]
    table = np.zeros((len(lens), max_pages), np.int32)
    owned = {(b2, j) for b1, b2, n in shared for j in range(n)}
    n_own = sum(live) - len(owned)
    ids = iter(np.random.default_rng(0).permutation(n_own) + 1)
    for b, n in enumerate(live):
        for j in range(n):
            if (b, j) not in owned:
                table[b, j] = next(ids)
    for b1, b2, n in shared:
        table[b2, :n] = table[b1, :n]
    return table, n_own + 1, n_own


def _rows_read(table, lens, page):
    """What a call through ``table`` must read at least: the distinct
    pool rows below each slot's length (a shared page counted once, up
    to the longest length naming it) and the table entries of the live
    pages."""
    rows, entries = {}, 0
    for b, n in enumerate(lens):
        n = min(n, table.shape[1] * page)
        for j in range(-(-n // page)):
            p = int(table[b, j])
            rows[p] = max(rows.get(p, 0), min(page, n - j * page))
            entries += 1
    return sum(rows.values()), entries


def paged_cases(cfg):
    """``check_paged_attention``'s cases: (name, lengths, table width,
    shared pages (b1, b2, n), calls per decode tick, widths). The check
    case: lengths 0, 1, 15, 16, 17, 255, 200 (sharing 12 pages with the
    255) and 4096. qwen3-8b's tick: every slot sharing the 64-token
    system prompt's pages, lengths near its drain's; checked at AF16,
    AF8 and on bf16 rows, its tick at AF16 and AF12 (the speculative
    draft's cache). paligemma-3b (head_dim 256, 8 query heads a KV
    head): the check case and its paged drain's tick (prompts of 8-32
    tokens and 8 new, no shared prefix, MOE_MAX_SEQ rows), at AF16."""
    check = ("check", [0, 1, 15, 16, 17, 255, 200, 4096], 4096 // PAGE,
             [(5, 6, 12)], 0)
    if cfg.family == "vlm":
        return [check + ((16,),),
                ("tick", [9, 14, 20, 25, 31, 33, 38, 40],
                 MOE_MAX_SEQ // PAGE, [], cfg.n_layers, (16,))]
    return [check + ((16, 8, 0),),
            ("tick", [72, 80, 88, 96, 104, 112, 76, 92], MAX_SEQ // PAGE,
             [(0, b, SYSTEM_PROMPT // PAGE) for b in range(1, SLOTS)],
             cfg.n_layers, (16, 12))]


def check_paged_attention(torch, F, ops, ref, gen, cfg, cases=None):
    """q (slots, heads, head_dim) bf16 through a page table of shuffled
    ids over AF16, AF8 and bf16-row pools (page 16) in ``cases``
    (``paged_cases``' by default); the scrap page holds large finite
    poison. Held to the plain version within tolerance, bit for bit to
    kv_decode over the same rows laid out dense, and to itself with a
    clean scrap page. Timed at AF16 and AF12, and the tick case at every
    width it lists, beside the plain version, SDPA and the bound; the
    calls a tick are the tick case's at the config's KV width (0: bf16
    rows)."""
    import numpy as np

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kv_bits = cfg.compression.kv_bits or 0
    per_call, per_width = [], {}
    for name, lens, max_pages, shared, calls, widths in (
            cases or paged_cases(cfg)):
        table_np, pool_pages, n_live = _paged_layout(np, lens, PAGE,
                                                     max_pages, shared)
        table = torch.from_numpy(table_np).cuda()
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn((SLOTS, h, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
        rows = torch.randn((2, pool_pages, PAGE, hkv * d), generator=gen,
                           device="cuda")
        for bits in widths:
            poison, clean = rows.clone(), rows.clone()
            poison[:, 0] = 10.0 if bits else 1e4
            clean[:, 0] = 0.0
            pools = {}
            for key, r in (("poison", poison), ("clean", clean)):
                pk, pv = (ops.pack(x, bits) if bits else x.to(torch.bfloat16)
                          for x in r)
                pools[key] = [x.reshape(pool_pages, PAGE, hkv, -1)
                              for x in (pk, pv)]
            kp, vp = pools["poison"]
            got = ops.paged_attention(q, kp, vp, table, kv_len, bits, d)
            want = ref.paged_attention_ref(q, kp, vp, table, kv_len, bits, d)
            again = ops.paged_attention(q, *pools["clean"], table, kv_len,
                                        bits, d)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = BF16_TOL * want.float().abs().max().item() + 1e-3
            if err > tol or (lens[0] == 0 and got[0].any().item()):
                raise AssertionError(
                    f"paged_attention {name} AF{bits}: max err {err} > tol "
                    f"{tol}, or kv_len == 0 not zero")
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name} AF{bits}: the "
                                     "scrap page's poison moved the output")
            if bits:
                dense = ops.kv_decode(q, ref.gather_pages_ref(kp, table),
                                      ref.gather_pages_ref(vp, table), kv_len,
                                      bits, d)
                if not torch.equal(dense, got):
                    raise AssertionError(
                        f"paged_attention {name} AF{bits}: not bit-identical "
                        "to kv_decode on the same rows laid out dense")
            log(json.dumps({"kernel": "paged_attention", "model": cfg.name,
                            "case": name, "bits": bits, "q": list(q.shape),
                            "max_err": err, "tol": tol,
                            "bit_identical_to_kv_decode": bool(bits)}))
            if bits not in (12, 16) and name != "tick":
                per_call.append({"max_err": err, "calls_per_tick": 0})
                continue
            page_bytes = PAGE * hkv * kp.shape[-1] * kp.element_size()
            pool_bytes = 2 * pool_pages * page_bytes
            reps = [(kp, vp)] + [(kp.clone(), vp.clone())
                                 for _ in range(copies_for(pool_bytes) - 1)]
            calls_k = [lambda r=r: ops.paged_attention(q, r[0], r[1], table,
                                                       kv_len, bits, d)
                       for r in reps]
            ms, issue = time_ms(torch, calls_k, 100)
            plain = time_ms(torch, [lambda: ref.paged_attention_ref(
                q, kp, vp, table, kv_len, bits, d)], 10)[0]
            group = h // hkv
            kd, vd = ((ref.unpack_ref(ref.gather_pages_ref(x, table), bits,
                                      d, torch.bfloat16) if bits
                       else ref.gather_pages_ref(x, table)).transpose(1, 2)
                      .repeat_interleave(group, dim=1).contiguous()
                      for x in (kp, vp))
            seq = kd.shape[2]
            mask = (torch.arange(seq, device="cuda")[None, None, None, :]
                    < kv_len[:, None, None, None])
            q4 = q[:, :, None, :]
            lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask)], 100)[0]
            rows_live = kv_len.clamp(max=seq).sum().item()
            rows_read, entries = _rows_read(table_np, lens, PAGE)
            b_ms, b_by = bound(2 * rows_read * page_bytes // PAGE
                               + 2 * q.numel() * 2 + entries * 4 + 4 * SLOTS,
                               4.0 * h * d * rows_live)
            rec = {"kernel": "paged_attention", "model": cfg.name,
                   "case": name, "bits": bits, "q": list(q.shape),
                   "page": PAGE,
                   "max_pages": table.shape[1], "kv_len": lens,
                   "live_pages": n_live, "rows_read": rows_read,
                   "calls_per_tick": calls if bits == kv_bits else 0,
                   "max_err": err, "tol": tol, "kernel_ms": ms,
                   "host_issue_ms": issue, "plain_ms": plain,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
            log(json.dumps(rec))
            per_call.append(rec)
            if bits != kv_bits:
                per_width[f"AF{bits} {name}"] = width_summary(
                    [dict(rec, calls=1)], "calls")
            del reps, kd, vd
        del rows, pools
        torch.cuda.empty_cache()
    summary = tick_summary(per_call)
    summary["per_width"] = per_width
    return summary


def check_take_rows(torch, F, ops, ref, gen, cfg):
    """Gather slots rows of the AF16 embedding table to bf16, bit for bit,
    timed with the same rows every call (warm in the L2) and with fresh
    rows every call (cold); every AF8/AF12/AF16 code through the decoder;
    NaN codes of both signs to bf16 bit for bit against the plain version
    at all 7 widths (sign | 0x7FC0). For qwen3-8b also the (B, T) embed
    shape, slots x max_seq_len rows, to bf16 and f32, beside its bound."""
    from repro_torch.core import bitpack

    v, d = cfg.vocab_size, cfg.d_model
    bf = torch.bfloat16
    table = ops.pack(torch.randn((v, d), generator=gen, device="cuda")
                     * 0.02, 16)
    words = table.shape[1]
    idx = torch.tensor([5, v - 1, 0, 77777, 5, 123, 9999, 5],
                       dtype=torch.int32, device="cuda")
    got = ops.take_rows(table, idx, 16, d, out_dtype=bf)
    _expect_same_bits(torch, got, ref.take_rows_ref(table, idx, 16, d,
                                                    out_dtype=bf),
                      "take_rows tick")
    for bits in (8, 12, 16):
        codes = torch.arange(2**bits, device="cuda").to(torch.int32)
        tab = bitpack.pack_groups(codes.reshape(-1, 32), bits)
        ix = torch.arange(tab.shape[0], dtype=torch.int32, device="cuda")
        _expect_same_bits(torch, ops.take_rows(tab, ix, bits, 32),
                          ref.take_rows_ref(tab, ix, bits, 32),
                          f"take_rows AF{bits} every code")
    nans = 0
    for bits in WIDTHS:              # random words: NaN codes of both signs
        tab = torch.randint(0, 2**32, (64, -(-d // 32) * bits), generator=gen,
                            device="cuda").to(torch.int32)
        if bits == 16:
            tab[0, :2] = torch.tensor([0x7E01FE01, 0x3C00], dtype=torch.int32)
        ix = torch.randint(0, 64, (SLOTS,), generator=gen, device="cuda")
        ix[0] = 0
        out = ops.take_rows(tab, ix, bits, d, out_dtype=bf)
        _expect_same_bits(torch, out, ref.take_rows_ref(tab, ix, bits, d,
                                                        out_dtype=bf),
                          f"take_rows AF{bits} -> bf16 NaN bits")
        if bits == 16 and out[0, :3].view(torch.int16).tolist() != [
                -64, 0x7FC0, 0x3F80]:              # 0xFFC0 0x7FC0 0x3F80
            raise AssertionError("take_rows: AF16 NaN codes -> bf16 bits")
        nans += int(torch.isnan(out).sum())
    log(json.dumps({"kernel": "take_rows", "model": cfg.name,
                    "bf16_nan_bits_equal": True, "nan_values_checked": nans}))

    calls_k = [lambda: ops.take_rows(table, idx, 16, d, out_dtype=bf)]
    ms, issue = time_ms(torch, calls_k, 200)
    # fresh rows every call: each call takes the next of more index sets
    # than a timing runs calls. 200 calls a window: with thousands queued
    # behind the held stream the launch queue fills, and the window then
    # times the host's issue
    cold = itertools.cycle(torch.randint(
        0, v, (copies_for(SLOTS * words * 4), SLOTS), generator=gen,
        device="cuda", dtype=torch.int32))
    ms_cold = time_ms(torch, [lambda: ops.take_rows(
        table, next(cold), 16, d, out_dtype=bf)], 200)[0]
    plain = time_ms(torch, [lambda: ref.take_rows_ref(
        table, idx, 16, d, out_dtype=bf)], 20)[0]
    dec = ref.unpack_ref(table, 16, d, bf)
    lib = time_ms(torch, [lambda: F.embedding(idx, dec)], 200)[0]
    lib_cold = time_ms(torch, [lambda: F.embedding(next(cold), dec)],
                       200)[0]
    b_ms, b_by = bound(idx.unique().numel() * words * 4 + idx.numel() * 4
                       + got.numel() * 2, 0.0)
    rec = {"kernel": "take_rows", "model": cfg.name, "table": [v, d],
           "rows": SLOTS,
           "calls_per_tick": 1, "max_err": 0.0, "tol": 0.0, "kernel_ms": ms,
           "host_issue_ms": issue, "kernel_ms_cold": ms_cold,
           "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib, "library_ms_cold": lib_cold}
    log(json.dumps(rec))
    per_call = [rec]
    if cfg.family != "moe":
        per_call.append(_take_many_rows(torch, F, ops, ref, gen, cfg, table,
                                        dec))
    del table, dec
    torch.cuda.empty_cache()
    summary = tick_summary(per_call)
    if len(per_call) > 1:
        summary["many_rows"] = per_call[1]
    return summary


def _take_many_rows(torch, F, ops, ref, gen, cfg, table, dec,
                    rows=SLOTS * MAX_SEQ, case="(B, T) embed"):
    """The (B, T) embed of a whole batch, ``rows`` rows (slots x
    max_seq_len unless given) of the AF16 table, to bf16 and f32: bit for
    bit, and timed (index sets rotated past the L2) beside the bound, the
    plain version and ``F.embedding`` on the decoded table."""
    v, d = cfg.vocab_size, cfg.d_model
    words = table.shape[1]
    sets = torch.randint(0, v, (copies_for(rows * (words * 4 + d * 2)),
                                rows), generator=gen, device="cuda",
                         dtype=torch.int32)
    dec32 = ref.unpack_ref(table, 16, d)
    distinct = sum(ix.unique().numel() for ix in sets) / len(sets)
    rec = {"kernel": "take_rows", "model": cfg.name, "case": case,
           "rows": rows, "distinct_rows": distinct, "calls_per_tick": 0,
           "max_err": 0.0, "tol": 0.0}
    for dt, name, table_lib in ((torch.bfloat16, "bf16", dec),
                                (torch.float32, "f32", dec32)):
        _expect_same_bits(torch, ops.take_rows(table, sets[0], 16, d,
                                               out_dtype=dt),
                          ref.take_rows_ref(table, sets[0], 16, d,
                                            out_dtype=dt),
                          f"take_rows {rows} rows -> {name}")
        ms = time_ms(torch, [lambda ix=ix: ops.take_rows(
            table, ix, 16, d, out_dtype=dt) for ix in sets], 100)[0]
        b_ms, b_by = bound(distinct * words * 4 + rows * 4
                           + rows * d * torch.finfo(dt).bits // 8, 0.0)
        rec[name] = {
            "kernel_ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms,
            "plain_ms": time_ms(torch, [lambda: ref.take_rows_ref(
                table, sets[0], 16, d, out_dtype=dt)], 5)[0],
            "library_ms": time_ms(torch, [lambda ix=ix: F.embedding(
                ix, table_lib) for ix in sets], 100)[0]}
    rec.update(kernel_ms=rec["bf16"]["kernel_ms"],
               plain_ms=rec["bf16"]["plain_ms"],
               bound_ms=rec["bf16"]["bound_ms"],
               bound_by=rec["bf16"]["bound_by"],
               library_ms=rec["bf16"]["library_ms"])
    log(json.dumps(rec))
    del dec32
    return rec


def _by_experts(torch, fn, e, per_expert_bytes):
    """``fn(e0, e1)`` over experts [e0, e1) in runs of about BANK_CHUNK
    bytes, concatenated along the expert axis: a plain decode of a whole
    128-expert bank (arctic-480b's 8.9 GB a leaf) would take several
    times its f32 size at once."""
    step = max(1, BANK_CHUNK // max(per_expert_bytes, 1))
    return torch.cat([fn(e0, min(e0 + step, e)) for e0 in range(0, e, step)])


def batched_case(torch, ops, ref, gen, model, e, c, k, n, calls, transpose,
                 xdt, prefill_calls=0, train_calls=0):
    """One bank product x (E, C, K) @ W[e] at AF16, W (E, K, N), or
    (E, N, K) packed along K when ``transpose``: held to the plain
    version, timed with W rotated past the L2, beside the plain version,
    torch.bmm on the decoded bf16 banks and the bound. The bank is drawn,
    decoded and the plain version run a run of experts at a time
    (``_by_experts``)."""
    wshape = (e, n, k) if transpose else (e, k, n)
    slice_bytes = k * n * 4
    wp = _by_experts(torch, lambda e0, e1: ops.pack(
        torch.randn((e1 - e0,) + wshape[1:], generator=gen, device="cuda")
        / math.sqrt(k), 16), e, slice_bytes)
    w_lib = _by_experts(torch, lambda e0, e1: ref.unpack_ref(
        wp[e0:e1], 16, k if transpose else n).to(torch.bfloat16), e,
        slice_bytes)
    x = torch.randn((e, c, k), generator=gen, device="cuda").to(xdt)

    def plain():
        return _by_experts(torch, lambda e0, e1: ref.packed_matmul_batched_ref(
            x[e0:e1], wp[e0:e1], 16, n, transpose), e, slice_bytes)

    got = ops.packed_matmul_batched(x, wp, 16, n, transpose)
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    tol = (BF16_TOL if xdt == torch.bfloat16 else 1e-5) * scale + 1e-4
    assert got.dtype == xdt and got.shape == (e, c, n)
    assert torch.isfinite(got).all().item()
    if err > tol:
        raise AssertionError(
            f"packed_matmul_batched E={e} C={c} K={k} N={n} "
            f"T={transpose} {xdt}: max err {err} > tol {tol}")
    wbytes = wp.numel() * 4
    reps = [wp] + [wp.clone() for _ in range(copies_for(wbytes) - 1)]
    libs = [w_lib] + [w_lib.clone() for _ in range(
        copies_for(w_lib.numel() * 2) - 1)]
    calls_k = [lambda r=r: ops.packed_matmul_batched(x, r, 16, n, transpose)
               for r in reps]
    ms, issue = time_ms(torch, calls_k, 30)
    plain_ms = time_ms(torch, [plain], 3)[0]
    xb = x.to(torch.bfloat16)
    lib = time_ms(torch, [lambda r=r: torch.bmm(
        xb, r.transpose(1, 2) if transpose else r) for r in libs], 30)[0]
    b_ms, b_by = bound(wbytes + x.numel() * x.element_size()
                       + got.numel() * got.element_size(),
                       2.0 * e * c * n * k, matmul_rate(xdt, 16))
    rec = {"kernel": "packed_matmul_batched", "model": model, "E": e, "C": c,
           "K": k, "N": n, "transpose": transpose,
           "x_dtype": str(xdt).split(".")[-1], "calls_per_tick": calls,
           "calls_per_prefill": prefill_calls,
           "calls_per_train_step": train_calls, "max_err": err, "tol": tol,
           "kernel_ms": ms, "host_issue_ms": issue, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    log(json.dumps(rec))
    del reps, libs, wp, w_lib, got, want
    torch.cuda.empty_cache()
    return rec


def check_packed_matmul_batched(torch, ops, ref, gen, cfg):
    """The expert banks of a full deepseek-moe-16b decode tick: E = 64
    experts, C = capacity rows each (1 at 8 slots), bf16 x, AF16 banks,
    both orientations; and a ragged shape (E, C, K, N not multiples of
    the tiles; a K split) in both orientations and in f32."""
    from repro_torch.models import blocks as B

    e, d, f, L = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.n_layers
    cap = B.capacity(cfg, SLOTS)
    # (E, C, K, N, calls per decode tick, transpose, x dtype)
    cases = [(e, cap, d, f, 2 * L, False, torch.bfloat16),   # w_in, w_gate
             (e, cap, f, d, L, False, torch.bfloat16),       # w_out
             (e, cap, d, f, 0, True, torch.bfloat16),        # dx orientation
             (e, cap, f, d, 0, True, torch.bfloat16),
             (5, 3, 300, 260, 0, False, torch.bfloat16),     # ragged
             (5, 3, 300, 260, 0, True, torch.bfloat16),
             (5, 3, 300, 260, 0, False, torch.float32),
             (5, 3, 300, 260, 0, True, torch.float32)]
    return tick_summary([batched_case(torch, ops, ref, gen, cfg.name, *case)
                         for case in cases])


# ---------------------------------------------------------------------------
# phase 2b: unpack, convert and truncate (on no serving path)
# ---------------------------------------------------------------------------

def _expect_same_bits(torch, got, want, what: str) -> None:
    """Equal dtype, shape and bit pattern (so -0.0 and NaN bits count)."""
    view = torch.int16 if want.dtype == torch.bfloat16 else torch.int32
    if (got.dtype != want.dtype or got.shape != want.shape
            or not torch.equal(got.view(view), want.view(view))):
        raise AssertionError(f"{what}: bits differ from the plain version")


def _midpoints(torch, ref, bits):
    """The exact f32 midpoint between each pair of adjacent finite
    same-sign codes of ``bits`` (a round-to-nearest-even tie) and its
    two f32 neighbours, of both signs."""
    from repro_torch.core.formats import FLOAT_FORMATS

    fmt = FLOAT_FORMATS[bits]
    top = fmt.max_biased_exp << fmt.mantissa_bits          # the +inf code
    v = ref.convert_ref(torch.arange(top, dtype=torch.int32, device="cuda"),
                        bits)
    mid = (v[:-1] + v[1:]) * 0.5
    x = torch.cat([mid, torch.nextafter(mid, torch.full_like(mid, math.inf)),
                   torch.nextafter(mid, torch.full_like(mid, -math.inf))])
    return torch.cat([x, -x])


def check_unpack_convert(torch, ops, ref, gen, cfg):
    """unpack, convert and truncate against their plain versions, bit for
    bit, at ``cfg``'s w_up leaf (d_model, d_ff) and a ragged (7, 1000):
    unpack to f32 and bf16 of ``_special_rows`` packed at all 7 widths;
    convert of random 32-bit words (bits above the width set) at all 7
    widths and of every AF8, AF12, AF16 and AF20 code; truncate of
    ``_special_rows`` in f32 and bf16 at all 7 widths, of the ties of
    AF8, AF12 and AF16 and their neighbours, and of every 4099th f32 bit
    pattern (NaN payloads and f32 subnormals among them). Each is then
    timed at AF16, one call on the w_up shape: the kernel, its plain
    version, the bound (bytes) and a library call on f16 storage."""
    t0 = time.perf_counter()
    for rows, n in ((cfg.d_model, cfg.d_ff), (7, 1000)):
        x = _special_rows(torch, gen, rows, n)
        xb = x.to(torch.bfloat16)
        words = torch.randint(0, 2**32, (rows, n), generator=gen,
                              device="cuda").to(torch.int32)
        for bits in WIDTHS:
            p = ref.pack_ref(x, bits)
            for dt in (torch.float32, torch.bfloat16):
                _expect_same_bits(torch, ops.unpack(p, bits, n, dt),
                                  ref.unpack_ref(p, bits, n, dt),
                                  f"unpack AF{bits} {dt} ({rows}, {n})")
            _expect_same_bits(torch, ops.convert(words, bits),
                              ref.convert_ref(words, bits),
                              f"convert AF{bits} ({rows}, {n})")
            for src in (x, xb):
                _expect_same_bits(torch, ops.truncate(src, bits),
                                  ref.truncate_ref(src, bits),
                                  f"truncate AF{bits} {src.dtype} "
                                  f"({rows}, {n})")
            del p
        del x, xb, words
    for bits in (8, 12, 16, 20):
        codes = torch.arange(2**bits, dtype=torch.int32, device="cuda")
        _expect_same_bits(torch, ops.convert(codes, bits),
                          ref.convert_ref(codes, bits),
                          f"convert AF{bits}, every code")
    for bits in (8, 12, 16):
        mids = _midpoints(torch, ref, bits)
        _expect_same_bits(torch, ops.truncate(mids, bits),
                          ref.truncate_ref(mids, bits),
                          f"truncate AF{bits}, ties")
    pattern = (torch.arange(0, 2**32, 4099, dtype=torch.int64, device="cuda")
               .to(torch.int32).view(torch.float32))
    for bits in WIDTHS:
        _expect_same_bits(torch, ops.truncate(pattern, bits),
                          ref.truncate_ref(pattern, bits),
                          f"truncate AF{bits}, every 4099th f32 pattern")
    torch.cuda.synchronize()
    log(f"unpack/convert/truncate: bit-identical to the plain versions at "
        f"all 7 widths, {pattern.numel()} f32 patterns included "
        f"({time.perf_counter() - t0:.1f} s)")

    rows, n = cfg.d_model, cfg.d_ff
    x = torch.randn((rows, n), generator=gen, device="cuda")
    p16 = ops.pack(x, 16)
    code16 = ops.truncate(x, 16)
    x_half = x.to(torch.float16)
    # the library calls compute the same function at AF16 (IEEE half):
    # the same bits on these NaN-free values
    _expect_same_bits(torch, ops.unpack(p16, 16, n),
                      p16.view(torch.float16).to(torch.float32),
                      "unpack AF16 against the library call")
    _expect_same_bits(torch, ops.convert(code16, 16), x_half.float(),
                      "convert AF16 against the library call")
    _expect_same_bits(torch, code16,
                      x_half.view(torch.int16).to(torch.int32) & 0xFFFF,
                      "truncate AF16 against the library call")
    numel = rows * n
    # (name, kernel call on an operand, plain call, library call on an
    # operand, kernel operand, library operand, bytes the function moves)
    cases = [("unpack", lambda r: ops.unpack(r, 16, n),
              lambda: ref.unpack_ref(p16, 16, n),
              lambda r: r.view(torch.float16).to(torch.float32), p16, p16,
              p16.numel() * 4 + numel * 4),
             ("convert", lambda r: ops.convert(r, 16),
              lambda: ref.convert_ref(code16, 16),
              lambda r: r.to(torch.float32), code16, x_half, numel * 8),
             ("truncate", lambda r: ops.truncate(r, 16),
              lambda: ref.truncate_ref(x, 16),
              lambda r: r.to(torch.float16), x, x, numel * 8)]
    out = {}
    for name, kern, plain, lib, operand, lib_operand, nbytes in cases:
        reps = [operand] + [operand.clone() for _ in range(
            copies_for(operand.numel() * operand.element_size()) - 1)]
        lib_reps = [lib_operand] + [lib_operand.clone() for _ in range(
            copies_for(lib_operand.numel() * lib_operand.element_size())
            - 1)]
        ms, issue = time_ms(torch, [lambda r=r: kern(r) for r in reps], 20)
        plain_ms = time_ms(torch, [plain], 3)[0]
        lib_ms = time_ms(torch, [lambda r=r: lib(r) for r in lib_reps],
                         20)[0]
        b_ms, b_by = bound(nbytes, 0.0)
        rec = {"kernel": name, "model": cfg.name, "shape": [rows, n],
               "bits": 16, "widths_checked": "all 7", "calls_per_tick": 0,
               "max_err": 0.0, "tol": 0.0, "kernel_ms": ms,
               "host_issue_ms": issue, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        log(json.dumps(rec))
        out[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "calls_per_tick": 0}
        del reps, lib_reps
    # unpack at the other widths and to bf16, beside their bounds; the
    # library call exists only at AF16 (f16 storage)
    widths = []
    for bits, dt in ((8, torch.float32), (12, torch.float32),
                     (16, torch.float32), (16, torch.bfloat16)):
        pk = p16 if bits == 16 else ops.pack(x, bits)
        reps = [pk] + [pk.clone() for _ in range(
            copies_for(pk.numel() * 4) - 1)]
        ms, issue = time_ms(torch, [lambda r=r: ops.unpack(r, bits, n, dt)
                                    for r in reps], 20)
        lib_ms = None
        if bits == 16:
            lib_ms = time_ms(torch, [
                lambda r=r: r.view(torch.float16).to(dt) for r in reps],
                20)[0]
        esize = torch.finfo(dt).bits // 8
        b_ms, _ = bound(pk.numel() * 4 + numel * esize, 0.0)
        rec = {"kernel": "unpack", "model": cfg.name, "shape": [rows, n],
               "bits": bits, "out_dtype": str(dt).split(".")[-1],
               "kernel_ms": ms, "host_issue_ms": issue, "bound_ms": b_ms,
               "bound_share": b_ms / ms, "library_ms": lib_ms}
        log(json.dumps(rec))
        widths.append(rec)
        del reps, pk
    out["unpack"]["per_width"] = widths
    del x, p16, code16, x_half
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 2c: the vlm, encdec, ssm and hybrid families at their decode tick
# ---------------------------------------------------------------------------

def cross_layers(cfg):
    """Cross-attention layers of one decode body (encdec's decoder); the
    self-attention layers are ``cfg.n_kv_layers``."""
    return cfg.n_layers if cfg.family == "encdec" else 0


def tick_products(cfg):
    """(K, N, calls per decode body, transpose) of every packed 2-D
    product a decode body runs, by the code of the family's blocks, and
    the head last (one call per body that makes logits; a tied table
    (V, d) takes the transposed orientation)."""
    import collections

    d, L = cfg.d_model, cfg.n_layers
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    calls = collections.Counter()

    def attention(n, cross=False):             # wq, wo (+ wk, wv)
        calls[(d, hq)] += n
        calls[(hq, d)] += n
        if not cross:
            calls[(d, hkv)] += 2 * n

    def mlp(n, f=cfg.d_ff, gated=cfg.gated_mlp):
        calls[(d, f)] += n * (2 if gated else 1)
        calls[(f, d)] += n

    fam = cfg.family
    if fam in ("dense", "vlm"):
        attention(L)
        mlp(L)
    elif fam == "moe":
        attention(L)
        calls[(d, cfg.n_experts)] += L          # the router
        if cfg.n_shared_experts:
            mlp(L, cfg.moe_d_ff * cfg.n_shared_experts, True)
        if cfg.dense_residual:
            mlp(L, cfg.d_ff, True)
    elif fam == "encdec":
        attention(L)
        attention(L, cross=True)
        mlp(L)
    elif fam == "ssm":
        di, dtr, n = cfg.d_inner, cfg.resolved_dt_rank, cfg.ssm_state
        for shape in ((d, 2 * di), (di, dtr + 2 * n), (dtr, di), (di, d)):
            calls[shape] += L                   # in, x, dt, out projections
    else:                                       # hybrid
        n_attn = cfg.n_kv_layers
        lw = cfg.lru_width or d
        calls[(d, lw)] += 2 * (L - n_attn)      # rg_in_w, rg_gate_w
        calls[(lw, d)] += L - n_attn            # rg_out
        attention(n_attn)
        mlp(L)
    return ([(k, n, c, False) for (k, n), c in calls.items()]
            + [(d, cfg.vocab_size, 1, cfg.tie_embeddings)])


def x_dtype(torch, cfg, k, n):
    """The dtype of x in a decode body's product (K, N): f32 for the MoE
    router (``blocks.route`` widens x), bf16 for every other one."""
    router = cfg.family == "moe" and (k, n) == (cfg.d_model, cfg.n_experts)
    return torch.float32 if router else torch.bfloat16


def append_case(torch, ops, ref, gen, cfg, seq, lens, calls):
    """The decode tick's KV append (``ops.append_kv_rows``) of bf16 K, V
    rows (slots, Hkv, head_dim) into AF16 dense caches of ``seq`` rows:
    bit-exact against the plain version, timed per layer."""
    hkv, d = cfg.n_kv_heads, cfg.resolved_head_dim
    w = -(-d // 32) * 16
    (kc, vc), kv_len, _ = _append_case(torch, gen, "dense", hkv, w, seq,
                                       lens)
    k, v = (torch.randn((SLOTS, hkv, d), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    got, want = [kc.clone(), vc.clone()], [kc.clone(), vc.clone()]
    ops.append_kv_rows(*got, k, v, kv_len, 16)
    ref.append_kv_rows_ref(*want, k, v, kv_len, 16)
    torch.cuda.synchronize()
    if not all(torch.equal(g, x) for g, x in zip(got, want)):
        raise AssertionError(f"append {cfg.name}: words differ")
    args = (kc, vc, k, v, kv_len, 16)
    ms, issue = time_ms(torch, [lambda: ops.append_kv_rows(*args)], 200)
    plain = time_ms(torch, [lambda: ref.append_kv_rows_ref(*args)], 20)[0]
    b_ms, b_by = bound(2 * SLOTS * hkv * d * 2 + 2 * SLOTS * hkv * w * 4
                       + SLOTS * 4, 0.0)
    rec = {"kernel": "pack", "case": "append dense", "model": cfg.name,
           "rows": [SLOTS, hkv, d], "S": seq, "bits": 16,
           "calls_per_tick": calls, "max_err": 0.0, "tol": 0.0,
           "kernel_ms": ms, "host_issue_ms": issue, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(json.dumps(rec))
    return rec


def take_case(torch, F, ops, ref, gen, cfg):
    """The tick's embedding gather: slots rows of the AF16 table (V, d)
    to bf16, bit for bit, timed beside ``F.embedding`` on the decoded
    table."""
    v, d = cfg.vocab_size, cfg.d_model
    bf = torch.bfloat16
    table = ops.pack(torch.randn((v, d), generator=gen, device="cuda")
                     * 0.02, 16)
    idx = torch.tensor([5, v - 1, 0, v // 3, 5, 123, v // 7, 5],
                       dtype=torch.int32, device="cuda")
    got = ops.take_rows(table, idx, 16, d, out_dtype=bf)
    _expect_same_bits(torch, got, ref.take_rows_ref(table, idx, 16, d,
                                                    out_dtype=bf),
                      f"take_rows {cfg.name}")
    ms, issue = time_ms(torch, [lambda: ops.take_rows(
        table, idx, 16, d, out_dtype=bf)], 200)
    plain = time_ms(torch, [lambda: ref.take_rows_ref(
        table, idx, 16, d, out_dtype=bf)], 20)[0]
    dec = ref.unpack_ref(table, 16, d, bf)
    lib = time_ms(torch, [lambda: F.embedding(idx, dec)], 200)[0]
    b_ms, b_by = bound(idx.unique().numel() * table.shape[1] * 4
                       + idx.numel() * 4 + got.numel() * 2, 0.0)
    rec = {"kernel": "take_rows", "model": cfg.name, "table": [v, d],
           "rows": SLOTS, "calls_per_tick": 1, "max_err": 0.0, "tol": 0.0,
           "kernel_ms": ms, "host_issue_ms": issue, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    log(json.dumps(rec))
    del table, dec
    torch.cuda.empty_cache()
    return rec


def check_family(torch, F, ops, ref, gen, cfg, seq):
    """Every kernel of ``cfg``'s decode tick at its full-width shapes, bf16
    activations, AF16 weights and KV, a cache of ``seq`` rows (the
    drain's max_seq_len; the hybrid's ring is min(attn_window, seq)
    rows): every packed product (``tick_products``; the tied heads
    transposed), the KV append and the self-attention of the layers that
    have them, encdec's cross-attention over ``encoder_seq`` rows, the
    embedding gather. Each is held to its plain version and timed beside
    its bound and library call; returns per kernel its numbers per
    tick."""
    per = {"packed_matmul": [
        matmul_case(torch, ops, ref, gen, cfg.name, k, n, calls, transpose,
                    x_dtype(torch, cfg, k, n), 16)
        for k, n, calls, transpose in tick_products(cfg)]}
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    self_layers, cross = cfg.n_kv_layers, cross_layers(cfg)
    if self_layers:
        if cfg.family == "hybrid":
            seq = min(cfg.attn_window or seq, seq)
        lens = [0, 1, 7, seq // 4, seq * 25 // 64, seq * 25 // 32, seq,
                seq + 3]
        per["pack"] = [append_case(torch, ops, ref, gen, cfg, seq, lens,
                                   self_layers)]
        per["kv_decode"] = [kv_case(torch, F, ops, ref, gen, cfg.name, h,
                                    hkv, d, seq, lens, 16, self_layers)]
    if cross:
        es = cfg.encoder_seq
        per["kv_decode"].append(kv_case(
            torch, F, ops, ref, gen, cfg.name, h, hkv, d, es, [es] * SLOTS,
            16, cross, case="cross"))
    per["take_rows"] = [take_case(torch, F, ops, ref, gen, cfg)]
    out = {name: tick_summary(recs) for name, recs in per.items()}
    if cfg.family == "vlm":          # the paged drain's attention
        out["paged_attention"] = check_paged_attention(torch, F, ops, ref,
                                                       gen, cfg)
    head = per["packed_matmul"][-1]
    keys = ("K", "N", "max_err", "tol", "kernel_ms", "host_issue_ms",
            "plain_ms", "bound_ms", "library_ms")
    if head["transpose"]:
        out["packed_matmul"]["transposed_head"] = {k: head[k] for k in keys}
    if head["transpose"] and cfg.family == "vlm":   # the AF12 draft's head
        af12 = matmul_case(torch, ops, ref, gen, cfg.name, head["K"],
                           head["N"], 0, True, torch.bfloat16, 12)
        out["packed_matmul"]["transposed_head"]["af12"] = {
            k: af12[k] for k in keys}
        out["packed_matmul"]["max_abs_err"] = max(
            out["packed_matmul"]["max_abs_err"], af12["max_err"])
    return out


# ---------------------------------------------------------------------------
# phase 2f: the five zoo configs' decode ticks
# ---------------------------------------------------------------------------

def zoo_config(get_config, arch):
    """A zoo config as phase 3g serves it: arctic-480b cut to its
    ZOO_LAYERS, the others whole."""
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=ZOO_LAYERS.get(cfg.name,
                                                             cfg.n_layers))


def zoo_paged_cases(cfg):
    """``check_paged_attention``'s cases for a zoo config: the check case
    (lengths up to 4,096) and its drain's tick (lengths near phase 3g's,
    ZOO_MAX_SEQ rows, no shared prefix), at the config's KV width (bf16
    rows for paper_native) and, for the dense family's packed caches,
    the drafts' AF12 and AF8 and bf16 rows too (checked; the tick case
    timed at AF16 and AF12)."""
    if cfg.compression.kv_bits is None:
        widths, tick = (0,), (0,)
    elif cfg.family == "dense":
        widths, tick = (16, 12, 8, 0), (16, 12)
    else:
        widths, tick = (16,), (16,)
    return [("check", [0, 1, 15, 16, 17, 255, 200, 4096], 4096 // PAGE,
             [(5, 6, 12)], 0, widths),
            ("tick", [5, 7, 9, 10, 12, 13, 14, 16], ZOO_MAX_SEQ // PAGE, [],
             cfg.n_layers, tick)]


def check_zoo(torch, F, ops, ref, gen, cfg):
    """Every kernel of a zoo config's decode tick (phase 3g's drains) at
    its full-width shapes, bf16 activations, held to its plain version
    and timed beside its bound and library call: ``check_family``'s rows
    (every packed product, the KV append, kv_decode, the embedding
    gather), paged_attention (``zoo_paged_cases``), the expert banks for
    arctic-480b (E = 128 at its decode capacity), and at the new shapes'
    other widths: the draft's whole weight pass (phi3-medium-14b AF12,
    stablelm-12b AF8), kv_decode on AF12 caches (timed) and AF8 and AF32
    ones (checked) for the dense family (``check_kv_decode``), and the append at every width, dense
    and paged, for stablelm-12b's 80-word heads (``check_pack``: bit for
    bit; timed at AF12, its draft cache's width).
    paper_native serves plain weights and a plain cache: its path's one
    kernel is paged_attention on bf16 rows."""
    paged = check_paged_attention(torch, F, ops, ref, gen, cfg,
                                  zoo_paged_cases(cfg))
    if cfg.compression.weight_bits is None:
        return {"paged_attention": paged}
    out = check_family(torch, F, ops, ref, gen, cfg, ZOO_MAX_SEQ)
    out["paged_attention"] = paged
    bf = torch.bfloat16
    if cfg.family == "moe":
        from repro_torch.models import blocks as B

        e, d, f, L = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.n_layers
        cap = B.capacity(cfg, SLOTS)
        out["packed_matmul_batched"] = tick_summary([
            batched_case(torch, ops, ref, gen, cfg.name, e, cap, d, f,
                         2 * L, False, bf),                 # w_in, w_gate
            batched_case(torch, ops, ref, gen, cfg.name, e, cap, f, d, L,
                         False, bf)])                       # w_out
    draft = ZOO_DRAFTS.get(cfg.name)
    if draft:                        # the draft's pass: a body and its head
        recs = [matmul_case(torch, ops, ref, gen, cfg.name, k, n, 0,
                            transpose, x_dtype(torch, cfg, k, n), draft,
                            draft_calls=calls)
                for k, n, calls, transpose in tick_products(cfg)]
        key = f"AF{draft} draft pass"
        out["packed_matmul"]["per_width"] = {
            key: width_summary(recs, "draft_calls_per_pass")}
        out["packed_matmul"]["max_abs_err"] = max(
            [out["packed_matmul"]["max_abs_err"]]
            + [r["max_err"] for r in recs])
        log(f"packed_matmul {cfg.name} {key} (one decode body with its "
            "head): " + json.dumps(out["packed_matmul"]["per_width"][key]))
    if cfg.family == "dense":        # AF8, AF32 checked; AF12 timed too
        out["kv_decode"] = check_kv_decode(torch, F, ops, ref, gen, cfg,
                                           ZOO_MAX_SEQ)
    if cfg.resolved_head_dim % 128:  # stablelm-12b's 5 code groups a head
        out["pack"]["per_width"] = check_pack(torch, ops, ref, gen,
                                              cfg).get("per_width", {})
    return out


# ---------------------------------------------------------------------------
# phase 2d: the prefill path's kernels at the rows a prefill gives them
# ---------------------------------------------------------------------------

def check_prefill_shapes(torch, F, ops, ref, gen, qwen, pali, moe):
    """The four kernels of the prefill path at its rows (B = 2, T = 512:
    1,024 rows of x), bf16 x, AF16: qwen3-8b's seven products (five
    shapes) at M = 1,024; paligemma-3b's tied head, transposed, at
    M = 512; deepseek-moe-16b's expert banks at the capacity of 1,024
    tokens; take_rows at 1,024 rows of qwen3-8b's table. Each is held to
    its plain version and timed beside its bound (FLOPs over TF32's
    495 TFLOP/s, or bytes over 3.35 TB/s) and the library call on the
    decoded weights. Returns per kernel its records and, for qwen3-8b's
    products and deepseek's banks, their sum over one body of the
    prefill (``calls_per_prefill`` calls of each)."""
    from repro_torch.models import blocks as B

    rows, bf = PREFILL_B * PREFILL_T, torch.bfloat16
    mm = [matmul_case(torch, ops, ref, gen, qwen.name, k, n, 0, False, bf,
                      16, rows=rows, prefill_calls=calls)
          for k, n, calls, _ in tick_products(qwen)[:-1]]
    head = matmul_case(torch, ops, ref, gen, pali.name, pali.d_model,
                       pali.vocab_size, 0, True, bf, 16, rows=rows // 2)
    e, d, f, L = moe.n_experts, moe.d_model, moe.moe_d_ff, moe.n_layers
    cap = B.capacity(moe, rows)
    banks = [batched_case(torch, ops, ref, gen, moe.name, e, cap, d, f, 0,
                          False, bf, 2 * L),           # w_in, w_gate
             batched_case(torch, ops, ref, gen, moe.name, e, cap, f, d, 0,
                          False, bf, L)]               # w_out
    table = ops.pack(torch.randn((qwen.vocab_size, qwen.d_model),
                                 generator=gen, device="cuda") * 0.02, 16)
    dec = ref.unpack_ref(table, 16, qwen.d_model, bf)
    take = _take_many_rows(torch, F, ops, ref, gen, qwen, table, dec,
                           rows=rows, case="prefill embed")
    del table, dec
    torch.cuda.empty_cache()
    return {"packed_matmul": {"body": {qwen.name: width_summary(
                mm, "calls_per_prefill")}, "cases": mm + [head]},
            "packed_matmul_batched": {"body": {moe.name: width_summary(
                banks, "calls_per_prefill")}, "cases": banks},
            "take_rows": {"cases": [take]}}


# ---------------------------------------------------------------------------
# phase 3: serve full-width qwen3-8b, deepseek-moe-16b and the four others
# ---------------------------------------------------------------------------

def path_launches(cfg, ticks: int, positions: int, paged: bool = False,
                  spec_k: int = 0, packed: bool = True):
    """Kernel launches of a drain with ``ticks`` decode ticks and
    ``positions`` prefill positions, by the code of the decode body: its
    packed products (``tick_products``), the three expert banks (moe),
    per layer with self-attention one KV append (a pack launch for K and
    V) and one attention (kv_decode, or paged_attention on a paged
    cache), per cross-attention layer a kv_decode over the dense cross
    cache (encdec, paged or not); per body one embedding gather; a head
    per body that makes logits (prefill drops them). A plain tick is one
    body with a head; the recurrent families have no prefill (their
    prompts go through ticks). A speculative tick (``spec_k`` = k) is
    k+1 draft bodies with k heads (the last only appends d_k's KV row)
    and k+1 verify bodies with k+1 heads, and the draft prefills every
    position the target does. ``packed_matmul_transposed`` counts the
    heads again where the table is tied (its orientation's own count,
    within packed_matmul's). Plain weights (``packed`` False) take no
    product, bank or gather kernel; a plain KV cache (no ``kv_bits``)
    is written and, dense, read without a kernel, and read paged through
    paged_attention on its bf16 rows."""
    products = tick_products(cfg)
    per_body = sum(calls for _, _, calls, _ in products[:-1])
    self_layers, cross = cfg.n_kv_layers, cross_layers(cfg)
    if spec_k:
        bodies = ticks * 2 * (spec_k + 1) + 2 * positions
        heads = ticks * (2 * spec_k + 1)
    else:
        bodies, heads = ticks + positions, ticks
    w, kv = int(packed), int(cfg.compression.kv_bits is not None)
    return {"packed_matmul": w * (bodies * per_body + heads),
            "packed_matmul_transposed": w * heads if products[-1][3] else 0,
            "pack": kv * bodies * self_layers,
            "kv_decode": bodies * ((0 if paged else kv * self_layers)
                                   + cross),
            "take_rows": w * bodies,
            "packed_matmul_batched": (w * bodies * 3 * cfg.n_layers
                                      if cfg.family == "moe" else 0),
            "paged_attention": bodies * self_layers if paged else 0,
            "unpack": 0, "convert": 0, "truncate": 0}


def shared_prefix_prompts(np, cfg):
    """8 requests of one system prompt plus a suffix each (numpy seed
    0)."""
    rng = np.random.default_rng(0)
    system = [int(t) for t in rng.integers(1, cfg.vocab_size, SYSTEM_PROMPT)]
    return [system + [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
            for n in rng.integers(SUFFIXES[0], SUFFIXES[1] + 1, SLOTS)]


def random_prompts(np, cfg, lens):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
            for n in rng.integers(lens[0], lens[1] + 1, SLOTS)]


def device_launches(torch, call):
    """What one ``call`` puts on the card, by torch.profiler: kernels,
    all device activities (kernels, copies, memsets) and the host's
    kernel-launch API calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    return {"kernels": sum(not e.name.startswith(("Memcpy", "Memset"))
                           for e in dev),
            "device_activities": len(dev),
            "launch_api_calls": sum("LaunchKernel" in e.name
                                    for e in events)}


def serve(torch, cfg, prompts, new_tokens: int, max_seq: int,
          paged: bool = False, params=None, plan=None, label="",
          pack: bool = True):
    """Drain ``prompts`` through a full-width engine (on ``params`` when
    given; packed at ``plan``'s per-leaf widths when given, ``label``
    naming it, else uniformly unless ``pack`` is False); returns (launch
    counts, outputs, engine, the drain's numbers). With a plan, the
    drain's last decode call is also replayed through the plain versions
    on the card (``decode_against_plain``)."""
    from repro_torch import obs
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tracer = obs.Tracer()
    eng = ServeEngine(cfg, max_seq_len=max_seq, max_slots=SLOTS,
                      pack_weights=pack, tracer=tracer, params=params,
                      paged=paged, kv_page_size=PAGE, plan=plan)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mode = ("paged" if paged else "dense") + label
    log(f"serve: {cfg.name} {mode} KV, {cfg.n_layers} layers {cfg.dtype}, "
        f"weights {eng.weight_read_bytes / 1e9:.3f} GB packed, engine init "
        f"{init_s:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    # the host's time to issue each decode tick of the drain against the
    # time until the card has finished it (prefill does not call
    # decode_step)
    step, issue, total, last = eng.lm.decode_step, [], [], []

    def timed_decode(p, state, toks):
        last[:] = [p, state, toks]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(p, state, toks)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.lm.decode_step = timed_decode
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    del eng.lm.decode_step
    outs = [eng.result(r) for r in rids]
    assert all(o is not None and len(o) == new_tokens for o in outs), outs
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    decode_ms = [r["dur_s"] * 1e3 for r in tracer.events("serve.decode")]
    prefill = tracer.events("serve.prefill")
    positions = sum(r["attrs"]["chunk"] for r in prefill)
    ticks = stats["decode_calls"]
    expect = (path_launches(cfg, ticks, positions, paged, packed=pack)
              if plan is None
              else plan_path_launches(cfg, plan, ticks, positions))
    res = {"model": cfg.name, "kv": mode, "requests": len(outs),
           "prompt_tokens": sum(len(p) for p in prompts),
           "tokens": stats["tokens"], "decode_ticks": ticks,
           "prefill_calls": stats["prefill_calls"],
           "prefill_positions": positions, "wall_s": wall,
           "tokens_per_s": stats["tokens"] / wall,
           "ms_per_decode_tick_mean": sum(decode_ms) / len(decode_ms),
           "ms_per_decode_tick_min": min(decode_ms),
           "prefill_s": sum(r["dur_s"] for r in prefill),
           "launches": counts, "launches_expected": expect,
           "launches_per_decode_call": {
               k: n for k, n in path_launches(cfg, 1, 0, paged,
                                              packed=pack).items() if n},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "weight_pass_gb": eng.weight_read_bytes / 1e9}
    if paged:
        res.update({k: stats[k] for k in (
            "prefix_hit_rate", "prefix_hits", "prefix_queries", "cow_copies",
            "table_uploads", "table_upload_bytes", "table_rows_uploaded",
            "kv_pages_read", "kv_pages_read_dense_equiv",
            "pool_peak_utilization", "pool_pages_used",
            "pool_pages_reserved")})
        res["h2d_table_ms"] = sum(r["dur_s"] * 1e3 for r in
                                  tracer.events("serve.h2d_table"))
    res["decode_step_issue_ms"] = issue
    res["decode_step_total_ms"] = total
    if plan is not None:
        res["plain_decode"] = decode_against_plain(torch, ops, ref, step,
                                                   last)
    log("serve: " + json.dumps(res))
    # the drain's last decode call replayed (it writes the rows it wrote):
    # what it launches now, and with the KV append as the eager
    # composition it replaced
    replay = {"after": device_launches(torch, lambda: step(*last))}
    append = ops.append_kv_rows
    ops.append_kv_rows = eager_append(ops, ref)
    try:
        replay["before"] = device_launches(torch, lambda: step(*last))
    finally:
        ops.append_kv_rows = append
    log(f"decode-call launches: {cfg.name} {mode}, one decode call, "
        f"torch.profiler: " + json.dumps(replay))
    for name, n in expect.items():
        if n and not counts[name]:
            raise AssertionError(f"{name} never launched on the "
                                 f"{cfg.name} {mode} path")
    if counts != expect:
        raise AssertionError(f"{cfg.name} {mode}: launch counts {counts} != "
                             f"path {expect}")
    if paged and (stats["pool_pages_used"] or stats["pool_pages_reserved"]):
        raise AssertionError(f"{cfg.name} paged: the pool did not drain "
                             f"back to empty: {res}")
    # per committed token from the serve.tick spans, the speculative
    # drains' yardstick
    res["ms_per_token"] = sum(r["dur_s"] * 1e3 for r in
                              tracer.events("serve.tick")) / stats["tokens"]
    return counts, outs, eng, res


def serve_speculative(torch, cfg, prompts, params, paged, plain,
                      max_seq: int = MAX_SEQ, new_tokens: int = NEW_TOKENS):
    """Drain ``prompts`` through the full-width speculative engine on
    ``params`` (the plain dense drain's packed weights): AF16 target,
    the config's draft weights (AF12 unless it names another width) and
    AF12 draft KV, k = SPEC_K, greedy. Its tokens must be
    the plain drain's (``plain``: its outputs and numbers), the counters
    the path's, and a paged pool must drain to empty. Per tick: the
    tick's time (span ``serve.tick``, the plain drain's yardstick too),
    and the host's time to issue the draft and the verify calls. Neither
    is timed with a synchronization of its own: the draft call follows
    the tick's read of the lengths and the verify call precedes its read
    of the tokens, so the device runs the draft while the host issues
    the verify, as it does without the timing. Returns the launch
    counts and the drain's numbers."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.serving import SpeculativeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tracer = obs.Tracer()
    eng = SpeculativeEngine(cfg, max_seq_len=max_seq, max_slots=SLOTS,
                            pack_weights=True, tracer=tracer, params=params,
                            paged=paged, kv_page_size=PAGE, k=SPEC_K)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mode = "paged" if paged else "dense"
    issue = {"draft": [], "verify": []}

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            issue[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    eng._draft_k = timed("draft", eng._draft_k)
    eng.lm.verify_step = timed("verify", eng.lm.verify_step)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    del eng._draft_k, eng.lm.verify_step
    outs = [eng.result(r) for r in rids]
    tick_ms = [r["dur_s"] * 1e3 for r in tracer.events("serve.tick")]
    positions = sum(r["attrs"]["chunk"]
                    for r in tracer.events("serve.prefill"))
    ticks = stats["spec_ticks"]
    expect = path_launches(cfg, ticks, positions, paged, spec_k=SPEC_K)
    host = [a + b for a, b in zip(issue["draft"], issue["verify"])]
    res = {"model": cfg.name, "kv": mode, "k": SPEC_K,
           "draft_bits": stats["draft_bits"],
           "draft_kv_bits": stats["draft_kv_bits"],
           "engine_init_s": init_s,
           "target_weight_gb": eng.weight_read_bytes / 1e9,
           "draft_weight_gb": eng.draft_weight_read_bytes / 1e9,
           "tokens": stats["tokens"], "spec_ticks": ticks,
           "prefill_positions": positions, "wall_s": wall,
           "ms_per_spec_tick_mean": sum(tick_ms) / len(tick_ms),
           "ms_per_spec_tick_min": min(tick_ms),
           "host_issue_ms_per_tick_mean": sum(host) / len(host),
           "draft_issue_ms_mean": sum(issue["draft"]) / len(host),
           "verify_issue_ms_mean": sum(issue["verify"]) / len(host),
           "acceptance_rate": stats["acceptance_rate"],
           "committed_per_slot_tick": stats["committed_per_slot_tick"],
           "ms_per_committed_token": sum(tick_ms) / stats["tokens"],
           "plain_dense_ms_per_token": plain["ms_per_token"],
           "prefill_s": sum(r["dur_s"] for r in
                            tracer.events("serve.prefill")),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "launches_expected": expect}
    log("speculative: " + json.dumps(res))
    if outs != plain["outs"]:
        raise AssertionError(f"{cfg.name} speculative {mode}: tokens differ "
                             f"from the plain dense drain's: {outs} != "
                             f"{plain['outs']}")
    for name, n in expect.items():
        if n and not counts[name]:
            raise AssertionError(f"{name} never launched on the {cfg.name} "
                                 f"speculative {mode} path")
    if counts != expect:
        raise AssertionError(f"{cfg.name} speculative {mode}: launch counts "
                             f"{counts} != path {expect}")
    if paged and (stats["pool_pages_used"] or stats["pool_pages_reserved"]):
        raise AssertionError(f"{cfg.name} speculative paged: the pool did "
                             f"not drain back to empty: {stats}")
    log(f"{cfg.name} speculative {mode}: tokens identical to the plain dense "
        f"drain's; {res['ms_per_committed_token']:.2f} ms per committed "
        f"token against the plain drain's {plain['ms_per_token']:.2f}")
    return counts, res


# ---------------------------------------------------------------------------
# phase 3g: the five zoo configs
# ---------------------------------------------------------------------------

def zoo_phase(torch, np, cfg):
    """Drain a zoo config (``zoo_config``) at full width on 8 requests of
    ZOO_PROMPTS tokens, ZOO_NEW_TOKENS new tokens each, max_seq_len
    ZOO_MAX_SEQ, bf16 activations: AF16 weights drawn by the packing
    engine itself (slice by slice into their packed words) and an AF16
    KV cache, or, for paper_native, its plain bf16 weights and plain
    cache (``NO_COMPRESSION``); dense, then paged on the same weights,
    then, for ZOO_DRAFTS' configs, speculatively with their draft
    (dense KV). The tokens must be the dense drain's in every mode, each
    drain's launches its path's (``serve``, ``serve_speculative``), and
    every drain's peak memory under ZOO_PEAK_GB. Returns the launch
    counts by drain."""
    pack = cfg.compression.weight_bits is not None
    prompts = random_prompts(np, cfg, ZOO_PROMPTS)
    launches = {}
    launches[cfg.name], outs, eng, plain = serve(
        torch, cfg, prompts, ZOO_NEW_TOKENS, ZOO_MAX_SEQ, pack=pack)
    drains = [plain]
    launches[cfg.name + " paged"], paged_outs, paged, res = serve(
        torch, cfg, prompts, ZOO_NEW_TOKENS, ZOO_MAX_SEQ, paged=True,
        params=eng.params, pack=pack)
    drains.append(res)
    del paged
    if paged_outs != outs:
        raise AssertionError(f"{cfg.name}: paged greedy tokens differ from "
                             f"the dense drain's: {paged_outs} != {outs}")
    if cfg.name in ZOO_DRAFTS:
        plain["outs"] = outs
        torch.cuda.empty_cache()
        launches[cfg.name + " speculative"], res = serve_speculative(
            torch, cfg, prompts, eng.params, False, plain, ZOO_MAX_SEQ,
            ZOO_NEW_TOKENS)
        if res["draft_bits"] != ZOO_DRAFTS[cfg.name]:
            raise AssertionError(f"{cfg.name}: drafted at AF{res['draft_bits']}"
                                 f", not AF{ZOO_DRAFTS[cfg.name]}")
        drains.append(res)
    del eng
    torch.cuda.empty_cache()
    peak = max(r["peak_memory_gb"] for r in drains)
    if peak >= ZOO_PEAK_GB:
        raise AssertionError(f"{cfg.name}: peak memory {peak:.2f} GB, not "
                             f"under {ZOO_PEAK_GB} GB")
    log(f"zoo: {cfg.name} at {cfg.n_layers} layers, "
        f"{'AF16' if pack else 'plain bf16'} weights, "
        f"{len(drains)} drains ({', '.join(launches)}): tokens identical, "
        f"peak memory {peak:.2f} GB (under {ZOO_PEAK_GB} GB)")
    return launches


# ---------------------------------------------------------------------------
# phase 3b: prefill and the loss at full width, on phase 3's weights
# ---------------------------------------------------------------------------

def body_products(cfg) -> int:
    """Packed 2-D products of one forward over a sequence, its head
    aside: the decode body's (``tick_products``) and, for encdec, the
    cross attention's wk and wv (projected from the encoder's output,
    which decoding reads from its cross cache) and the encoder's
    layers."""
    per_body = sum(calls for _, _, calls, _ in tick_products(cfg)[:-1])
    if cfg.family == "encdec":
        per_body += (2 * cfg.n_layers + cfg.encoder_layers
                     * (4 + (3 if cfg.gated_mlp else 2)))
    return per_body


def prefill_launches(cfg, n_chunks: int):
    """Kernel launches of one ``prefill`` and one ``loss`` (``n_chunks``
    whole chunks), by the code of the forward: per body (the backbone
    over the sequence, once in each) the decode body's packed products
    (``tick_products``), for encdec also the cross attention's wk and wv
    (projected from the encoder's output, which decoding reads from its
    cross cache) and the encoder's layers; the three expert banks per
    MoE layer; one embedding gather; the heads: prefill's at the last
    position and one per chunk of the loss, transposed where the table
    is tied. No KV append, attention kernel or materialized decode."""
    products = tick_products(cfg)
    per_body = body_products(cfg)
    heads = 1 + n_chunks
    return {"packed_matmul": 2 * per_body + heads,
            "packed_matmul_transposed": heads if products[-1][3] else 0,
            "pack": 0, "kv_decode": 0, "take_rows": 2,
            "packed_matmul_batched": (6 * cfg.n_layers
                                      if cfg.family == "moe" else 0),
            "paged_attention": 0, "unpack": 0, "convert": 0, "truncate": 0}


def prefill_batch(torch, cfg, gen, b, t):
    """The reference's batch dict for ``cfg``, made from ``gen`` on its
    device: tokens and labels (b, t), the vlm's patch embeddings,
    encdec's frames."""
    batch = {name: torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                                 device=gen.device, dtype=torch.int32)
             for name in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device=gen.device)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=gen.device)
    return batch


@contextlib.contextmanager
def kernel_calls(torch, ops, names=("packed_matmul", "packed_matmul_batched",
                                    "take_rows")):
    """Inside, each call of the ``names`` wrappers (by default
    packed_matmul, packed_matmul_batched and take_rows; truncate and
    convert too) is bracketed by two CUDA events on its stream (no sync).
    ``summarize()`` on the yielded list gives per kernel: calls,
    ``event_ms``, the sum of the ms between each call's events, and the
    bound of its calls: each input read once (a gather's distinct rows),
    each output written once, the multiplies at ``matmul_rate``. The
    stream is not held, so where it was idle an event pair also spans
    the host's work in the wrapper (its checks, the grid plan, the
    launch): ``event_ms`` is the kernel's device time only where the
    stream was busy, and otherwise more than it."""
    calls = []
    wrapped = {name: getattr(ops, name) for name in names}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bracket(name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            if name == "take_rows":      # its distinct rows, after a sync
                packed, idx = args[:2]
                b = (idx, packed.shape[1] * 4, nbytes(idx, out))
            elif name in ("truncate", "convert"):
                b = bound(nbytes(args[0], out), 0.0)[0]
            else:
                x, w, bits = args[:3]
                b = bound(nbytes(x, w, out), 2.0 * out.numel() * x.shape[-1],
                          matmul_rate(x.dtype, bits))[0]
            calls.append((name, b, start, end))
            return out
        return call

    def summarize():
        torch.cuda.synchronize()
        out = {}
        for name, b_ms, start, end in calls:
            if name == "take_rows":
                idx, row_bytes, io_bytes = b_ms
                b_ms = bound(torch.unique(idx).numel() * row_bytes
                             + io_bytes, 0.0)[0]
            rec = out.setdefault(name, {"calls": 0, "event_ms": 0.0,
                                        "bound_ms": 0.0})
            rec["calls"] += 1
            rec["event_ms"] += start.elapsed_time(end)
            rec["bound_ms"] += b_ms
        return out

    for name, fn in wrapped.items():
        setattr(ops, name, bracket(name, fn))
    try:
        yield summarize
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)


def prefill_phase(torch, ops, cfg, lm, params):
    """``LM.prefill`` then ``LM.loss`` (under no_grad) of ``cfg`` at full
    width and depth on ``params`` (phase 3's packed weights, through its
    engine's ``lm``): B = 2, T = 512 text tokens (whisper T = 256 over
    1,500 frames; the vlm adds its 256 image tokens), inputs from a
    seeded generator. The launch counts are zeroed just before and read
    just after, and must be ``prefill_launches``; the logits and the loss
    must be finite. Prints the seconds of each to a device sync, prefill
    tokens per second, peak memory, the launches, and per kernel its
    calls' event time (``kernel_calls``) beside their bound. Returns the
    launch counts and those per-kernel numbers of each call."""
    b = PREFILL_B
    t = WHISPER_T if cfg.family == "encdec" else PREFILL_T
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = prefill_batch(torch, cfg, gen, b, t)
    positions = t + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    expect = prefill_launches(cfg, t // min(512, t))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        with kernel_calls(torch, ops) as prefill_kernels:
            logits, state = lm.prefill(params, batch)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with kernel_calls(torch, ops) as loss_kernels:
            loss = lm.loss(params, batch)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert state == {} and logits.shape == (b, 1, cfg.vocab_size), \
        logits.shape
    assert bool(torch.isfinite(logits).all()) and math.isfinite(loss.item())
    kernels = {"prefill": prefill_kernels(), "loss": loss_kernels()}
    res = {"model": cfg.name, "batch": [b, t], "positions": positions,
           "prefill_s": t1 - t0, "loss_s": t2 - t1,
           "prefill_tokens_per_s": b * t / (t1 - t0),
           "prefill_positions_per_s": b * positions / (t1 - t0),
           "loss": loss.item(), "peak_memory_gb": peak,
           "launches": counts, "launches_expected": expect,
           "kernels": kernels,
           "prefill_kernel_event_ms": sum(k["event_ms"] for k in
                                          kernels["prefill"].values()),
           "prefill_kernel_bound_ms": sum(k["bound_ms"] for k in
                                          kernels["prefill"].values()),
           "phase_s": time.perf_counter() - t0}
    log("prefill: " + json.dumps(res))
    for name, n in expect.items():
        if n and not counts[name]:
            raise AssertionError(f"{name} never launched on the {cfg.name} "
                                 "prefill path")
    if counts != expect:
        raise AssertionError(f"{cfg.name} prefill: launch counts {counts} "
                             f"!= path {expect}")
    return counts, kernels


# ---------------------------------------------------------------------------
# phase 2e: the training path's kernels at the rows a train step gives them
# ---------------------------------------------------------------------------

def moment_case(torch, ops, ref, gen, cfg, kernel):
    """``ops.pack`` (f32 -> AF16) or ``ops.unpack`` (AF16 -> f32) over one
    moment leaf of ``cfg``'s w_up shape, as AdamW encodes and decodes
    it: bit for bit against the plain version; timed beside it, the
    bound (bytes) and the library call on float16 storage."""
    d, f = cfg.d_model, cfg.d_ff
    m = torch.randn((d, f), generator=gen, device="cuda") * 1e-3
    words = ops.pack(m, 16)
    if kernel == "pack":
        _expect_same_bits(torch, words, ref.pack_ref(m, 16), "pack moment")
        calls = [lambda: ops.pack(m, 16)]
        plain = [lambda: ref.pack_ref(m, 16)]
        lib = [lambda: m.to(torch.float16).view(torch.int32)]
    else:
        _expect_same_bits(torch, ops.unpack(words, 16, f),
                          ref.unpack_ref(words, 16, f), "unpack moment")
        calls = [lambda: ops.unpack(words, 16, f)]
        plain = [lambda: ref.unpack_ref(words, 16, f)]
        lib = [lambda: words.view(torch.float16).to(torch.float32)]
    ms, issue = time_ms(torch, calls, 30)
    b_ms, b_by = bound(m.numel() * 4 + words.numel() * 4, 0.0)
    rec = {"kernel": kernel, "model": cfg.name, "case": "moment leaf",
           "shape": [d, f], "bits": 16, "max_err": 0.0,
           "kernel_ms": ms, "host_issue_ms": issue,
           "plain_ms": time_ms(torch, plain, 3)[0], "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": time_ms(torch, lib, 30)[0]}
    log(json.dumps(rec))
    del m, words
    torch.cuda.empty_cache()
    return rec


def check_train_shapes(torch, ops, ref, gen, qwen, whisper, moe, pali):
    """The training path's kernels at the rows a step of B = 2, T = 512
    gives them (whisper T = 256), bf16 x, AF16, each held to its plain
    version and timed beside its bound and the library call on the
    decoded weights: the transposed packed_matmul as the dx of qwen3-8b's
    five product shapes at M = 1,024 (calls a step at TRAIN_LAYERS) and
    of whisper-small's untied head (its K the vocabulary, 51,865); the
    normal orientation as the dx of a tied head (paligemma-3b's table,
    K = 257,216: no trained model ties its head, so on no path here);
    packed_matmul_batched, transposed, at deepseek-moe-16b's banks at
    the capacity of 1,024 tokens; pack and unpack over one moment leaf
    of qwen3-8b's w_up shape."""
    from repro_torch.models import blocks as B

    rows, bf = PREFILL_B * PREFILL_T, torch.bfloat16
    q = dataclasses.replace(qwen, n_layers=TRAIN_LAYERS[qwen.name])
    dx = [matmul_case(torch, ops, ref, gen, qwen.name, n, k, 0, True, bf,
                      16, rows=rows, train_calls=calls)
          for k, n, calls, _ in tick_products(q)]
    heads = [matmul_case(torch, ops, ref, gen, whisper.name,
                         whisper.vocab_size, whisper.d_model, 0, True, bf, 16,
                         rows=PREFILL_B * WHISPER_T, train_calls=1),
             matmul_case(torch, ops, ref, gen, pali.name, pali.vocab_size,
                         pali.d_model, 0, False, bf, 16, rows=rows)]
    e, d, f = moe.n_experts, moe.d_model, moe.moe_d_ff
    L, cap = TRAIN_LAYERS[moe.name], B.capacity(moe, rows)
    banks = [batched_case(torch, ops, ref, gen, moe.name, e, cap, f, d, 0,
                          True, bf, train_calls=2 * L),  # w_in, w_gate dx
             batched_case(torch, ops, ref, gen, moe.name, e, cap, d, f, 0,
                          True, bf, train_calls=L)]      # w_out dx
    return {"packed_matmul": {"dx": {q.name: width_summary(
                dx, "calls_per_train_step")}, "cases": dx + heads},
            "packed_matmul_batched": {"dx": {moe.name: width_summary(
                banks, "calls_per_train_step")}, "cases": banks},
            **{k: {"cases": [moment_case(torch, ops, ref, gen, qwen, k)]}
               for k in ("pack", "unpack")}}


# ---------------------------------------------------------------------------
# phase 3c: packed-master and dense training at full width
# ---------------------------------------------------------------------------

def train_launches(cfg, masters, n_planned: int, t: int, packed: bool):
    """Kernel launches of one train step and its staleness probe, by the
    code of the path. Packed-master: the forward's packed products (the
    decode body's, ``tick_products``, with encdec's cross wk / wv and
    encoder, as ``prefill_launches`` counts them, and one head a loss
    chunk) and as many dx products, each in the other orientation (so
    the transposed count is the forward's total); six bank products a
    MoE layer (three forward, three dx); one embedding gather; per
    rank >= 2 leaf and row chunk (``optim.row_chunks``) AdamW's two
    moment decodes and encodes, the staleness probe's encode and two
    decodes; per planned leaf one re-encode. Dense: the moments alone."""
    from repro_torch.core.tensor_store import tree_leaves
    from repro_torch.optim import row_chunks

    shapes = [tuple(p.shape) for p in tree_leaves(masters) if p.ndim >= 2]
    chunks = sum(len(row_chunks(sh)) for sh in shapes)
    out = dict.fromkeys(("packed_matmul", "packed_matmul_transposed", "pack",
                         "kv_decode", "take_rows", "packed_matmul_batched",
                         "paged_attention", "unpack", "convert",
                         "truncate"), 0)
    out["pack"], out["unpack"] = 2 * chunks, 2 * chunks
    if not packed:
        return out
    assert n_planned == len(shapes), (n_planned, len(shapes))
    fwd = body_products(cfg) + t // min(512, t)
    out.update(packed_matmul=2 * fwd, packed_matmul_transposed=fwd,
               take_rows=1, pack=3 * chunks + n_planned,
               unpack=4 * chunks, packed_matmul_batched=(
                   6 * cfg.n_layers if cfg.family == "moe" else 0))
    return out


def train_phase(torch, ops, cfg):
    """Train ``cfg`` at full width (depth TRAIN_LAYERS) on the card through
    the port's Trainer: TRAIN_STEPS packed-master steps (repack_every 1,
    log_every 1) and as many dense steps from the same seed, B = 2,
    T = 512 (whisper 256), lr 1e-3, bf16 weights and activations, AF16
    codes and moments. The counters are zeroed just before each run and
    read just after: every step's launches (the Trainer's
    ``step_launches``) must be ``train_launches``, and the run's the
    init's encodes plus the steps'. Held: packed losses within
    TRAIN_LOSS_RTOL of dense at every step, staleness 0.0 after each
    repack, the final ``train.metrics`` event's keys exactly
    ``TRAIN_FINAL_KEYS``, finite losses. Prints per run the seconds of
    each step to a device sync, tokens/s, peak memory, the losses, the
    staleness, the weight-read bytes, the launches of a step and, for
    the matmul kernels and take_rows, the event time around their calls
    over the run beside their bound (``kernel_calls``: not a device
    time where the stream idled).
    Returns {mode: launches of the run}."""
    from repro_torch import obs
    from repro_torch.core.tensor_store import tree_leaves
    from repro_torch.train import Trainer, TrainConfig

    small = dataclasses.replace(
        cfg, n_layers=TRAIN_LAYERS.get(cfg.name, cfg.n_layers))
    t = WHISPER_T if cfg.family == "encdec" else PREFILL_T
    runs, counts = {}, {}
    for mode in ("packed", "dense"):
        tc = TrainConfig(steps=TRAIN_STEPS, seq_len=t,
                         global_batch=PREFILL_B, lr=1e-3, log_every=1,
                         repack_every=1, pack_params=mode == "packed")
        tracer = obs.Tracer()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tr = Trainer(small, tc, tracer=tracer)
        if small.family == "encdec":
            # random frames (seeded; the same in both runs): the
            # Trainer's zero frames, the reference's stub, make every
            # activation of the encoder zero, where each rms_norm's
            # gradient is 1/sqrt(eps); through 12 layers that overflows
            # f32 and the encoder's gradients are NaN, in the reference
            # too (ROADMAP Queue C)
            frames = torch.randn(
                (PREFILL_B, small.encoder_seq, small.d_model),
                generator=torch.Generator(device="cuda").manual_seed(5),
                device="cuda")
            tr._extra_inputs = lambda b: {"frames": frames}
        with kernel_calls(torch, ops) as kernel_events:
            m = tr.run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[mode] = ops.launch_counts()
        n_planned = len(tr.plan.float_bits) if tr.plan else 0
        masters = tr.state["params"]
        n2d = sum(p.ndim >= 2 for p in tree_leaves(masters))
        step = train_launches(small, masters, n_planned, t, mode == "packed")
        init = dict.fromkeys(step, 0)
        init["pack"] = 2 * n2d + n_planned    # zero moments, first encode
        final = tracer.events("train.metrics")[-1]["attrs"]
        steps_s = m["step_times"]
        runs[mode] = {
            "model": small.name, "layers": small.n_layers,
            "batch": [PREFILL_B, t], "losses": m["losses"],
            "step_s": steps_s,
            "tokens_per_s": PREFILL_B * t * (len(steps_s) - 1)
            / sum(steps_s[1:]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "run_s": wall, "staleness": [s for _, s in m["staleness"]],
            "weight_read_bytes_fused": final["weight_read_bytes_fused"],
            "weight_read_bytes_dense": final["weight_read_bytes_dense"],
            "kernel_events_per_run": kernel_events(),
            "launches_per_step": m["step_launches"][-1],
            "launches_expected": step, "launches_run": counts[mode]}
        log("train: " + json.dumps(runs[mode]))
        if set(final) != obs.TRAIN_FINAL_KEYS:
            raise AssertionError(f"{small.name} {mode}: train.metrics keys "
                                 f"{sorted(final)}")
        if not all(math.isfinite(x) for x in m["losses"]):
            raise AssertionError(f"{small.name} {mode}: losses {m['losses']}")
        for i, got in enumerate(m["step_launches"]):
            if got != step:
                raise AssertionError(f"{small.name} {mode} step {i}: "
                                     f"launches {got} != path {step}")
        total = {k: init[k] + TRAIN_STEPS * step[k] for k in step}
        if counts[mode] != total:
            raise AssertionError(f"{small.name} {mode}: run launches "
                                 f"{counts[mode]} != {total}")
        for name, n in step.items():
            if n and not counts[mode][name]:
                raise AssertionError(f"{name} never launched on the "
                                     f"{small.name} {mode} train path")
        del tr, masters
    packed, dense = runs["packed"], runs["dense"]
    if packed["staleness"] != [0.0] * TRAIN_STEPS:
        raise AssertionError(f"{small.name}: staleness after each repack "
                             f"{packed['staleness']}")
    rel = [abs(p - d) / abs(d) for p, d in zip(packed["losses"],
                                                dense["losses"])]
    log(f"train: {small.name} packed-master losses {packed['losses']} "
        f"against dense {dense['losses']}: max relative difference "
        f"{max(rel):.3g} (tol {TRAIN_LOSS_RTOL}); weight reads a step "
        f"{packed['weight_read_bytes_fused'] / (2 * TRAIN_STEPS) / 1e9:.3f}"
        f" GB packed against "
        f"{dense['weight_read_bytes_dense'] / (2 * TRAIN_STEPS) / 1e9:.3f}"
        " GB dense per pass")
    if max(rel) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{small.name}: packed-master losses "
                             f"{packed['losses']} not within "
                             f"{TRAIN_LOSS_RTOL} of {dense['losses']}")
    torch.cuda.empty_cache()
    return counts, runs


# ---------------------------------------------------------------------------
# phase 3d: calibration to a mixed-width plan, and serving it
# ---------------------------------------------------------------------------

# the dense family's packed products, by leaf (``tick_products``' order)
DENSE_PRODUCT_LEAVES = ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
                        "blocks/attn/wo", "blocks/mlp/w_in",
                        "blocks/mlp/w_gate", "blocks/mlp/w_out")


def plan_path_launches(cfg, plan, ticks: int, positions: int):
    """``path_launches`` of a dense-family drain whose weights ``plan``
    packs leaf by leaf: a product whose leaf the plan leaves at AF32 (a
    plain tensor) runs no packed_matmul, a plain head none either, and a
    plain embedding table no take_rows."""
    if cfg.family != "dense":
        raise ValueError(f"plan_path_launches: dense family only, not "
                         f"{cfg.family}")
    expect = path_launches(cfg, ticks, positions)
    widths = plan.float_bits

    def plain(key):
        return widths.get(key, 32) >= 32
    bodies = ticks + positions
    expect["packed_matmul"] -= bodies * cfg.n_layers * sum(
        plain(k) for k in DENSE_PRODUCT_LEAVES)
    if plain("lm_head"):
        expect["packed_matmul"] -= ticks
    if plain("embed"):
        expect["take_rows"] = 0
    return expect


def clone_tree(torch, tree):
    from repro_torch.core.tensor_store import tree_map_with_path
    return tree_map_with_path(
        lambda _, v: v.clone() if isinstance(v, torch.Tensor) else v, tree)


@contextlib.contextmanager
def plain_ops(ops, ref):
    """Inside, every kernel wrapper of ``ops`` runs its plain version
    (``kernels.ref``) on the card's tensors instead of its kernel."""
    plain = {
        "packed_matmul": lambda x, w, bits, n, transpose=False:
            ref.packed_matmul_ref(x, w, bits, n, transpose),
        "packed_matmul_batched": lambda x, w, bits, n, transpose=False:
            ref.packed_matmul_batched_ref(x, w, bits, n, transpose),
        "take_rows": ref.take_rows_ref,
        "kv_decode": lambda q, k, v, kv_len, bits, d:
            ref.kv_decode_ref(q, k, v, bits, d, kv_len),
        "paged_attention": ref.paged_attention_ref,
        "append_kv_rows": ref.append_kv_rows_ref,
        "pack": ref.pack_ref, "unpack": ref.unpack_ref,
        "convert": ref.convert_ref, "truncate": ref.truncate_ref}
    kept = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in kept.items():
            setattr(ops, name, fn)


def decode_against_plain(torch, ops, ref, step, last):
    """The drain's last decode call (``last``: its params, state, tokens)
    replayed on clones of its state, through the kernels and through
    their plain versions on the card: the logits within PLAIN_LOGIT_TOL
    of the plain ones' largest magnitude (bf16 activations: the two
    round their sums to bf16 in other orders, layer after layer)."""
    params, state, toks = last
    with torch.no_grad():
        got = step(params, clone_tree(torch, state), toks)[0].float()
        with plain_ops(ops, ref):
            want = step(params, clone_tree(torch, state), toks)[0].float()
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(
        want).all())
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    res = {"max_abs_err": err, "max_abs_logit": scale,
           "tol": PLAIN_LOGIT_TOL * scale,
           "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "rows": int(got.shape[0] * got.shape[1])}
    if err > PLAIN_LOGIT_TOL * scale:
        raise AssertionError(f"decode call against the plain versions: {res}")
    return res


def leaf_widths(torch, params):
    """path -> packed width (32 for a plain tensor) of every leaf."""
    from repro_torch.core.compress import path_str
    from repro_torch.core.tensor_store import is_packed, tree_map_with_path
    got = {}

    def visit(path, leaf):
        got[path_str(path)] = leaf.bits if is_packed(leaf) else 32
        return leaf
    tree_map_with_path(visit, params)
    return got


def _same_bits_chunked(torch, got, plain, x, bits, what):
    """``got`` (a kernel's output over all of ``x``) bit for bit against
    ``plain`` on chunks of ``x``: the plain versions' temporaries take
    over a hundred bytes an element."""
    flat_x, flat_got = x.reshape(-1), got.reshape(-1)
    for i in range(0, flat_x.numel(), CALIB_CHECK_CHUNK):
        part = slice(i, i + CALIB_CHECK_CHUNK)
        _expect_same_bits(torch, flat_got[part], plain(flat_x[part], bits),
                          what)


def calibrate_phase(torch, np, ops, ref, cfg):
    """Calibrate ``cfg`` at full width, cut to TRAIN_LAYERS, on the card
    (the launcher's defaults: loss_delta 0.05 nats over 2 batches of
    B = 2, T = 16 from the port's token stream, max_seq_len MAX_SEQ,
    random weights from seed 0 as the engine makes them), then serve the
    plan and a hand-written plan that cycles the leaves through all
    seven widths. The search's trials are recorded as it makes them;
    the launch counters, zeroed just before the calibration and read
    just after, must be one truncate and one convert per leaf below
    AF32 in every trial and in each of the two ``metric_at`` calls (the
    tuned and the uniform widths), and no other kernel. Each kernel is
    then held bit for bit to its plain version on the tuned plan's
    leaves, and timed at the largest leaves' shapes beside its plain
    version and bound. Returns {"launches": by run, "kernels":
    truncate/convert's numbers}."""
    from collections import Counter

    from repro_torch.core import precision_tuning
    from repro_torch.core.calibrate import calibrate, float_leaves
    from repro_torch.core.compress import CompressionPlan
    from repro_torch.core.formats import FLOAT_LADDER
    from repro_torch.core.quality import QualitySpec
    from repro_torch.models.lm import LM

    small = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[cfg.name])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = LM(small, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    tensors = float_leaves(params)
    trials = []
    search = precision_tuning._search

    def recording_search(keys, weight, acceptable, ladder, max_passes=2):
        def judged(trial):
            trials.append(dict(trial))
            return acceptable(trial)
        return search(keys, weight, judged, ladder, max_passes)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    precision_tuning._search = recording_search
    try:
        with kernel_calls(torch, ops, ("truncate", "convert")) as events:
            res = calibrate(small, QualitySpec("loss_delta", CALIB_GATE),
                            params=params, max_seq_len=MAX_SEQ)
            torch.cuda.synchronize()
    finally:
        precision_tuning._search = search
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    plan = res.plan
    tuned = {k: plan.float_bits.get(k, 32) for k in tensors}
    uniform = {k: small.resolved_weight_bits for k in tensors}
    narrow = [sum(b < 32 for b in t.values())
              for t in trials + [tuned, uniform]]
    per_kernel = sum(narrow)
    expect = dict.fromkeys(counts, 0)
    expect.update(truncate=per_kernel, convert=per_kernel)
    kern = events()
    hist = Counter(plan.float_bits.values())
    numel = sum(v.numel() for v in tensors.values())
    out = {"model": small.name, "layers": small.n_layers, "seconds": secs,
           "peak_memory_gb": peak,
           "quantized_f32_gb": numel * 4 / 1e9,
           "params_gb": sum(v.numel() * v.element_size()
                            for v in tensors.values()) / 1e9,
           "summary": res.summary(), "tune_evals": res.tune_evals,
           "width_histogram_leaves": {str(b): hist[b] for b in sorted(hist)},
           "width_histogram_elements": {
               str(b): sum(tensors[k].numel() for k, w in
                           plan.float_bits.items() if w == b)
               for b in sorted(hist)},
           "int_bits": plan.int_bits, "trials": len(trials),
           "launches": counts, "launches_expected": expect,
           "event_ms_per_call": {
               n: k["event_ms"] / k["calls"] for n, k in kern.items()},
           "event_bound_ms_per_call": {
               n: k["bound_ms"] / k["calls"] for n, k in kern.items()}}
    log("calibrate: " + json.dumps(out))
    if not res.accepted:
        raise AssertionError(f"{small.name}: calibration missed its gate: "
                             f"{res.summary()}")
    if res.tune_evals != len(trials):
        raise AssertionError(f"{small.name}: {res.tune_evals} evaluations, "
                             f"{len(trials)} trials recorded")
    if counts != expect or not per_kernel:
        raise AssertionError(f"{small.name} calibration: launch counts "
                             f"{counts} != the search's {expect}")
    if any(b not in FLOAT_LADDER for b in plan.float_bits.values()):
        raise AssertionError(f"{small.name}: plan widths {plan.float_bits}")

    # one trial's leaves (the tuned plan's), each kernel bit for bit
    # against its plain version; then each timed at the largest leaves
    t1 = time.perf_counter()
    for key, bits in plan.float_bits.items():
        x = tensors[key]
        code = ops.truncate(x, bits)
        _same_bits_chunked(torch, code, ref.truncate_ref, x, bits,
                           f"truncate AF{bits} {key}")
        _same_bits_chunked(torch, ops.convert(code, bits), ref.convert_ref,
                           code, bits, f"convert AF{bits} {key}")
        del code
    check_s = time.perf_counter() - t1
    cases = {"truncate": [], "convert": []}
    for key in sorted(tensors, key=lambda k: -tensors[k].numel())[:3]:
        x, bits = tensors[key], plan.float_bits.get(key, 16)
        code = ops.truncate(x, bits)
        plain_ok = x.numel() <= CALIB_PLAIN_TIMED_MAX
        for name, operand, kernel, plain in (
                ("truncate", x, ops.truncate, ref.truncate_ref),
                ("convert", code, ops.convert, ref.convert_ref)):
            ms, issue = time_ms(torch, [lambda: kernel(operand, bits)], 5)
            nbytes = operand.numel() * (operand.element_size() + 4)
            b_ms, b_by = bound(nbytes, 0.0)
            rec = {"kernel": name, "leaf": key, "shape": list(x.shape),
                   "dtype": str(operand.dtype).split(".")[-1], "bits": bits,
                   "kernel_ms": ms, "host_issue_ms": issue,
                   "plain_ms": (time_ms(torch, [lambda: plain(operand, bits)],
                                        2)[0] if plain_ok else None),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms}
            cases[name].append(rec)
            log(json.dumps(rec))
        del code
        torch.cuda.empty_cache()
    log(f"calibrate: {small.name} {small.n_layers} layers, {res.tune_evals} "
        f"evaluations, plan {dict(hist)}; truncate and convert "
        f"{per_kernel} launches each, as the search's trials imply, and "
        f"bit-identical to their plain versions on the tuned leaves "
        f"({check_s:.1f} s)")

    launches = {f"{cfg.name} calibrate": counts}
    kernels = {name: {
        "calls_per_calibration": per_kernel, "trials": len(trials),
        "event_ms_per_call": out["event_ms_per_call"][name],
        "event_bound_ms_per_call": out["event_bound_ms_per_call"][name],
        "event_timing": "CUDA events around each wrapper call in the "
        "calibration, the stream not held: device time plus the host's "
        "issue where the stream idled", "leaf_cases": cases[name]}
        for name in cases}

    # serve the calibrated plan, then the seven-width one, on the same
    # weights (each engine packs its own copy of the tree)
    prompts = shared_prefix_prompts(np, cfg)
    keys = sorted(tensors)
    seven = CompressionPlan(
        float_bits={k: FLOAT_LADDER[i % len(FLOAT_LADDER)]
                    for i, k in enumerate(keys)}, int_bits={})
    for label, p in ((" calibrated plan", plan), (" seven-width plan",
                                                  seven)):
        counts, outs, eng, r = serve(torch, small, prompts, NEW_TOKENS,
                                     MAX_SEQ, params=params, plan=p,
                                     label=label)
        widths = leaf_widths(torch, eng.params)
        want = {k: p.float_bits.get(k, 32) for k in tensors}
        got = {k: widths[k] for k in tensors}
        if got != want:
            raise AssertionError(f"{small.name}{label}: leaf widths {got} "
                                 f"!= plan {want}")
        log(f"serve: {small.name}{label}: every leaf at its plan width "
            f"({dict(Counter(got.values()))}); decode call against the "
            f"plain versions {json.dumps(r['plain_decode'])}")
        launches[f"{cfg.name}{label}"] = counts
        del eng
        torch.cuda.empty_cache()
    del params, tensors
    torch.cuda.empty_cache()
    return {"launches": launches, "kernels": kernels}


# ---------------------------------------------------------------------------
# phase 3e: the kernel-granularity flow (Fig. 7)
# ---------------------------------------------------------------------------

# the suite's image side (kernel_suite.py) and the largest grid Rodinia's
# hotspot ships (temp_1024); paper_suite.py's perfect and high thresholds
# per metric. A trial at the gate is one an ulp of exp, or a reduction's
# order, may decide on one device and not on the other: at high, its
# metric lies within FLOW_GATE_MARGIN of the threshold; at perfect
# (bit-identical output, or no deviation at all), it was rejected with
# its outputs FLOW_GATE_ULPS f32 ulps or fewer from the reference's, in
# all (one or two outputs an ulp or two off)
FLOW_N, FLOW_BIG_N = 16, 1024
FLOW_THRESHOLDS = {"ssim": (1.0, 0.9), "deviation": (0.0, 10.0)}
FLOW_GATE_MARGIN = {"ssim": 1e-4, "deviation": 1e-3}
FLOW_GATE_ULPS = 2
# Table 4: the CUDA kernels' registers per thread. The occupancy figures
# anchor the absolute pressure there and apply the measured reduction, as
# paper_suite.py does
TABLE4_REGS = {"Deferred": 47, "Hotspot": 31, "CFD": 60, "IMGVF": 52}


def flow_deferred(albedo, normal_z, depth):
    import torch
    light = torch.clamp(normal_z, 0.0, 1.0)
    fog = torch.exp(-depth * 0.5)
    return albedo * light * fog + 0.1 * albedo


def flow_hotspot(temp, power):
    import torch
    rows = torch.arange(temp.shape[0], device=temp.device)
    cols = torch.arange(temp.shape[1], device=temp.device)
    border = ((rows[:, None] % (temp.shape[0] - 1)) == 0) | (
        (cols[None, :] % (temp.shape[1] - 1)) == 0)
    for _ in range(4):
        up = torch.roll(temp, 1, 0)
        dn = torch.roll(temp, -1, 0)
        lf = torch.roll(temp, 1, 1)
        rt = torch.roll(temp, -1, 1)
        delta = 0.1 * (up + dn + lf + rt - 4 * temp) + 0.05 * power
        temp = torch.where(border, temp, temp + delta)
    return temp


def flow_cfd(rho, mom):
    import torch
    for _ in range(3):
        flux = 0.25 * (torch.roll(rho, 1, 0) + torch.roll(rho, -1, 0)
                       + torch.roll(rho, 1, 1) + torch.roll(rho, -1, 1))
        rho = rho + 0.1 * (flux - rho) + 0.01 * mom
        mom = mom * 0.99
    return rho


def flow_imgvf(grad, mask):
    import torch
    v = grad
    for _ in range(5):
        lap = (torch.roll(v, 1, 0) + torch.roll(v, -1, 0)
               + torch.roll(v, 1, 1) + torch.roll(v, -1, 1) - 4 * v)
        v = v + 0.2 * lap - 0.1 * mask * (v - grad)
    return v


# torch twins of kernel_suite.py's kernels, in its operation order:
# name -> (twin, N x N inputs, metric, warps per block and shared bytes
# per block (Table 4))
FLOW_SUITE = {"Deferred": (flow_deferred, 3, "ssim", 8, 0),
              "Hotspot": (flow_hotspot, 2, "deviation", 8, 0),
              "CFD": (flow_cfd, 2, "deviation", 6, 0),
              "IMGVF": (flow_imgvf, 2, "deviation", 10, 14560)}


def flow_inputs(torch, np, name, n, device):
    """The kernel's n x n inputs, uniform in [0, 1), from numpy, seed 0."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.random((n, n), dtype=np.float32))
                 .to(device) for _ in range(FLOW_SUITE[name][1]))


def recording_spec(kind, threshold):
    """A QualitySpec that records every trial: (metric, accepted, the
    outputs' distance in f32 ulps from the reference's, summed)."""
    import torch

    from repro_torch.core.quality import QualitySpec

    @dataclasses.dataclass(frozen=True)
    class Recording(QualitySpec):
        trials: list = dataclasses.field(default_factory=list,
                                         compare=False)

        def accepts(self, ref, out) -> bool:
            ok = super().accepts(ref, out)
            ulps = (ref.float().view(torch.int32).long()
                    - out.float().view(torch.int32).long()).abs().sum()
            self.trials.append((self.metric(ref, out), ok, int(ulps)))
            return ok
    return Recording(kind, threshold)


def at_gate(spec, trial) -> bool:
    """Whether a recorded trial lies at its gate (FLOW_GATE_MARGIN,
    FLOW_GATE_ULPS)."""
    metric, accepted, ulps = trial
    perfect = (spec.threshold >= 1.0 if spec.kind == "ssim"
               else spec.threshold <= 0.0)
    if perfect:
        return not accepted and ulps <= FLOW_GATE_ULPS
    return abs(metric - spec.threshold) <= FLOW_GATE_MARGIN[spec.kind]


def compression_record(kc):
    """The fields phase 3e holds equal between the card and the CPU."""
    return {"float_formats": kc.float_formats, "int_bits": kc.int_bits,
            "baseline_pressure": kc.baseline_pressure,
            "packed_pressure": kc.packed_pressure,
            "split_count": kc.allocation.split_count,
            "table_words": kc.allocation.table_words(),
            "tune_evals": kc.tune_evals}


def flow_compress_parity(torch, np):
    """``compress_kernel`` of each twin at FLOW_N on the card and on the
    CPU, at the perfect and high thresholds, every trial recorded. Where
    the two searches take the same decisions, the float formats, int
    bits, both pressures, split counts and table words must be equal;
    where a decision differs, the first trial that differs must lie at
    the gate (``at_gate``) on one side, is named, and only the flow's
    properties are held (the card's formats meet the gate, packed
    pressure <= baseline). Trials at the gate are named either way.
    Returns {(name, threshold
    label): the card's KernelCompression}."""
    from repro_torch.core.compress import compress_kernel
    from repro_torch.core.precision_tuning import QuantizedKernel

    results = {}
    for name, (fn, _, kind, _, _) in FLOW_SUITE.items():
        for label, threshold in zip(("perfect", "high"),
                                    FLOW_THRESHOLDS[kind]):
            kc, specs, secs = {}, {}, {}
            for dev in ("cuda", "cpu"):
                specs[dev] = recording_spec(kind, threshold)
                args = flow_inputs(torch, np, name, FLOW_N, dev)
                t0 = time.perf_counter()
                kc[dev] = compress_kernel(name, fn, [args], specs[dev],
                                          device=dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
                secs[dev] = time.perf_counter() - t0
            trials = {d: specs[d].trials for d in specs}
            near = {d: [i for i, t in enumerate(trials[d])
                        if at_gate(specs[d], t)] for d in specs}
            differ = next((i for i, (a, b) in enumerate(zip(
                trials["cuda"], trials["cpu"])) if a[1] != b[1]), None)
            g, c = (compression_record(kc[d]) for d in ("cuda", "cpu"))
            rec = {"kernel": name, "threshold": f"{label} ({kind} "
                   f"{threshold})", "card_s": secs["cuda"],
                   "cpu_s": secs["cpu"], "evaluations": g["tune_evals"],
                   "values": len(g["float_formats"]),
                   "baseline_pressure": g["baseline_pressure"],
                   "packed_pressure": g["packed_pressure"],
                   "split_count": g["split_count"], "int_bits": g["int_bits"],
                   "mean_float_bits": sum(g["float_formats"].values())
                   / max(len(g["float_formats"]), 1),
                   "fewest_ulps_rejected": min(
                       [t[2] for d in trials for t in trials[d]
                        if not t[1]] + [math.inf]),
                   "nearest_metric_to_gate": min(
                       [abs(t[0] - threshold) for d in trials
                        for t in trials[d] if t[0] != threshold]
                       + [math.inf]),
                   "trials_at_gate": {d: [(i, trials[d][i]) for i in
                                          near[d]] for d in near},
                   "decisions": "identical" if differ is None and len(
                       trials["cuda"]) == len(trials["cpu"]) else
                   f"differ at trial {differ}"}
            if rec["decisions"] == "identical":
                if g != c:
                    raise AssertionError(f"flow {name} {label}: card {g} != "
                                         f"CPU {c}")
                rec["card_equals_cpu"] = sorted(g)
            else:
                if differ is None or differ not in near["cuda"] + near["cpu"]:
                    raise AssertionError(f"flow {name} {label}: decisions "
                                         f"differ away from the gate: {rec}")
                qk = QuantizedKernel(fn, *flow_inputs(torch, np, name, FLOW_N,
                                                      "cuda"), device="cuda")
                args = flow_inputs(torch, np, name, FLOW_N, "cuda")
                if not specs["cuda"].accepts(qk.run({}, *args), qk.run(
                        kc["cuda"].float_formats, *args)) or (
                        g["packed_pressure"] > g["baseline_pressure"]):
                    raise AssertionError(f"flow {name} {label}: the card's "
                                         f"result misses its gate: {rec}")
                rec["at_gate"] = {d: trials[d][differ] for d in trials}
            log("flow: " + json.dumps(rec, default=str))
            results[(name, label)] = kc["cuda"]
    return results


def flow_tune_big(torch, np, ops, ref):
    """``tune_kernel`` of each twin at FLOW_BIG_N x FLOW_BIG_N on the card
    at the high threshold (one 4 MB f32 grid a value): seconds to a
    device sync, evaluations, peak memory above the inputs, and B8's
    launches, zeroed just before and read just after, held to one
    truncate and one convert per value below 32 bits in every recorded
    run (the reference run, then one per evaluation). Then each tuned
    kernel's ``run`` with the CUDA B8 against the same run with B8's
    plain versions on the card, bit for bit; and truncate and convert
    timed at one grid (AF16) beside their bound and plain versions.
    Returns (launches by run, the kernels' numbers)."""
    from collections import Counter

    from repro_torch.core.precision_tuning import QuantizedKernel, tune_kernel
    from repro_torch.core.quality import HIGH

    launches, calls = {}, Counter()
    event_ms, event_bound_ms = Counter(), Counter()
    for name, (fn, _, kind, _, _) in FLOW_SUITE.items():
        args = flow_inputs(torch, np, name, FLOW_BIG_N, "cuda")
        qk = QuantizedKernel(fn, *args, device="cuda")
        runs = []
        run = qk.run

        def recording_run(formats, *a, _run=run, _runs=runs):
            _runs.append(dict(formats))
            return _run(formats, *a)
        qk.run = recording_run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with kernel_calls(torch, ops, ("truncate", "convert")) as events:
            res = tune_kernel(qk, [args], HIGH[kind])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        qk.run = run
        narrow = sum(sum(b < 32 for b in f.values()) for f in runs)
        expect = dict.fromkeys(counts, 0)
        expect.update(truncate=narrow, convert=narrow)
        kern = events()
        for k, v in kern.items():
            calls[k] += v["calls"]
            event_ms[k] += v["event_ms"]
            event_bound_ms[k] += v["bound_ms"]
        hist = Counter(res.formats.values())
        rec = {"kernel": name, "grid": [FLOW_BIG_N, FLOW_BIG_N],
               "values": len(qk.values), "seconds": secs,
               "evaluations": res.evaluations, "runs": len(runs),
               "ms_per_evaluation": secs * 1e3 / max(res.evaluations, 1),
               "peak_memory_mb_above_inputs": (peak - base) / 1e6,
               "peak_memory_mb": peak / 1e6,
               "mean_float_bits": res.mean_bits(),
               "width_histogram": {str(b): hist[b] for b in sorted(hist)},
               "launches": {k: v for k, v in counts.items() if v},
               "launches_expected": {k: v for k, v in expect.items() if v},
               "event_ms_per_call": {k: v["event_ms"] / v["calls"]
                                     for k, v in kern.items()}}
        log("flow tune: " + json.dumps(rec))
        if counts != expect or len(runs) != res.evaluations + 1:
            raise AssertionError(f"flow tune {name}: launches {counts} != "
                                 f"the recorded runs' {expect} "
                                 f"({len(runs)} runs)")
        launches[f"kernel flow {name} tune {FLOW_BIG_N}"] = counts

        # the tuned run: CUDA B8 against its plain versions on the card
        got = qk.run(res.formats, *args)
        ops.reset_launch_counts()
        with plain_ops(ops, ref):
            want = qk.run(res.formats, *args)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"flow {name}: the plain run launched "
                                 f"{ops.launch_counts()}")
        _expect_same_bits(torch, got, want, f"flow {name} tuned run")
        log(f"flow: {name} tuned run at {FLOW_BIG_N}x{FLOW_BIG_N}, "
            f"{sum(b < 32 for b in res.formats.values())} values below 32 "
            f"bits: CUDA B8 and its plain versions bit-identical")
        del qk, got, want, args
        torch.cuda.empty_cache()

    # B8 at one grid of the flow (AF16): kernel, plain, bound
    x = torch.rand(FLOW_BIG_N, FLOW_BIG_N, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    code = ops.truncate(x, 16)
    grid = {}
    for name, operand, kernel, plain in (
            ("truncate", x, ops.truncate, ref.truncate_ref),
            ("convert", code, ops.convert, ref.convert_ref)):
        ms, issue = time_ms(torch, [lambda: kernel(operand, 16)], 20)
        b_ms, b_by = bound(operand.numel() * 8, 0.0)
        grid[name] = {"shape": [FLOW_BIG_N, FLOW_BIG_N], "bits": 16,
                      "kernel_ms": ms, "host_issue_ms": issue,
                      "plain_ms": time_ms(torch, [lambda: plain(operand, 16)],
                                          5)[0],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_share": b_ms / ms}
        log(f"flow {name}: " + json.dumps(grid[name]))
    kernels = {k: {"calls_in_flow_tunes": calls[k],
                   "event_ms_per_call": event_ms[k] / max(calls[k], 1),
                   "event_bound_ms_per_call": event_bound_ms[k]
                   / max(calls[k], 1),
                   "event_timing": "CUDA events around each wrapper call in "
                   "the tunes, the stream not held: device time plus the "
                   "host's issue where the stream idled",
                   "grid_call": grid[k]} for k in ("truncate", "convert")}
    return launches, kernels


def flow_lanes(np, op, rng):
    """32 lanes for an operand: f32 values over a few magnitudes, or
    integers anywhere in its range."""
    if op.is_float:
        return (rng.standard_normal(32) * np.exp2(rng.integers(-8, 8, 32))
                ).astype(np.float32)
    lo, hi = ((-(1 << (op.bits - 1)), (1 << (op.bits - 1)) - 1) if op.signed
              else (0, (1 << op.bits) - 1))
    v = rng.integers(lo, hi + 1, 32, dtype=np.int64)
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def flow_register_file(torch, np, ops, compressions):
    """Each allocation's register file on the card (B8's CUDA truncate and
    convert as the Value Truncator and Converter) and on the CPU: every
    operand written across a warp's 32 lanes and read back; the lanes,
    the raw codes, the storage and the fetch and double-fetch counters
    must be equal, and the card's B8 launches one truncate per float
    write and one convert per float read."""
    from repro_torch.core.regfile import PackedRegisterFile

    launches = {}
    for (name, label), kc in compressions.items():
        rng = np.random.default_rng(0)
        values = {op.name: flow_lanes(np, op, rng) for op in kc.operands}
        out = {}
        for dev in ("cuda", "cpu"):
            rf = PackedRegisterFile(allocation=kc.allocation, device=dev)
            ops.reset_launch_counts()
            for op in kc.operands:
                rf.write(op.name, torch.from_numpy(values[op.name]).to(dev))
            reads = [rf.read(op.name) for op in kc.operands]
            raws = [rf.read_raw(op.name) for op in kc.operands]
            counts = ops.launch_counts()
            out[dev] = ([r.cpu().view(torch.int32) for r in reads + raws],
                        rf.storage.cpu(),
                        (rf.src_table_reads, rf.dst_table_reads,
                         rf.register_fetches, rf.double_fetches), counts)
        g, c = out["cuda"], out["cpu"]
        floats = sum(op.is_float for op in kc.operands)
        lanes_equal = all(torch.equal(a, b) for a, b in zip(g[0], c[0]))
        if not (lanes_equal and torch.equal(g[1], c[1]) and g[2] == c[2]):
            raise AssertionError(f"flow register file {name} {label}: card "
                                 f"and CPU differ (counters {g[2]} / {c[2]})")
        want = dict.fromkeys(g[3], 0)
        want.update(truncate=floats, convert=floats)
        if g[3] != want:
            raise AssertionError(f"flow register file {name} {label}: "
                                 f"launches {g[3]} != {want}")
        launches[f"kernel flow {name} {label} register file"] = g[3]
        log(f"flow register file: {name} {label}: {len(kc.operands)} "
            f"operands ({floats} float) in {kc.allocation.registers_used} "
            f"registers, {kc.allocation.split_count} split; lanes, storage "
            f"and counters (src/dst table reads, fetches, double fetches "
            f"{g[2]}) equal card and CPU")
    return launches


def flow_paper_model(compressions):
    """Table 1's occupancy chain, the area table and Fig. 9-12's numbers
    from the flow's pressures: host arithmetic and the cycle-level model
    of the paper's Fermi SM (not a measurement of this card)."""
    from repro_torch.core import area_model, smsim
    from repro_torch.core.occupancy import ipc_uplift_table1, occupancy

    prof = smsim.KernelProfile("imgvf", n_instructions=600, frac_mem=0.10,
                               frac_sfu=0.03, dep_distance=4, seed=1)
    trace = smsim.build_trace(prof)
    orig, packed = occupancy(52, 10), occupancy(29, 10)
    table1 = dict(ipc_uplift_table1(), model_ipc={
        "original": smsim.simulate(trace, orig.warps,
                                   smsim.BASELINE_PIPE).ipc,
        "packed_rf": smsim.simulate(trace, packed.warps,
                                    smsim.PROPOSED_PIPE).ipc,
        "artificial": smsim.simulate(trace, packed.warps,
                                     smsim.BASELINE_PIPE).ipc})
    log("paper model (Fermi SM, not this card): table 1 "
        + json.dumps(table1))
    a, v = area_model.fermi_area(), area_model.volta_area()
    log("paper model: area " + json.dumps({
        **dataclasses.asdict(a), "fermi_per_sm": a.total_per_sm,
        "fermi_total": area_model.fermi_total(),
        "fermi_fraction": area_model.fermi_fraction(), "volta": v}))
    figs = {}
    for name, (_, _, _, warps, shared) in FLOW_SUITE.items():
        perfect, high = (compressions[(name, t)] for t in ("perfect",
                                                            "high"))
        bars = {"baseline": perfect.baseline_pressure,
                "ints_only": perfect.repressure(True, False),
                "floats_perfect": perfect.repressure(False, True),
                "floats_high": high.repressure(False, True),
                "both_perfect": perfect.packed_pressure,
                "both_high": high.packed_pressure}
        scale = TABLE4_REGS[name] / max(bars["baseline"], 1)
        occ = {k: occupancy(max(int(round(bars[k] * scale)), 1), warps,
                            shared) for k in ("baseline", "both_perfect",
                                              "both_high")}
        figs[name] = {"fig9_pressure": bars, "fig10_occupancy": {
            k: o.occupancy for k, o in occ.items()}}
        if name == "IMGVF":
            figs[name]["fig12_ipc_by_writeback_delay"] = \
                smsim.writeback_sensitivity(smsim.KernelProfile(
                    name, n_instructions=400, frac_mem=0.12, frac_sfu=0.04,
                    dep_distance=4, seed=1), occ["both_high"].warps)
    log("paper model: figures 9, 10, 12 from the flow's pressures "
        + json.dumps(figs))


def flow_phase(torch, np, ops, ref):
    """Phase 3e: the kernel-granularity flow on the card. Returns
    {"launches": by run, "kernels": truncate/convert's numbers}."""
    t0 = time.perf_counter()
    compressions = flow_compress_parity(torch, np)
    t1 = time.perf_counter()
    launches, kernels = flow_tune_big(torch, np, ops, ref)
    t2 = time.perf_counter()
    launches.update(flow_register_file(torch, np, ops, compressions))
    flow_paper_model(compressions)
    log(f"flow: {time.perf_counter() - t0:.1f} s (compress parity "
        f"{t1 - t0:.1f} s, tunes at {FLOW_BIG_N} {t2 - t1:.1f} s)")
    return {"launches": launches, "kernels": kernels}


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 3f: the static-analysis lint gate on the card
# ---------------------------------------------------------------------------

# the reference's broken plan (4 plan_soundness errors on reduced qwen3-8b)
# and where the phase writes its reports (git-ignored)
LINT_FIXTURE = ROOT / "tests" / "fixtures" / "broken_plan.json"
LINT_OUT = ROOT / "build" / "lint"
AF16_MAX = 65504.0               # AF16's max_finite (IEEE binary16's)
# the kernels each model's lint window must launch (B1-B5; B6 for the banks)
LINT_KERNELS = {"dense": ("packed_matmul", "pack", "kv_decode", "take_rows",
                          "paged_attention"),
                "moe": ("packed_matmul_batched",)}
# a clean lint is one info finding from each pass, with every entry point
# run to its end: a warning (an entry point that raised, a failed trace of
# the donation pass) fails the phase
LINT_PASSES = ("activation_width", "plan_soundness", "dispatch", "sharding",
               "donation")
LINT_ENTRY_POINTS = {"decode_step", "paged_decode_step", "prefill_step",
                     "verify_step", "train_loss"}


def _lint_triples(report):
    from collections import Counter
    return Counter((f.check, f.severity, f.path) for f in report.findings)


def _lint_all_info(report, name: str) -> None:
    """One info finding from each pass and nothing else, the dispatch
    pass's naming every entry point as run to its end."""
    found = sorted((f.check, f.severity) for f in report.findings)
    if found != sorted((c, "info") for c in LINT_PASSES):
        got = [(f.check, f.severity, f.message) for f in report.findings]
        raise AssertionError(f"lint {name}: findings {got}, not one info "
                             "from each pass")
    (disp,) = [f for f in report.findings if f.check == "dispatch"]
    traced = set((disp.detail or {}).get("traced", ()))
    if traced != LINT_ENTRY_POINTS:
        raise AssertionError(f"lint {name}: entry points run {sorted(traced)}"
                             f", not {sorted(LINT_ENTRY_POINTS)}")


def _lint_report_valid(report, name: str) -> None:
    from repro_torch.obs.schema import validate_lint_report
    LINT_OUT.mkdir(parents=True, exist_ok=True)
    path = LINT_OUT / f"{name}.json"
    report.save(str(path))
    errors = validate_lint_report(str(path))[1]
    if errors:
        raise AssertionError(f"lint {name}: report invalid: {errors}")


def lint_full_width(torch, ops, cfg):
    """``run_lint`` on the card at full width, cut to TRAIN_LAYERS, over
    random weights from seed 0 and the uniform AF16 plan: clean, valid,
    the window's kernels launched, and the proven KV widths and bounds
    those of the activation pass on the CPU over the same leaves."""
    from repro_torch.analysis.activations import infer_kv_widths
    from repro_torch.analysis.lint import run_lint
    from repro_torch.analysis.sharding_lint import decode_program
    from repro_torch.models.lm import LM

    small = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[cfg.name])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = LM(small, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_program(small)           # the donation pass's trace, on the host
    trace_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = run_lint(small, cfg.name, params=params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    _lint_all_info(report, cfg.name)
    _lint_report_valid(report, cfg.name)
    missing = [k for fam in sorted({"dense", cfg.family})
               for k in LINT_KERNELS.get(fam, ()) if counts[k] == 0]
    if missing:
        raise AssertionError(f"lint {cfg.name}: the window launched no "
                             f"{missing}: {counts}")
    attn = params["blocks"]["attn"]
    cpu = {"blocks": {"attn": {k: attn[k].cpu() for k in
                               ("ln", "wk", "wv", "k_norm") if k in attn}}}
    bits, bounds, _ = infer_kv_widths(small, params=cpu)
    if (bits, bounds) != (report.kv_bits, report.kv_bounds):
        raise AssertionError(f"lint {cfg.name}: card kv widths/bounds "
                             f"{report.kv_bits} {report.kv_bounds} != "
                             f"CPU {bits} {bounds}")
    log("lint: " + json.dumps({
        "model": cfg.name, "layers": small.n_layers,
        "donation_trace_s": round(trace_s, 2),
        "seconds_after_trace": round(secs, 2),
        "findings": len(report.findings), "clean": report.clean,
        "kv_bits": report.kv_bits, "kv_bounds": report.kv_bounds,
        "af16_max_finite": AF16_MAX,
        "launches": {k: v for k, v in counts.items() if v}}))
    del params
    return counts


def lint_reduced(torch, ops, cfg):
    """The reduced config linted on the card and on the CPU from the
    same parameters: the same verdicts, findings (check, severity,
    path), KV widths and bounds."""
    from repro_torch.analysis.lint import run_lint
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.models.lm import LM

    small = cfg.reduced()
    params = LM(small, device="cpu").init()
    t0 = time.perf_counter()
    card = run_lint(small, cfg.name, params=tree_to(params, "cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = run_lint(small, cfg.name, device="cpu", params=params)
    log(f"lint {small.name}: card {t1 - t0:.2f} s (the donation trace "
        f"included), CPU {time.perf_counter() - t1:.2f} s")
    for what, a, b in (("clean", card.clean, cpu.clean),
                       ("findings", _lint_triples(card), _lint_triples(cpu)),
                       ("kv_bits", card.kv_bits, cpu.kv_bits),
                       ("kv_bounds", card.kv_bounds, cpu.kv_bounds)):
        if a != b:
            raise AssertionError(f"lint {small.name}: card {what} {a} != "
                                 f"CPU {b}")
    _lint_all_info(card, small.name)
    return card


def lint_negative_legs(cfg):
    """The CLI on the card, reduced config: the broken plan exits 1 with
    the reference's 4 plan_soundness errors on their paths;
    ``--inject-fallback`` exits 1 with a "fell off the fused path" error
    finding (the card's refusal, recorded), not an exception."""
    from repro_torch.analysis import lint
    from repro_torch.obs.schema import validate_lint_report

    arch = cfg.name.replace("-", "_")
    LINT_OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    for leg, extra in (("broken_plan", ["--plan", str(LINT_FIXTURE)]),
                       ("inject_fallback", ["--inject-fallback"])):
        path = LINT_OUT / f"{arch}_{leg}.json"
        with contextlib.redirect_stdout(sys.stderr):
            rc = lint.main(["--arch", arch, "--out", str(path), *extra])
        if rc != 1:
            raise AssertionError(f"lint {leg}: exit {rc}, not 1")
        if validate_lint_report(str(path))[1]:
            raise AssertionError(f"lint {leg}: report invalid")
        findings = json.loads(path.read_text())["findings"]
        if any(f["severity"] == "warning" for f in findings):
            raise AssertionError(f"lint {leg}: warnings in {findings}")
        out[leg] = [f for f in findings if f["severity"] == "error"]
    paths = sorted(f["path"] for f in out["broken_plan"])
    if paths != ["embed", "inputs/tokens", "kv/layer_0", "kv/layer_99"] or \
            {f["check"] for f in out["broken_plan"]} != {"plan_soundness"}:
        raise AssertionError(f"lint broken plan: errors {paths}")
    fell = [f for f in out["inject_fallback"]
            if "fell off the fused path" in f["message"]]
    if len(fell) != 1 or fell[0]["detail"]["spec"] != "...b,ab->...a":
        raise AssertionError(f"lint inject: {out['inject_fallback']}")
    log(f"lint negative legs (card): broken plan {paths}; inject-fallback "
        f"{json.dumps(fell[0]['detail'])}, {len(out['inject_fallback'])} "
        "error(s)")


def lint_phase(torch, ops, qwen, moe):
    """Phase 3f. Returns {"launches": by run}."""
    t0 = time.perf_counter()
    launches = {f"{cfg.name} lint": lint_full_width(torch, ops, cfg)
                for cfg in (qwen, moe)}
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    for cfg in (qwen, moe):
        lint_reduced(torch, ops, cfg)
    lint_negative_legs(qwen)
    launches["lint reduced and negative legs"] = ops.launch_counts()
    log(f"lint: {time.perf_counter() - t0:.1f} s (full width "
        f"{t1 - t0:.1f} s); reduced card == CPU for {qwen.name}, "
        f"{moe.name}")
    return {"launches": launches}


def parity(torch, np, cfg):
    """PARITY_STEPS decode steps of ``cfg`` cut to 2 layers (the hybrid
    to 4: one group of 2 RG-LRU layers and an attention layer, and one
    tail layer; encdec's encoder to 2) in f32, at full width, on the card
    against the CPU with the same weights, packed at the config's width
    (plain where it packs none: paper_native): max abs logit error
    (tolerance 1e-3, argmax equal). encdec attends a cross cache of
    random values (the engine's is all zeros) over all its rows. Then
    ``prefill`` and ``loss`` of one sequence of PARITY_T tokens (the
    vlm's image prefix and encdec's frames included) from a seeded
    generator: the last position's logits within 1e-3 with the same
    argmax, the loss within 1e-3. For the MoE family also the routing
    choices (token, k) that ``blocks.route`` gave every MoE call on both
    sides, and how many of them differ: a near-tie in the router can
    flip an expert when the router's sums run in another order."""
    from repro_torch.core.compress import repack, uniform_plan
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.kernels import ops
    from repro_torch.models import blocks as B
    from repro_torch.models.lm import LM

    small = dataclasses.replace(
        cfg, n_layers=4 if cfg.family == "hybrid" else 2, dtype="float32",
        encoder_layers=min(cfg.encoder_layers, 2))
    lm_g, lm_c = LM(small, device="cuda"), LM(small, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = lm_g.init(gen)
    params = repack(params, uniform_plan(params,
                                         small.compression.weight_bits))
    params_c = tree_to(params, "cpu")
    st_g = lm_g.init_decode_state(SLOTS, 32)
    if small.family == "encdec":
        for name in ("ck", "cv"):
            rows = st_g["cross"][name]
            rows.copy_(ops.pack(torch.randn(
                rows.shape[:-1] + (small.resolved_head_dim,), generator=gen,
                device="cuda"), small.compression.kv_bits))
        st_g["clen"].fill_(small.encoder_seq)
    st_c = tree_to(st_g, "cpu")
    rng = np.random.default_rng(1)
    choices = {"cuda": [], "cpu": []}
    route = B.route

    def recording_route(p, xf, c):
        out = route(p, xf, c)
        choices[xf.device.type].append(out[1].cpu())
        return out

    t0 = time.perf_counter()
    worst = 0.0
    B.route = recording_route
    try:
        for step in range(PARITY_STEPS):
            toks = torch.from_numpy(rng.integers(0, small.vocab_size,
                                                 (SLOTS, 1)))
            lg, st_g = lm_g.decode_step(params, st_g, toks.cuda())
            lc, st_c = lm_c.decode_step(params_c, st_c, toks)
            lg = lg.cpu()
            assert lg.shape == (SLOTS, 1, small.vocab_size)
            assert torch.isfinite(lg).all().item()
            err = (lg - lc).abs().max().item()
            worst = max(worst, err)
            if err > 1e-3:
                raise AssertionError(f"{small.name} parity step {step}: max "
                                     f"err {err} > 1e-3")
            if not torch.equal(lg.argmax(-1), lc.argmax(-1)):
                raise AssertionError(f"{small.name} parity step {step}: "
                                     "argmax differs")
        batch = prefill_batch(torch, small, torch.Generator().manual_seed(1),
                              1, PARITY_T)
        with torch.no_grad():
            pg = [lm_g.prefill(params, {k: v.cuda() for k, v in
                                        batch.items()})[0].cpu(),
                  lm_g.loss(params, {k: v.cuda() for k, v in
                                     batch.items()}).cpu()]
            pc = [lm_c.prefill(params_c, batch)[0],
                  lm_c.loss(params_c, batch)]
    finally:
        B.route = route
    assert pg[0].shape == (1, 1, small.vocab_size)
    assert torch.isfinite(pg[0]).all().item() and math.isfinite(pg[1].item())
    prefill_err = (pg[0] - pc[0]).abs().max().item()
    loss_err = abs(pg[1].item() - pc[1].item())
    if prefill_err > 1e-3 or loss_err > 1e-3:
        raise AssertionError(f"{small.name} prefill parity: logit err "
                             f"{prefill_err}, loss err {loss_err} > 1e-3")
    if not torch.equal(pg[0].argmax(-1), pc[0].argmax(-1)):
        raise AssertionError(f"{small.name} prefill parity: argmax differs")
    routing = ""
    if small.family == "moe":
        g, c = torch.cat(choices["cuda"]), torch.cat(choices["cpu"])
        assert g.shape == c.shape and g.shape[0] == small.n_layers * (
            PARITY_STEPS * SLOTS + 2 * PARITY_T)
        routing = (f"; routing choices differing card vs CPU: "
                   f"{int((g != c).sum())} of {g.numel()}")
    log(f"parity: {small.name} {small.n_layers} layers f32, {PARITY_STEPS} "
        "decode step(s) "
        "card vs CPU: "
        f"max abs logit err {worst:.3g} (tol 1e-3), argmax equal; prefill "
        f"of {PARITY_T} tokens: max abs logit err {prefill_err:.3g}, argmax "
        f"equal, loss {pc[1].item():.6g} err {loss_err:.3g} (tol 1e-3)"
        f"{routing} ({time.perf_counter() - t0:.1f} s)")


def train_parity(torch, np, cfg):
    """One packed-master gradient of ``cfg`` cut to 2 layers (encdec's
    encoder too) in f32, at full width, on the card (kernels) against
    the CPU (plain versions), on the same AF16 codes and masters and one
    sequence of PARITY_T tokens: the loss (within 1e-4 relative) and
    every master's gradient (relative L2 within GRAD_RTOL); for the MoE
    family also the routing choices that differ between the two."""
    from repro_torch.core.compress import repacked_copy, uniform_plan
    from repro_torch.core.tensor_store import (st_tree, tree_leaves,
                                               tree_map_with_path, tree_to)
    from repro_torch.models import blocks as B
    from repro_torch.models.lm import LM
    from repro_torch.train.loop import TrainConfig, _grad_loop

    small = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                encoder_layers=min(cfg.encoder_layers, 2))
    t0 = time.perf_counter()
    lm = {"cuda": LM(small, device="cuda"), "cpu": LM(small, device="cpu")}
    masters = lm["cuda"].init(torch.Generator(device="cuda").manual_seed(3))
    packed = repacked_copy(masters, uniform_plan(masters, 16))
    trees = {"cuda": (packed, masters),
             "cpu": (tree_to(packed, "cpu"), tree_to(masters, "cpu"))}
    batch = prefill_batch(torch, small, torch.Generator().manual_seed(4), 1,
                          PARITY_T)
    choices = {"cuda": [], "cpu": []}
    route = B.route

    def recording_route(p, xf, c):
        out = route(p, xf, c)
        choices[xf.device.type].append(out[1].cpu())
        return out

    out = {}
    B.route = recording_route
    try:
        for dev, (pk, ms) in trees.items():
            for leaf in tree_leaves(ms):
                leaf.requires_grad_(True)
            loss, grads = _grad_loop(
                lambda m, b, pk=pk, dev=dev: lm[dev].loss(st_tree(pk, m), b),
                ms, {k: v.to(dev) for k, v in batch.items()}, TrainConfig())
            out[dev] = (loss.item(), tree_map_with_path(
                lambda _, g: g.detach().cpu(), grads))
            del grads
    finally:
        B.route = route
    rels = []
    tree_map_with_path(lambda path, g, c: rels.append((
        ((g - c).norm() / c.norm().clamp(min=1e-30)).item(), path)),
        out["cuda"][1], out["cpu"][1])
    worst, leaves = max(rels)[0], len(rels)
    if worst > GRAD_RTOL:
        raise AssertionError(f"{small.name} train parity: {max(rels)[1]} "
                             f"gradient relative L2 {worst} > {GRAD_RTOL}")
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    if not math.isfinite(out["cuda"][0]) or loss_rel > 1e-4:
        raise AssertionError(f"{small.name} train parity: loss "
                             f"{out['cuda'][0]} against {out['cpu'][0]}")
    routing = ""
    if small.family == "moe":
        g, c = torch.cat(choices["cuda"]), torch.cat(choices["cpu"])
        routing = (f"; routing choices differing card vs CPU: "
                   f"{int((g != c).sum())} of {g.numel()}")
    log(f"train parity: {small.name} {small.n_layers} layers f32, one "
        f"packed-master gradient of {PARITY_T} tokens card vs CPU: loss "
        f"{out['cpu'][0]:.6g} relative err {loss_rel:.3g}; {leaves} master "
        f"gradients, worst relative L2 {worst:.3g} (tol {GRAD_RTOL})"
        f"{routing} ({time.perf_counter() - t0:.1f} s)")


def paged_parity(torch, np, cfg):
    """The paged engine on ``cfg``'s reduced config (2 layers, narrow
    widths, f32: the plain versions on the CPU prefill a hundred
    positions, far too slow at full width), on the card against the CPU
    with the same packed weights, shared-prefix traffic on an
    over-committed pool: identical tokens and pool counters; and every
    decode call of the card's drain replayed on the CPU from the same
    paged state: max abs logit error (tolerance 1e-3)."""
    from repro_torch import obs
    from repro_torch.core.compress import repack, uniform_plan
    from repro_torch.core.tensor_store import tree_map_with_path, tree_to
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeEngine

    small = dataclasses.replace(cfg.reduced(), n_layers=2, dtype="float32")
    params = LM(small, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(2))
    params = repack(params, uniform_plan(params, 16))
    rng = np.random.default_rng(1)
    system = [int(t) for t in rng.integers(1, small.vocab_size, 16)]
    prompts = [system + [int(t) for t in rng.integers(1, small.vocab_size, n)]
               for n in rng.integers(2, 11, 6)]
    t0 = time.perf_counter()
    runs, calls = {}, []
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(small, max_seq_len=64, max_slots=4,
                          pack_weights=True, paged=True, kv_page_size=8,
                          kv_pool_pages=16, params=tree_to(params, dev),
                          device=dev)
        if dev == "cuda":
            step = eng.lm.decode_step

            def recording(p, state, toks, step=step):
                before = tree_map_with_path(
                    lambda _, t: t.to("cpu", copy=True), state)
                out = step(p, state, toks)
                calls.append((before, toks.cpu(), out[0].cpu()))
                return out

            eng.lm.decode_step = recording
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        stats = eng.run_until_drained()
        runs[dev] = ([eng.result(r) for r in rids],
                     {k: stats[k] for k in sorted(
                         obs.schema.SNAPSHOT_KEYS_PAGED)})
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError(f"{small.name} paged parity: card and CPU "
                             f"differ: {runs}")
    lm_c = LM(small, device="cpu")
    params_c = tree_to(params, "cpu")
    worst = 0.0
    for before, toks, lg in calls:
        # slots holding a request; idle slots attend the scrap page, whose
        # rows every idle slot writes (in no fixed order on the card)
        live = before["table"][:, 0] != 0
        lc, _ = lm_c.decode_step(params_c, before, toks)
        assert torch.isfinite(lg[live]).all().item()
        worst = max(worst, (lg[live] - lc[live]).abs().max().item())
    if worst > 1e-3:
        raise AssertionError(f"{small.name} paged parity: max logit err "
                             f"{worst} > 1e-3")
    st = runs["cpu"][1]
    log(f"paged parity: {small.name} 2 layers f32, {len(prompts)} requests "
        f"on a 16-page pool, card vs CPU: tokens and {len(st)} pool counters "
        f"identical (prefix hits {st['prefix_hits']}, cow {st['cow_copies']}"
        f", table uploads {st['table_uploads']}); {len(calls)} decode calls "
        f"replayed on the CPU: max abs logit err {worst:.3g} (tol 1e-3) "
        f"({time.perf_counter() - t0:.1f} s)")


def speculative_parity(torch, np, cfg):
    """The three paths of speculative serving on ``cfg``'s reduced config
    (2 layers, narrow widths, f32), on the card against the CPU with the
    same AF16 packed weights: (1) sampled drains with a fixed
    sample_seed, plain and speculative, each run twice on the card:
    the same tokens both times; (2) per-layer KV widths (16, 12): one
    decode call from the same state, dense and paged, card against CPU:
    logits within 1e-3, every segment's cache words equal but those of
    the row each slot appends at ``len`` (through the page table when
    paged), which may round a code the other way (K and V come from the
    kernels on one side and the plain versions on the other) and must
    decode within a code step, and the dispatch records show
    each width's attention kernel; (3) greedy
    speculative drains (k = 2, AF12 draft), dense and paged: the card's
    tokens equal the CPU's."""
    from repro_torch.core.compress import repack, uniform_plan
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.kernels import ops, ref
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeEngine, SpeculativeEngine

    small = dataclasses.replace(cfg.reduced(), n_layers=2, dtype="float32")
    d = small.resolved_head_dim
    params = LM(small, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(3))
    params = repack(params, uniform_plan(params, 16))
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, small.vocab_size, n)]
               for n in (5, 1, 12)]
    kw = dict(max_seq_len=32, max_slots=4, pack_weights=True, kv_page_size=8)
    t0 = time.perf_counter()

    def drain(cls, dev, **extra):
        eng = cls(small, params=tree_to(params, dev), device=dev,
                  **dict(kw, **extra))
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        stats = eng.run_until_drained()
        return [eng.result(r) for r in rids], stats

    sampled = {}
    for cls, extra in ((ServeEngine, {}), (SpeculativeEngine, {"k": 2})):
        runs = [drain(cls, "cuda", greedy=False, sample_seed=7, **extra)[0]
                for _ in range(2)]
        if runs[0] != runs[1]:
            raise AssertionError(f"{cls.__name__} sampled drains with one "
                                 f"sample_seed differ on the card: {runs}")
        sampled[cls.__name__] = runs[0]

    widths = (16, 12)
    wcfg = dataclasses.replace(small, compression=dataclasses.replace(
        small.compression, kv_bits=max(widths), kv_layer_bits=widths))
    worst = 0.0
    for paged in (False, True):
        lms = {d: LM(wcfg, device=d) for d in ("cuda", "cpu")}
        st = (lms["cpu"].init_paged_decode_state(4, 32, 8, 16) if paged
              else lms["cpu"].init_decode_state(4, 32))
        # cache rows of random values packed at each segment's width
        cpu_gen = torch.Generator().manual_seed(5)
        for seg, (_, _, bits) in zip(st["kv"], wcfg.kv_segments()):
            for name in ("k", "v"):
                x = torch.randn(seg[name].shape[:-1] + (d,), generator=cpu_gen)
                seg[name].copy_(ref.pack_ref(x, bits))
        st["len"] = torch.tensor([0, 3, 17, 31], dtype=torch.int32)
        if paged:
            st["table"] = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
        toks = torch.from_numpy(rng.integers(0, small.vocab_size, (4, 1)))
        st_g = tree_to(st, "cuda")
        ops.DISPATCH_RECORDS.clear()
        lg, st_g = lms["cuda"].decode_step(tree_to(params, "cuda"), st_g,
                                           toks.cuda())
        attn = "paged_attention" if paged else "kv_decode"
        seen = sorted(r.bits for r in ops.DISPATCH_RECORDS if r.op == attn)
        lc, st_c = lms["cpu"].decode_step(tree_to(params, "cpu"), st, toks)
        err = (lg.cpu() - lc).abs().max().item()
        worst = max(worst, err)
        if not (err <= 1e-3 and torch.isfinite(lc).all().item()
                and seen == sorted(widths)):
            raise AssertionError(f"per-layer widths {widths} paged={paged}: "
                                 f"max err {err} > 1e-3 or {attn} widths "
                                 f"{seen}")
        # the appended rows pack K and V projected by the kernels on one
        # side and the plain versions on the other, so a code may round
        # the other way: those rows (slot b's at len[b], through its
        # page when paged) may differ by at most one code step of their
        # width; every other word is equal
        lens = st["len"].long()
        appended = torch.zeros(st["kv"][0]["k"].shape[1:3], dtype=torch.bool)
        if paged:
            page = st["table"][torch.arange(4), lens // 8].long()
            appended[page, lens % 8] = True
        else:
            appended[torch.arange(4), lens.clamp(max=31)] = True
        for sg, sc, (_, _, bits) in zip(st_g["kv"], st_c["kv"],
                                        wcfg.kv_segments()):
            for name in ("k", "v"):
                g = sg[name].cpu()
                vg, vc = (ref.unpack_ref(x, bits, d)
                          for x in (g[:, appended], sc[name][:, appended]))
                step = 2.0 ** -FLOAT_MANTISSA[bits]
                if not (torch.equal(g[:, ~appended], sc[name][:, ~appended])
                        and torch.allclose(vg, vc, rtol=step,
                                           atol=2.0 ** -12)):
                    raise AssertionError(
                        f"per-layer widths paged={paged} AF{bits} {name}: "
                        "a word outside the appended rows differs card vs "
                        "CPU, or an appended row by more than a code step")

    greedy = {}
    for paged in (False, True):
        runs = {dev: drain(SpeculativeEngine, dev, k=2, paged=paged)
                for dev in ("cuda", "cpu")}
        if runs["cuda"][0] != runs["cpu"][0]:
            raise AssertionError(f"speculative paged={paged}: card and CPU "
                                 f"tokens differ: {runs}")
        greedy["paged" if paged else "dense"] = {
            dev: round(r[1]["acceptance_rate"], 4) for dev, r in runs.items()}
    log(f"speculative parity: {small.name} 2 layers f32: sampled drains "
        f"(plain and speculative, sample_seed 7) identical twice on the card; "
        f"per-layer KV widths {widths}, dense and paged: one decode call card "
        f"vs CPU, max abs logit err {worst:.3g} (tol 1e-3), cache words "
        f"equal but the rows appended at len (within a code step), each "
        f"width's "
        f"attention dispatched; greedy speculative "
        f"drains (k 2) card and CPU tokens identical, acceptance "
        f"{json.dumps(greedy)} ({time.perf_counter() - t0:.1f} s)")


def window_parity(torch, np, cfg):
    """The hybrid engine on ``cfg``'s reduced config with ``attn_window``
    8 and 4 layers (one group and one tail layer), f32: six requests on
    four slots whose sequences run past the window, so each attention
    ring wraps, on the card against the CPU with the same AF16 packed
    weights: identical greedy tokens."""
    from repro_torch.core.compress import repack, uniform_plan
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeEngine

    small = dataclasses.replace(cfg.reduced(), attn_window=8, n_layers=4)
    params = LM(small, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(6))
    params = repack(params, uniform_plan(params, 16))
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, small.vocab_size, n)]
               for n in (12, 3, 9, 1, 14, 6)]
    t0 = time.perf_counter()
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(small, max_seq_len=32, max_slots=4,
                          pack_weights=True, params=tree_to(params, dev),
                          device=dev)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_drained()
        outs[dev] = [eng.result(r) for r in rids]
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"{small.name} window {small.attn_window}: card "
                             f"and CPU tokens differ: {outs}")
    log(f"window parity: {small.name} {small.n_layers} layers f32, window "
        f"{small.attn_window}, {len(prompts)} requests on 4 slots, sequences "
        f"up to {max(map(len, prompts)) + 5} positions: card and CPU tokens "
        f"identical ({time.perf_counter() - t0:.1f} s)")


def calibrate_parity(torch, cfg):
    """Calibrate ``cfg``'s reduced config (f32, 2 layers) on the card and
    on the CPU from the same parameters (seed 0, made on the CPU) and the
    same batches (the port's token stream, drawn on the CPU whatever the
    device): the plans must be identical
    (float and int widths) and ``tune_evals`` equal, ``ref_loss``,
    ``metric`` and ``uniform_metric`` within CALIB_PARITY_RTOL of the
    loss. Every trial's metric on both sides must lie further than
    CALIB_GATE_MARGIN from the gate, or an identical plan could be
    luck; the smallest distance is printed."""
    from repro_torch.core.calibrate import calibrate
    from repro_torch.core.quality import QualitySpec
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.models.lm import LM

    @dataclasses.dataclass(frozen=True)
    class Recording(QualitySpec):
        trials: list = dataclasses.field(default_factory=list,
                                         compare=False)

        def accepts(self, ref, out) -> bool:
            self.trials.append(self.metric(ref, out))
            return super().accepts(ref, out)

    small = cfg.reduced()
    params = LM(small, device="cpu").init(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    res, specs = {}, {}
    for device, p in (("cuda", tree_to(params, "cuda")), ("cpu", params)):
        specs[device] = Recording("loss_delta", CALIB_GATE)
        res[device] = calibrate(small, specs[device], params=p,
                                max_seq_len=64, device=device)
    g, c = res["cuda"], res["cpu"]
    margin = min(abs(m - CALIB_GATE) for spec in specs.values()
                 for m in spec.trials)
    errs = {k: abs(getattr(g, k) - getattr(c, k)) for k in (
        "ref_loss", "metric", "uniform_metric")}
    log(f"calibrate parity: {small.name} {small.n_layers} layers f32, card "
        f"vs CPU: plan {'identical' if g.plan == c.plan else 'DIFFERS'} "
        f"({len(g.plan.float_bits)} float leaves, int widths "
        f"{g.plan.int_bits}), tune_evals {g.tune_evals} / {c.tune_evals}; "
        f"errors {json.dumps(errs)} (tol {CALIB_PARITY_RTOL} x loss "
        f"{c.ref_loss:.6g}); smallest |trial metric - gate| {margin:.3g} "
        f"over {len(specs['cuda'].trials)} + {len(specs['cpu'].trials)} "
        f"trials (must exceed {CALIB_GATE_MARGIN}) "
        f"({time.perf_counter() - t0:.1f} s)")
    if margin <= CALIB_GATE_MARGIN:
        raise AssertionError(f"calibrate parity: a trial's metric lies "
                             f"{margin} from the gate")
    if g.plan.to_jsonable() != c.plan.to_jsonable() or (
            g.tune_evals != c.tune_evals):
        raise AssertionError(f"calibrate parity: card plan {g.plan} != CPU "
                             f"plan {c.plan}")
    if max(errs.values()) > CALIB_PARITY_RTOL * c.ref_loss:
        raise AssertionError(f"calibrate parity: {errs}")


def build_summary(log_text: str, kernel: str = "") -> str:
    """Registers, static shared memory and spills of the kernels the
    ``-Xptxas -v`` report names, or of those whose name holds
    ``kernel``."""
    parts = re.split(r"Compiling entry function", log_text)[1:]
    parts = [p for p in parts if kernel in p.split("\n", 1)[0]]
    regs = [int(r) for p in parts
            for r in re.findall(r"Used (\d+) registers", p)]
    smem = [int(b) for p in parts for b in re.findall(r"(\d+) bytes smem", p)]
    spills = sum(int(s) for p in parts
                 for s in re.findall(r"(\d+) bytes spill stores", p))
    return (f"{len(regs)} kernels, {min(regs) if regs else 0}-"
            f"{max(regs) if regs else 0} registers, max static shared "
            f"{max(smem) if smem else 0} bytes, {spills} bytes of spill "
            "stores")


def pmm_smem(build):
    """Dynamic shared memory a block of packed_matmul takes, per width and
    x dtype: the normal orientation's, and the transposed one's at slices
    of 2,048 columns (the tied heads')."""
    lib = build.library()
    return {f"{o}AF{b} {dt}": (lib.rt_pmm_t_smem(b, int(dt == "bf16"), 2048)
                               if o else lib.rt_pmm_smem(b, int(dt == "bf16")))
            for o in ("", "transposed ") for b in WIDTHS
            for dt in ("bf16", "f32")}


def attend_smem(build, cases):
    """Dynamic shared memory a block of the attention body takes at the
    phase-2 shapes: (name, config, cache rows) of ``cases``, AF16."""
    import torch

    from repro_torch.core.bitpack import packed_group_words
    from repro_torch.kernels.kv_decode import chunk_plan, tile_rows
    sms = build.sm_count(torch.empty(0, device="cuda"))
    out = {}
    for name, cfg, seq in cases:
        d = cfg.resolved_head_dim
        row = packed_group_words(d, 16) * 4
        chunk, _ = chunk_plan(SLOTS * cfg.n_kv_heads, seq, sms)
        tile = tile_rows(chunk, row)
        out[name] = {"chunk": chunk, "tile": tile,
                     "bytes": build.library().rt_attend_smem(
                         cfg.n_heads // cfg.n_kv_heads, d, row, chunk, tile)}
    return out


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref

    qwen, moe = get_config("qwen3_8b"), get_config("deepseek_moe_16b")
    fams = [get_config(a) for a in FAMILY_ARCHS]
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    build_log = (lib_path.parent / "build.log").read_text()
    log(f"build: {time.perf_counter() - t0:.1f} s ({lib_path.parent.name}); "
        + build_summary(build_log))
    pali, whisper, rgemma = fams[0], fams[1], fams[3]
    zoo = [zoo_config(get_config, a) for a in ZOO_ARCHS]
    log("kvd_partial (kv_decode and paged_attention's body): "
        + build_summary(build_log, "kvd_partial") + "; dynamic shared "
        + json.dumps(attend_smem(build, (
            ("qwen3_8b tick", qwen, MAX_SEQ), ("qwen3_8b check", qwen, 4096),
            ("deepseek_moe_16b tick", moe, MOE_MAX_SEQ),
            ("paligemma_3b tick", pali, MOE_MAX_SEQ),
            ("paligemma_3b check", pali, 4096),
            ("recurrentgemma_9b tick", rgemma, MOE_MAX_SEQ),
            ("whisper_small self", whisper, MOE_MAX_SEQ),
            ("whisper_small cross", whisper, whisper.encoder_seq),
            *((f"{z.name} {case}", z, seq) for z in zoo[1:4]
              for case, seq in (("tick", ZOO_MAX_SEQ), ("check", 4096)))))))
    log("pmm_kernel (packed_matmul's normal orientation): "
        + build_summary(build_log, "pmm_kernel") + "; pmm_t_mma_kernel "
        "(transposed): " + build_summary(build_log, "pmm_t_mma_kernel")
        + "; dynamic shared " + json.dumps(pmm_smem(build)))

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}                     # model -> kernel -> numbers per tick
    for cfg, seq in ((qwen, MAX_SEQ), (moe, MOE_MAX_SEQ),
                     *((f, MOE_MAX_SEQ) for f in fams),
                     *((z, ZOO_MAX_SEQ) for z in zoo)):
        if cfg in zoo:
            r = check_zoo(torch, F, ops, ref, gen, cfg)
        elif cfg.family in ("dense", "moe"):
            r = {"packed_matmul": check_packed_matmul(torch, ops, ref, gen,
                                                      cfg),
                 "pack": check_pack(torch, ops, ref, gen, cfg),
                 "kv_decode": check_kv_decode(torch, F, ops, ref, gen, cfg,
                                              seq),
                 "take_rows": check_take_rows(torch, F, ops, ref, gen, cfg)}
            if cfg.family == "moe":
                r["packed_matmul_batched"] = check_packed_matmul_batched(
                    torch, ops, ref, gen, cfg)
            else:
                r["paged_attention"] = check_paged_attention(
                    torch, F, ops, ref, gen, cfg)
        else:
            r = check_family(torch, F, ops, ref, gen, cfg, seq)
        results[cfg.name] = r
        log(f"{cfg.name}: kernel device time per decode tick "
            f"{sum(k['ms'] for k in r.values()):.3f} ms, bound "
            f"{sum(k['bound_ms'] for k in r.values()):.3f} ms "
            + json.dumps({n: round(k["ms"], 4) for n, k in r.items()}))
    standalone = check_unpack_convert(torch, ops, ref, gen, qwen)
    prefill_shapes = check_prefill_shapes(torch, F, ops, ref, gen, qwen,
                                          pali, moe)
    train_shapes = check_train_shapes(torch, ops, ref, gen, qwen, whisper,
                                      moe, pali)
    log(f"kernels checked ({time.perf_counter() - t_start:.0f} s so far)")

    launches = {}                    # drain -> kernel -> launches
    prompts = shared_prefix_prompts(np, qwen)
    launches[qwen.name], dense_outs, dense, plain = serve(
        torch, qwen, prompts, NEW_TOKENS, MAX_SEQ)
    launches[qwen.name + " paged"], paged_outs, paged, _ = serve(
        torch, qwen, prompts, NEW_TOKENS, MAX_SEQ, paged=True,
        params=dense.params)
    if paged_outs != dense_outs:
        raise AssertionError(f"{qwen.name}: paged greedy tokens differ from "
                             f"the dense drain's: {paged_outs} != {dense_outs}")
    log(f"{qwen.name}: paged and dense greedy tokens identical")
    del paged                      # its pool, before the speculative drains
    torch.cuda.empty_cache()
    plain["outs"] = dense_outs
    for spec_paged in (False, True):
        name = f"{qwen.name} speculative" + (" paged" if spec_paged else "")
        launches[name], _ = serve_speculative(torch, qwen, prompts,
                                              dense.params, spec_paged, plain)
        torch.cuda.empty_cache()
    prefill_runs = {}                # model -> (launches, kernel numbers)
    prefill_runs[qwen.name] = prefill_phase(torch, ops, qwen, dense.lm,
                                            dense.params)
    del dense                      # the weights, before deepseek's
    torch.cuda.empty_cache()
    launches[moe.name], _, eng, _ = serve(
        torch, moe, random_prompts(np, moe, MOE_PROMPTS), MOE_NEW_TOKENS,
        MOE_MAX_SEQ)
    prefill_runs[moe.name] = prefill_phase(torch, ops, moe, eng.lm,
                                           eng.params)
    del eng
    torch.cuda.empty_cache()
    heads = {}                       # tied model -> transposed launches
    for cfg in fams:
        prompts = random_prompts(np, cfg, MOE_PROMPTS)
        launches[cfg.name], outs, eng, _ = serve(
            torch, cfg, prompts, MOE_NEW_TOKENS, MOE_MAX_SEQ)
        if cfg.family == "vlm":
            launches[cfg.name + " paged"], paged_outs, paged, _ = serve(
                torch, cfg, prompts, MOE_NEW_TOKENS, MOE_MAX_SEQ, paged=True,
                params=eng.params)
            del paged                # its pool, before the next family's
            if paged_outs != outs:
                raise AssertionError(f"{cfg.name}: paged greedy tokens differ "
                                     f"from the dense drain's: {paged_outs} "
                                     f"!= {outs}")
            log(f"{cfg.name}: paged and dense greedy tokens identical")
        if cfg.tie_embeddings:       # the wrapper's count; serve() held
            heads[cfg.name] = sum(   # it to one a decode call, and > 0
                launches[m]["packed_matmul_transposed"]
                for m in (cfg.name, cfg.name + " paged") if m in launches)
        prefill_runs[cfg.name] = prefill_phase(torch, ops, cfg, eng.lm,
                                               eng.params)
        del eng
        torch.cuda.empty_cache()
    for name, (counts, _) in prefill_runs.items():
        launches[name + " prefill+loss"] = counts
    log(f"served and prefilled ({time.perf_counter() - t_start:.0f} s so far)")
    for cfg in zoo:
        launches.update(zoo_phase(torch, np, cfg))
    log(f"served the zoo configs ({time.perf_counter() - t_start:.0f} s so "
        "far)")
    train_runs = {}                  # model -> (launches, numbers) by mode
    for cfg in (qwen, moe, whisper):
        train_runs[cfg.name] = train_phase(torch, ops, cfg)
        for mode, counts in train_runs[cfg.name][0].items():
            launches[f"{cfg.name} train {mode}"] = counts
    log(f"trained ({time.perf_counter() - t_start:.0f} s so far)")
    calib = calibrate_phase(torch, np, ops, ref, qwen)
    launches.update(calib["launches"])
    log(f"calibrated and served the plans "
        f"({time.perf_counter() - t_start:.0f} s so far)")
    flow = flow_phase(torch, np, ops, ref)
    launches.update(flow["launches"])
    log(f"ran the kernel flow ({time.perf_counter() - t_start:.0f} s so far)")
    launches.update(lint_phase(torch, ops, qwen, moe)["launches"])
    log(f"linted ({time.perf_counter() - t_start:.0f} s so far)")
    for cfg in (qwen, moe, *fams, *zoo):
        parity(torch, np, cfg if cfg.family != "moe" or cfg is moe else
               dataclasses.replace(cfg, n_experts=ZOO_PARITY_EXPERTS))
    for cfg in (qwen, moe, whisper):
        train_parity(torch, np, cfg)
    paged_parity(torch, np, qwen)
    speculative_parity(torch, np, qwen)
    window_parity(torch, np, fams[-1])
    calibrate_parity(torch, qwen)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name in standalone:       # on no serving path: one call's numbers
            r, per_tick = standalone[name], {}
            timing = (f"one call at ({qwen.d_model}, {qwen.d_ff}), "
                      f"{qwen.name}'s w_up")
        else:                        # the first model whose path runs it
            model = next(m for m, rm in results.items() if name in rm)
            r = results[model][name]
            per_tick = {m: {k: rm[name][k] for k in (
                "ms", "bound_ms", "plain_ms", "library_ms")}
                for m, rm in results.items() if name in rm}
            timing = (f"per decode tick of full-width {model}: "
                      "calls_per_tick x one call")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in launches.values()),
            "max_abs_err": max([r["max_abs_err"]] + [
                rm[name]["max_abs_err"] for rm in results.values()
                if name in rm]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "calls_per_tick": r["calls_per_tick"], "timing": timing,
            "launches_by_drain": {m: c[name] for m, c in launches.items()},
            "per_tick_by_model": per_tick,
            **{k: r[k] for k in ("pack_call", "per_width", "many_rows")
               if k in r}})
        if name == "packed_matmul":  # the tied heads' transposed orientation
            kernels[-1]["transposed_heads"] = {
                m: dict(rm[name]["transposed_head"], launches=heads[m])
                for m, rm in results.items()
                if "transposed_head" in rm.get(name, {})}
        if name in train_shapes or name == "take_rows":    # training
            kernels[-1]["train"] = dict(
                train_shapes.get(name, {}),
                launches_per_step={
                    f"{m} {mode}": runs[mode]["launches_per_step"][name]
                    for m, (_, runs) in train_runs.items() for mode in runs},
                launches_by_run={f"{m} {mode}": c[name]
                                 for m, (cs, _) in train_runs.items()
                                 for mode, c in cs.items()})
        if name in calib["kernels"]:  # the tuner's round trip
            kernels[-1]["calibrate"] = calib["kernels"][name]
        if name in flow["kernels"]:   # the kernel flow's round trip
            kernels[-1]["flow"] = flow["kernels"][name]
        if name in prefill_shapes:   # at the rows the prefill gives it
            kernels[-1]["prefill"] = dict(
                prefill_shapes[name],
                launches_by_model={m: c[name]
                                   for m, (c, _) in prefill_runs.items()},
                path_by_model={m: {call: rk[call][name] for call in rk
                                   if name in rk[call]}
                               for m, (_, rk) in prefill_runs.items()},
                path_timing="event_ms: CUDA events around each wrapper "
                "call, the stream not held: the kernel's device time plus "
                "the host's issue of the call where the stream was idle")
    log(f"total {time.perf_counter() - t_start:.0f} s; card {smi.stdout.strip()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
