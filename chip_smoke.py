#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. the card's name and power limit; build the four CUDA kernels from the
   sources in this checkout (nvcc, one process per source).
2. each kernel against its plain PyTorch version on the card, at the
   shapes full-width qwen3-8b serving gives it, with the stated
   tolerance; kernel, plain and library-call times (CUDA events, weights
   rotated through enough copies to defeat the 50 MB L2) and the bound
   (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s).
3. serve full-width qwen3-8b (36 layers, bf16, AF16 weights and AF16 KV,
   random weights from a torch.Generator packed leaf by leaf on the
   card): 8 requests with prompts of 8-64 tokens, 16 new tokens each,
   8 slots, max_seq_len 256. Launch counters are zeroed just before and
   read just after; every kernel must have launched, exactly as often as
   the path's shape says.
4. cross-device parity: the same widths at 2 layers in f32, decode_step
   on the card (kernels) against the CPU (plain versions) with the same
   packed weights.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds every kernel's numbers. Without a card, or without the rest of the
repository beside it, the script fails before printing either.
"""
from __future__ import annotations

import dataclasses
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
L2_BYTES = 50 * 2**20
SLOTS, MAX_SEQ, NEW_TOKENS = 8, 256, 16
BF16_TOL = 2.0 ** -8             # one bf16 rounding of the f32 result

KERNELS = {
    "packed_matmul": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                      "src/repro/kernels/packed_matmul.py:160"),
    "pack": ("src/repro_torch/kernels/csrc/pack.cu",
             "src/repro/kernels/pack.py:37"),
    "kv_decode": ("src/repro_torch/kernels/csrc/kv_decode.cu",
                  "src/repro/kernels/kv_decode.py:85"),
    "take_rows": ("src/repro_torch/kernels/csrc/take.cu",
                  "src/repro/kernels/take.py:51"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


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

def check_packed_matmul(torch, ops, ref, gen, cfg):
    """Every product of a decode tick, M = slots, bf16 x, AF16 W."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    L = cfg.n_layers
    # (K, N, calls per decode tick, transpose, x dtype)
    cases = [(d, hq, 2 * L, False, torch.bfloat16),       # wq, wo
             (d, hkv, 2 * L, False, torch.bfloat16),      # wk, wv
             (d, f, 2 * L, False, torch.bfloat16),        # w_in, w_gate
             (f, d, L, False, torch.bfloat16),            # w_out
             (d, v, 1, False, torch.bfloat16),            # lm_head
             (d, hkv, 0, False, torch.float32),           # f32 activations
             (d, d, 0, True, torch.bfloat16)]             # tied-head orientation
    per_call = []
    for k, n, calls, transpose, xdt in cases:
        wshape = (n, k) if transpose else (k, n)
        w = torch.randn(wshape, generator=gen, device="cuda") / math.sqrt(k)
        wp = ops.pack(w, 16)
        w_lib = (ref.unpack_ref(wp, 16, k if transpose else n)
                 .to(torch.bfloat16))
        del w
        x = torch.randn((SLOTS, k), generator=gen, device="cuda").to(xdt)
        got = ops.packed_matmul(x, wp, 16, n, transpose)
        want = ref.packed_matmul_ref(x, wp, 16, n, transpose)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        scale = want.abs().max().item()
        tol = (BF16_TOL if xdt == torch.bfloat16 else 1e-5) * scale + 1e-4
        assert got.dtype == xdt and got.shape == (SLOTS, n)
        assert torch.isfinite(got).all().item()
        if err > tol:
            raise AssertionError(f"packed_matmul K={k} N={n} T={transpose} "
                                 f"{xdt}: max err {err} > tol {tol}")
        wbytes = wp.numel() * 4
        reps = [wp] + [wp.clone() for _ in range(copies_for(wbytes) - 1)]
        libs = [w_lib] + [w_lib.clone() for _ in range(
            copies_for(w_lib.numel() * 2) - 1)]
        calls_k = [lambda r=r: ops.packed_matmul(x, r, 16, n, transpose)
                   for r in reps]
        ms, issue = time_ms(torch, calls_k, 50)
        plain = time_ms(torch, [lambda: ref.packed_matmul_ref(
            x, wp, 16, n, transpose)], 3)[0]
        lib = time_ms(torch, [lambda r=r: torch.matmul(
            x.to(torch.bfloat16), r.t() if transpose else r) for r in libs],
            50)[0]
        b_ms, b_by = bound(wbytes + x.numel() * x.element_size()
                           + got.numel() * got.element_size(),
                           2.0 * SLOTS * n * k)
        rec = {"kernel": "packed_matmul", "K": k, "N": n,
               "transpose": transpose, "x_dtype": str(xdt).split(".")[-1],
               "calls_per_tick": calls, "max_err": err, "tol": tol,
               "kernel_ms": ms, "host_issue_ms": issue,
               "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib}
        log(json.dumps(rec))
        per_call.append(rec)
        del reps, libs, wp, w_lib, got, want
        torch.cuda.empty_cache()
    tick = [r for r in per_call if r["calls_per_tick"]]
    return {
        "max_abs_err": max(r["max_err"] for r in per_call),
        "ms": sum(r["calls_per_tick"] * r["kernel_ms"] for r in tick),
        "plain_ms": sum(r["calls_per_tick"] * r["plain_ms"] for r in tick),
        "bound_ms": sum(r["calls_per_tick"] * r["bound_ms"] for r in tick),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in tick)
        else "operations",
        "library_ms": sum(r["calls_per_tick"] * r["library_ms"] for r in tick),
        "calls_per_tick": sum(r["calls_per_tick"] for r in tick),
    }


def _special_rows(torch, gen, rows, n):
    x = torch.randn((rows, n), generator=gen, device="cuda")
    x = x * torch.exp2(torch.randint(-30, 30, (rows, n), generator=gen,
                                     device="cuda").float())
    sp = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1e-40,
                       65504.0, 65520.0, 5.96e-8, 2.98e-8, 1.0 + 2**-11],
                      device="cuda")
    x.view(-1)[: sp.numel()] = sp
    return x


def check_pack(torch, ops, ref, gen, cfg):
    """The KV append operand, (slots, Hkv * head_dim), at all 7 widths
    (bit-exact); timed at AF16."""
    n = cfg.n_kv_heads * cfg.resolved_head_dim
    x = _special_rows(torch, gen, SLOTS, n)
    for bits in (8, 12, 16, 20, 24, 28, 32):
        got = ops.pack(x, bits)
        want = ref.pack_ref(x, bits)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"pack AF{bits}: words differ")
    x16 = torch.randn((SLOTS, n), generator=gen, device="cuda")
    calls_k = [lambda: ops.pack(x16, 16)]
    ms, issue = time_ms(torch, calls_k, 200)
    plain = time_ms(torch, [lambda: ref.pack_ref(x16, 16)], 20)[0]
    out_words = SLOTS * n // 32 * 16
    b_ms, b_by = bound(x16.numel() * 4 + out_words * 4, 0.0)
    calls = 2 * cfg.n_layers
    rec = {"kernel": "pack", "shape": [SLOTS, n], "widths": "all 7",
           "calls_per_tick": calls, "max_err": 0.0, "tol": 0.0,
           "kernel_ms": ms, "host_issue_ms": issue,
           "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None}
    log(json.dumps(rec))
    return {"max_abs_err": 0.0, "ms": calls * ms, "plain_ms": calls * plain,
            "bound_ms": calls * b_ms, "bound_by": b_by, "library_ms": None,
            "calls_per_tick": calls}


def check_kv_decode(torch, F, ops, ref, gen, cfg):
    """q (slots, 32, 128) bf16 against an AF16 cache of max_seq_len rows,
    mixed lengths including 0 and one past S."""
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kv_len = torch.tensor([0, 1, 7, 64, 100, 200, MAX_SEQ, MAX_SEQ + 3],
                          dtype=torch.int32, device="cuda")
    q = torch.randn((SLOTS, h, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    kv_shape = (SLOTS, MAX_SEQ, hkv, d)
    kp = ops.pack(torch.randn(kv_shape, generator=gen, device="cuda"), 16)
    vp = ops.pack(torch.randn(kv_shape, generator=gen, device="cuda"), 16)
    got = ops.kv_decode(q, kp, vp, kv_len, 16, d)
    want = ref.kv_decode_ref(q, kp, vp, 16, d, kv_len)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL * want.float().abs().max().item() + 1e-3
    if err > tol or got[0].any().item():
        raise AssertionError(f"kv_decode: max err {err} > tol {tol}, or "
                             "kv_len == 0 not zero")
    cache_bytes = kp.numel() * 4 * 2
    reps = [(kp, vp)] + [(kp.clone(), vp.clone())
                         for _ in range(copies_for(cache_bytes) - 1)]
    calls_k = [lambda r=r: ops.kv_decode(q, r[0], r[1], kv_len, 16, d)
               for r in reps]
    ms, issue = time_ms(torch, calls_k, 100)
    plain = time_ms(torch, [lambda: ref.kv_decode_ref(q, kp, vp, 16, d,
                                                      kv_len)], 10)[0]
    group = h // hkv
    kd = (ref.unpack_ref(kp, 16, d, torch.bfloat16).transpose(1, 2)
          .repeat_interleave(group, dim=1).contiguous())
    vd = (ref.unpack_ref(vp, 16, d, torch.bfloat16).transpose(1, 2)
          .repeat_interleave(group, dim=1).contiguous())
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, None, None, :]
            < kv_len[:, None, None, None])
    q4 = q[:, :, None, :]
    lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask)], 100)[0]
    live = kv_len.clamp(max=MAX_SEQ).sum().item()
    row_bytes = hkv * kp.shape[-1] * 4
    b_ms, b_by = bound(2 * live * row_bytes + 2 * q.numel() * 2 + 4 * SLOTS,
                       4.0 * h * d * live)
    calls = cfg.n_layers
    rec = {"kernel": "kv_decode", "q": list(q.shape), "S": MAX_SEQ,
           "kv_len": kv_len.tolist(), "calls_per_tick": calls,
           "max_err": err, "tol": tol, "kernel_ms": ms,
           "host_issue_ms": issue, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    log(json.dumps(rec))
    return {"max_abs_err": err, "ms": calls * ms, "plain_ms": calls * plain,
            "bound_ms": calls * b_ms, "bound_by": b_by,
            "library_ms": calls * lib, "calls_per_tick": calls}


def check_take_rows(torch, F, ops, ref, gen, cfg):
    """Gather slots rows of the 151936 x 4096 AF16 embedding table
    (bit-exact), plus every AF8/AF12/AF16 code through the decoder."""
    from repro_torch.core import bitpack

    v, d = cfg.vocab_size, cfg.d_model
    table = ops.pack(torch.randn((v, d), generator=gen, device="cuda")
                     * 0.02, 16)
    idx = torch.tensor([5, 151935, 0, 77777, 5, 123, 9999, 5],
                       dtype=torch.int32, device="cuda")
    got = ops.take_rows(table, idx, 16, d, out_dtype=torch.bfloat16)
    want = ref.take_rows_ref(table, idx, 16, d, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("take_rows: rows differ")
    for bits in (8, 12, 16):
        codes = torch.arange(2**bits, device="cuda").to(torch.int32)
        tab = bitpack.pack_groups(codes.reshape(-1, 32), bits)
        ix = torch.arange(tab.shape[0], dtype=torch.int32, device="cuda")
        a = ops.take_rows(tab, ix, bits, 32).view(torch.int32)
        b = ref.take_rows_ref(tab, ix, bits, 32).view(torch.int32)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"AF{bits} decode differs on some code")
    calls_k = [lambda: ops.take_rows(table, idx, 16, d,
                                     out_dtype=torch.bfloat16)]
    ms, issue = time_ms(torch, calls_k, 200)
    plain = time_ms(torch, [lambda: ref.take_rows_ref(
        table, idx, 16, d, out_dtype=torch.bfloat16)], 20)[0]
    dec = ref.unpack_ref(table, 16, d, torch.bfloat16)
    lib = time_ms(torch, [lambda: F.embedding(idx, dec)], 200)[0]
    b_ms, b_by = bound(SLOTS * table.shape[1] * 4 + idx.numel() * 4
                       + got.numel() * 2, 0.0)
    rec = {"kernel": "take_rows", "table": [v, d], "rows": SLOTS,
           "calls_per_tick": 1, "max_err": 0.0, "tol": 0.0, "kernel_ms": ms,
           "host_issue_ms": issue, "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib}
    log(json.dumps(rec))
    del table, dec
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib, "calls_per_tick": 1}


# ---------------------------------------------------------------------------
# phase 3: serve full-width qwen3-8b
# ---------------------------------------------------------------------------

def serve(torch, np, cfg):
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine

    t0 = time.perf_counter()
    tracer = obs.Tracer()
    eng = ServeEngine(cfg, max_seq_len=MAX_SEQ, max_slots=SLOTS,
                      pack_weights=True, tracer=tracer)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"serve: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, weights "
        f"{eng.weight_read_bytes / 1e9:.3f} GB packed, engine init "
        f"{init_s:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in rng.integers(8, 65, SLOTS)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    outs = [eng.result(r) for r in rids]
    assert all(o is not None and len(o) == NEW_TOKENS for o in outs), outs
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    decode_ms = [r["dur_s"] * 1e3 for r in tracer.events("serve.decode")]
    prefill = tracer.events("serve.prefill")
    positions = sum(r["attrs"]["chunk"] for r in prefill)
    ticks = stats["decode_calls"]
    L = cfg.n_layers
    expect = {"packed_matmul": ticks * (7 * L + 1) + positions * 7 * L,
              "pack": (ticks + positions) * 2 * L,
              "kv_decode": (ticks + positions) * L,
              "take_rows": ticks + positions}
    res = {"requests": len(outs), "tokens": stats["tokens"],
           "decode_ticks": ticks, "prefill_calls": stats["prefill_calls"],
           "prefill_positions": positions, "wall_s": wall,
           "tokens_per_s": stats["tokens"] / wall,
           "ms_per_decode_tick_mean": sum(decode_ms) / len(decode_ms),
           "ms_per_decode_tick_min": min(decode_ms),
           "prefill_s": sum(r["dur_s"] for r in prefill),
           "launches": counts, "launches_expected": expect,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    # three more decode ticks by hand: the host's time to issue one tick
    # against the time until the card has finished it
    toks = torch.zeros((SLOTS, 1), dtype=torch.int64, device="cuda")
    issue, total = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, eng.state = eng.lm.decode_step(eng.params, eng.state, toks)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    res["decode_step_issue_ms"] = issue
    res["decode_step_total_ms"] = total
    log("serve: " + json.dumps(res))
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != path {expect}")
    del eng
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

def parity(torch, np, cfg):
    from repro_torch.core.compress import repack, uniform_plan
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.models.lm import LM

    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    lm_g, lm_c = LM(small, device="cuda"), LM(small, device="cpu")
    params = lm_g.init(torch.Generator(device="cuda").manual_seed(1))
    params = repack(params, uniform_plan(params, 16))
    params_c = tree_to(params, "cpu")
    st_g = lm_g.init_decode_state(SLOTS, 32)
    st_c = lm_c.init_decode_state(SLOTS, 32)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    worst = 0.0
    for step in range(2):
        toks = torch.from_numpy(rng.integers(0, small.vocab_size, (SLOTS, 1)))
        lg, st_g = lm_g.decode_step(params, st_g, toks.cuda())
        lc, st_c = lm_c.decode_step(params_c, st_c, toks)
        lg = lg.cpu()
        assert lg.shape == (SLOTS, 1, small.vocab_size)
        assert torch.isfinite(lg).all().item()
        err = (lg - lc).abs().max().item()
        worst = max(worst, err)
        if err > 1e-3:
            raise AssertionError(f"parity step {step}: max err {err} > 1e-3")
        if not torch.equal(lg.argmax(-1), lc.argmax(-1)):
            raise AssertionError(f"parity step {step}: argmax differs")
    log(f"parity: {small.name} 2 layers f32, 2 decode steps card vs CPU: "
        f"max abs logit err {worst:.3g} (tol 1e-3), argmax equal "
        f"({time.perf_counter() - t0:.1f} s)")


def build_summary(log_text: str) -> str:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log_text)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                            log_text))
    return (f"{len(regs)} kernels, max {max(regs) if regs else 0} registers,"
            f" {spills} bytes of spill stores")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
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

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({lib_path.parent.name}); "
        + build_summary((lib_path.parent / "build.log").read_text()))

    cfg = get_config("qwen3_8b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {
        "packed_matmul": check_packed_matmul(torch, ops, ref, gen, cfg),
        "pack": check_pack(torch, ops, ref, gen, cfg),
        "kv_decode": check_kv_decode(torch, F, ops, ref, gen, cfg),
        "take_rows": check_take_rows(torch, F, ops, ref, gen, cfg),
    }
    log(f"kernels checked ({time.perf_counter() - t_start:.0f} s so far)")
    counts = serve(torch, np, cfg)
    parity(torch, np, cfg)

    kernels = []
    for name, r in results.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "calls_per_tick": r["calls_per_tick"],
            "timing": "per decode tick at full width: calls_per_tick x "
                      "one call"})
    log(f"total {time.perf_counter() - t_start:.0f} s; card {smi.stdout.strip()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
