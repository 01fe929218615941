#!/usr/bin/env python3
"""Time ``packed_matmul``'s transposed orientation (W (N, K) packed along
K) of several checkouts of the PyTorch + CUDA port on one card, in
turns: the trees in order, then in reverse (A, B, B, A for two).

    python3 scripts/ab_pmm_t.py TREE [TREE ...]

Each tree is a checkout holding ``src/repro_torch`` (for example the
parent commit unpacked with ``git archive`` into ``build/parent``). Each
turn is a fresh process that builds that tree's kernels into its own
``build/`` and imports its modules, so the trees never mix. Per turn,
bf16 x of 8 rows (the decode tick's slots) unless named, with the
stream held so that the events time the card's work and W rotated past
the L2 (``chip_smoke.time_ms``, ``copies_for``), each held to the plain
version within chip_smoke's bf16 tolerance:

- the tied heads, AF16: paligemma-3b (257216 x 2048) and
  recurrentgemma-9b (256000 x 4096); paligemma's also at AF12 (the AF12
  draft's head) and with 40 rows of x (the speculative verify's, k = 4);
- qwen3-8b's 4096 x 4096 check shape;
- deepseek-moe-16b's expert banks in the dx orientation, 64 experts of
  one row: (N 1408, K 2048) and (N 2048, K 1408), through
  ``packed_matmul_batched``;
- as a control, the normal orientation at qwen3-8b's ``lm_head``
  (4096 x 151936).

Each entry is [device ms, host issue ms] per call, beside cuBLAS (or
``torch.bmm``) on the decoded bf16 weights, timed the same way. One JSON
line per turn; the card's name and power limit first. Exits 2 without a
card.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (name, rows of x, K, N, experts, bits, transpose); experts 0: the 2-D entry
CASES = (("paligemma head", 8, 2048, 257216, 0, 16, True),
         ("paligemma head AF12", 8, 2048, 257216, 0, 12, True),
         ("paligemma verify 40 rows", 40, 2048, 257216, 0, 16, True),
         ("recurrentgemma head", 8, 4096, 256000, 0, 16, True),
         ("qwen3 4096 x 4096", 8, 4096, 4096, 0, 16, True),
         ("deepseek bank dx N 1408 K 2048", 1, 2048, 1408, 64, 16, True),
         ("deepseek bank dx N 2048 K 1408", 1, 1408, 2048, 64, 16, True),
         ("qwen3 lm_head, normal", 8, 4096, 151936, 0, 16, False))


def turn(tree: str) -> dict:
    """One tree's times (run in a process of its own)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                # puts this checkout's src first
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    from repro_torch.kernels import ops, ref

    assert Path(ops.__file__).is_relative_to(Path(tree).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree}
    for name, m, k, n, e, bits, transpose in CASES:
        lead = (e,) if e else ()
        wshape = lead + ((n, k) if transpose else (k, n))
        wp = ops.pack(torch.randn(wshape, generator=gen, device="cuda")
                      / math.sqrt(k), bits)
        x = torch.randn(lead + (m, k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        if e:
            def call(w):
                return ops.packed_matmul_batched(x, w, bits, n, transpose)
            want = ref.packed_matmul_batched_ref(x, wp, bits, n, transpose)
        else:
            def call(w):
                return ops.packed_matmul(x, w, bits, n, transpose)
            want = ref.packed_matmul_ref(x, wp, bits, n, transpose)
        err = (call(wp).float() - want).abs().max().item()
        tol = cs.BF16_TOL * want.abs().max().item() + 1e-4
        del want
        if not err <= tol:
            raise AssertionError(f"{name}: max err {err} > tol {tol}")
        reps = [wp] + [wp.clone() for _ in range(
            cs.copies_for(wp.numel() * 4) - 1)]
        kernel = cs.time_ms(torch, [lambda r=r: call(r) for r in reps], 30)
        del reps
        w_lib = ref.unpack_ref(wp, bits, k if transpose else n).to(
            torch.bfloat16)
        if transpose:
            w_lib = w_lib.transpose(-1, -2)
        libs = [w_lib] + [w_lib.clone() for _ in range(
            cs.copies_for(w_lib.numel() * 2) - 1)]
        mm = torch.bmm if e else torch.matmul
        lib = cs.time_ms(torch, [lambda r=r: mm(x, r) for r in libs], 30)
        out[name] = {"kernel": kernel, "library": lib, "max_err": err}
        del libs, w_lib, wp, x
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_pmm_t: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    trees = sys.argv[1:]
    for tree in trees + trees[::-1]:
        res = subprocess.run([sys.executable, __file__, "--turn", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
