#!/usr/bin/env python3
"""Time the KV append, ``ops.pack``, ``ops.unpack`` and ``ops.take_rows``
of two checkouts of the PyTorch + CUDA port on one card, in turns: A, B,
B, A.

    python3 scripts/ab_pack_unpack.py OLD_TREE NEW_TREE

Each tree is a checkout holding ``src/repro_torch`` (for example the
parent commit unpacked with ``git archive`` into ``build/parent``). Each
turn is a fresh process that builds that tree's kernels into its own
``build/`` and imports its modules, so the two never mix. Per turn, on
the card, with the stream held so that the events time the card's work
(``chip_smoke.time_ms``):

- the KV append a decode layer runs, through the model's own entry
  points (``models.attention.update_kv_cache`` and
  ``append_kv_pool_row``; bf16 rows, AF16 caches, 8 slots) at
  qwen3-8b's and deepseek-moe-16b's widths: device ms and host issue
  ms per layer;
- ``ops.pack`` on the tick's KV row operand (8, Hkv * head_dim), f32,
  AF16;
- ``ops.unpack`` of qwen3-8b's ``w_up`` leaf (4096, 12288) at AF8,
  AF12 and AF16 to f32 and at AF16 to bf16, operands rotated past the
  L2;
- ``ops.take_rows`` of the AF16 embedding table to bf16: the decode
  tick's 8 rows at both models' widths, the same rows every call (warm)
  and fresh rows every call (cold), and for qwen3-8b the (B, T) embed
  shape, 8 x 256 = 2,048 rows, to bf16 and f32, index sets rotated past
  the L2.

One JSON line per turn; the card's name and power limit first. Exits 2
without a card.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def turn(tree: str) -> dict:
    """One tree's times (run in a process of its own)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                # puts this checkout's src first
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    assert Path(attention.__file__).is_relative_to(Path(tree).resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree}
    for name in ("qwen3_8b", "deepseek_moe_16b"):
        cfg = get_config(name)
        hkv, d = cfg.n_kv_heads, cfg.resolved_head_dim
        w = -(-d // 32) * 16
        seq = cs.MOE_MAX_SEQ if cfg.family == "moe" else cs.MAX_SEQ
        mp = seq // cs.PAGE
        kv_len = torch.tensor([72, 80, 88, 96, 104, 112, 76, 92],
                              dtype=torch.int32, device="cuda")
        table = torch.arange(1, 1 + cs.SLOTS * mp, dtype=torch.int32,
                             device="cuda").reshape(cs.SLOTS, mp)
        dense = [torch.zeros((cs.SLOTS, seq, hkv, w), dtype=torch.int32,
                             device="cuda") for _ in range(2)]
        pool = [torch.zeros((cs.SLOTS * mp + 1, cs.PAGE, hkv, w),
                            dtype=torch.int32, device="cuda")
                for _ in range(2)]
        k, v = (torch.randn((cs.SLOTS, 1, hkv, d), generator=gen,
                            device="cuda").to(torch.bfloat16)[:, 0]
                for _ in range(2))
        out[f"{cfg.name} append dense"] = cs.time_ms(torch, [
            lambda: attention.update_kv_cache(*dense, k, v, kv_len, 16)], 200)
        out[f"{cfg.name} append paged"] = cs.time_ms(torch, [
            lambda: attention.append_kv_pool_row(*pool, k, v, table, kv_len,
                                                 16)], 200)
        x = torch.randn((cs.SLOTS, hkv * d), generator=gen, device="cuda")
        out[f"{cfg.name} ops.pack"] = cs.time_ms(torch, [
            lambda: ops.pack(x, 16)], 200)
        v, dm = cfg.vocab_size, cfg.d_model
        table = ops.pack(torch.randn((v, dm), generator=gen, device="cuda")
                         * 0.02, 16)
        tick = torch.tensor([5, v - 1, 0, 77777, 5, 123, 9999, 5],
                            dtype=torch.int32, device="cuda")
        out[f"{cfg.name} take_rows tick"] = cs.time_ms(torch, [
            lambda: ops.take_rows(table, tick, 16, dm,
                                  out_dtype=torch.bfloat16)], 200)
        cold = itertools.cycle(torch.randint(
            0, v, (cs.copies_for(table[:cs.SLOTS].numel() * 4), cs.SLOTS),
            generator=gen, device="cuda", dtype=torch.int32))
        out[f"{cfg.name} take_rows tick cold"] = cs.time_ms(torch, [
            lambda: ops.take_rows(table, next(cold), 16, dm,
                                  out_dtype=torch.bfloat16)], 200)
        if cfg.family != "moe":
            rows = cs.SLOTS * cs.MAX_SEQ
            sets = torch.randint(0, v, (cs.copies_for(rows * dm * 4), rows),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
            for dt in (torch.bfloat16, torch.float32):
                out[f"{cfg.name} take_rows {rows} rows "
                    f"{str(dt).split('.')[-1]}"] = cs.time_ms(torch, [
                        lambda ix=ix: ops.take_rows(table, ix, 16, dm,
                                                    out_dtype=dt)
                        for ix in sets], 100)
        del table
    rows, n = 4096, 12288
    x = torch.randn((rows, n), generator=gen, device="cuda")
    for bits, dt in ((8, torch.float32), (12, torch.float32),
                     (16, torch.float32), (16, torch.bfloat16)):
        p = ops.pack(x, bits)
        reps = [p] + [p.clone() for _ in range(
            cs.copies_for(p.numel() * 4) - 1)]
        out[f"unpack AF{bits} {str(dt).split('.')[-1]}"] = cs.time_ms(
            torch, [lambda r=r: ops.unpack(r, bits, n, dt) for r in reps], 20)
        del reps, p
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])))
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_pack_unpack: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    old, new = sys.argv[1], sys.argv[2]
    for tree in (old, new, new, old):
        res = subprocess.run([sys.executable, __file__, "--turn", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
