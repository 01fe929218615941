"""Wrapper of the CUDA ``packed_matmul_batched`` kernel
(csrc/packed_matmul.cu, entry ``rt_packed_matmul_batched``).

Replaces ``repro/kernels/packed_matmul.py:packed_matmul_batched``: per
expert ``x[e] @ W[e]`` with the bank W (E, K, N) packed along N, or
``x[e] @ W[e]^T`` with W (E, N, K) packed along K when ``transpose``.
x is (E, C, K) f32 or bf16; the output is (E, C, N) in x's dtype, summed
in f32 without TF32. One launch covers every expert (the expert index
shares the grid's z axis with the K split), and no expert's decoded
weights reach device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCount, check, library, sm_count, stream_ptr
from repro_torch.kernels.packed_matmul import check_operands, split_plan

launches = LaunchCount()


def packed_matmul_batched(x: torch.Tensor, w_packed: torch.Tensor, bits: int,
                          n: int, transpose: bool = False) -> torch.Tensor:
    check_operands("packed_matmul_batched", x, w_packed, bits, n, transpose, 3)
    if x.ndim != 3 or x.shape[0] != w_packed.shape[0]:
        raise ValueError(f"packed_matmul_batched: x {tuple(x.shape)} is not "
                         f"(E, C, K) for a bank of {w_packed.shape[0]} experts")
    e, c, kdim = x.shape
    wwords = w_packed.shape[2]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    splits, k_chunk = split_plan(c, n, kdim, sm_count(x), experts=e)
    ws = (torch.empty((e, splits, c, n), dtype=torch.float32,
                      device=x.device) if splits > 1 else out)
    rc = library().rt_packed_matmul_batched(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w_packed.data_ptr(),
        out.data_ptr(), ws.data_ptr(), e, c, n, kdim, wwords, bits,
        int(transpose), splits, k_chunk, stream_ptr(x))
    check(rc, "packed_matmul_batched")
    launches.n += 1
    return out
