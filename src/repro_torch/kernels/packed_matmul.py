"""Wrapper of the CUDA ``packed_matmul`` kernel (csrc/packed_matmul.cu).

Replaces ``repro/kernels/packed_matmul.py:packed_matmul``: ``x @ W``
with W (K, N) packed along N, or ``x @ W^T`` with W (N, K) packed along
K when ``transpose``. x is f32 or bf16 with any leading dims; the output
is (..., N) in x's dtype, summed in f32 without TF32. The decoded W never
reaches device memory.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       sm_count, stream_ptr)

launches = LaunchCount()

BN, BM, BK = 256, 8, 32          # the kernel's tile sizes (csrc)
BLOCKS_PER_SM = 2                # split K until the grid has this many


def split_plan(m: int, n: int, k: int, sms: int, experts: int = 1):
    """(splits, k_chunk): how far K is cut so that the grid (``experts``
    products of (m, k) x (k, n)) covers the SMs. k_chunk is a multiple of
    BK; the last slice may be short."""
    tiles = experts * -(-n // BN) * -(-m // BM)
    k_tiles = max(-(-k // BK), 1)
    want = max(1, -(-(BLOCKS_PER_SM * sms) // tiles))
    chunk_tiles = -(-k_tiles // min(want, k_tiles))
    return -(-k_tiles // chunk_tiles), chunk_tiles * BK


def check_operands(op: str, x: torch.Tensor, w_packed: torch.Tensor,
                   bits: int, n: int, transpose: bool, w_ndim: int) -> None:
    """Refuse what the kernel does not take: W's last two axes must be
    (K, >= n) packed along n, or (n, >= K) packed along K when
    ``transpose``; the normal orientation also needs 16-byte alignment."""
    require(x, "x", (torch.float32, torch.bfloat16), op)
    require(w_packed, "w_packed", (torch.int32,), op)
    if bits not in FLOAT_FORMATS:
        raise ValueError(f"{op}: no float format with {bits} bits")
    if w_packed.ndim != w_ndim:
        raise ValueError(f"{op}: packed weights are {w_ndim}-D")
    kdim = x.shape[-1]
    rows, wwords = w_packed.shape[-2:]
    if transpose:
        if rows != n or kdim > wwords // bits * 32:
            raise ValueError(f"{op}: W {tuple(w_packed.shape)} at {bits} "
                             f"bits is not ({n}, >= {kdim}) packed")
    elif rows != kdim or n > wwords // bits * 32:
        raise ValueError(f"{op}: W {tuple(w_packed.shape)} at {bits} bits "
                         f"is not ({kdim}, >= {n}) packed")
    elif w_packed.data_ptr() % 16 or wwords % 4:
        # the normal orientation streams W with 16-byte loads
        raise ValueError(f"{op}: W rows must be 16-byte aligned")


def packed_matmul(x: torch.Tensor, w_packed: torch.Tensor, bits: int, n: int,
                  transpose: bool = False) -> torch.Tensor:
    check_operands("packed_matmul", x, w_packed, bits, n, transpose, 2)
    kdim = x.shape[-1]
    wwords = w_packed.shape[1]
    lead = x.shape[:-1]
    m = math.prod(lead)
    out = torch.empty(lead + (n,), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    splits, k_chunk = split_plan(m, n, kdim, sm_count(x))
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    rc = library().rt_packed_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w_packed.data_ptr(),
        out.data_ptr(), ws.data_ptr(), m, n, kdim, wwords, bits,
        int(transpose), splits, k_chunk, stream_ptr(x))
    check(rc, "packed_matmul")
    launches.n += 1
    return out
