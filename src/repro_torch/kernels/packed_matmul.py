"""Wrapper of the CUDA ``packed_matmul`` kernel (csrc/packed_matmul.cu).

Replaces ``repro/kernels/packed_matmul.py:packed_matmul``: ``x @ W``
with W (K, N) packed along N, or ``x @ W^T`` with W (N, K) packed along
K when ``transpose``. x is f32 or bf16 with any leading dims; the output
is (..., N) in x's dtype, summed in f32. In either orientation bf16 x
against AF8, AF12 or AF16 weights multiplies on the tensor cores in TF32,
which holds both operands exactly; every other case multiplies in f32.
The decoded W never reaches device memory, and a call is one launch
per MAX_ROWS rows of x: the grid puts x's 8-row tiles on its y axis,
which holds at most 65,535 blocks, so a longer x is walked in slices
(``row_slices``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       sm_count, stream_ptr)

launches = LaunchCount()
# the launches of ``launches`` that ran the transposed orientation
transposed_launches = LaunchCount()

BN, BM, BK = 64, 8, 32           # the normal orientation's tiles (csrc)
BN_T = 128                       # the transposed one's columns per block
X_SLICE_BYTES = 32 * 1024        # and its budget for a block's x slice
MAX_SPLITS = 8                   # a thread-block cluster's portable size
MAX_ROWS = 65535 * BM            # rows of x one launch's grid covers


def row_slices(m: int):
    """[lo, hi) bounds of the launches over m rows of x, each at most
    MAX_ROWS rows."""
    return [(lo, min(lo + MAX_ROWS, m)) for lo in range(0, m, MAX_ROWS)]


def split_plan(m: int, n: int, k: int, sms: int, experts: int = 1):
    """(splits, k_chunk): how far K is cut so that the normal
    orientation's grid (``experts`` products of (m, k) x (k, n), in BN x
    BM tiles) has a block for every SM. A tile's K slices are one
    thread-block cluster, so splits is at most MAX_SPLITS. k_chunk is a
    multiple of BK; the last slice may be short."""
    return grid_plan(m, n, k, sms, experts)


def grid_plan(m: int, n: int, k: int, sms: int, experts: int = 1,
              transpose: bool = False, x_bytes: int = 2):
    """``split_plan`` for either orientation. The transposed one's tiles
    are BN_T columns wide, and a block holds its BM rows of x's K slice
    (``x_bytes`` an element) in X_SLICE_BYTES of shared memory, so K is
    cut until a slice fits, up to MAX_SPLITS; the kernel walks a longer
    slice in passes."""
    tiles = experts * -(-n // (BN_T if transpose else BN)) * -(-m // BM)
    k_tiles = max(-(-k // BK), 1)
    want = min(max(1, -(-sms // tiles)), MAX_SPLITS, k_tiles)
    if transpose:
        fit = X_SLICE_BYTES // (BM * x_bytes * BK)     # k tiles a slice holds
        want = max(want, min(-(-k_tiles // fit), MAX_SPLITS))
    chunk_tiles = -(-k_tiles // want)
    return -(-k_tiles // chunk_tiles), chunk_tiles * BK


def check_operands(op: str, x: torch.Tensor, w_packed: torch.Tensor,
                   bits: int, n: int, transpose: bool, w_ndim: int) -> None:
    """Refuse what the kernel does not take: W's last two axes must be
    (K, >= n) packed along n, or (n, >= K) packed along K when
    ``transpose``, and its rows 16-byte aligned (both orientations stream
    W with 16-byte copies)."""
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
    if w_packed.data_ptr() % 16 or wwords % 4:
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
    for lo, hi in row_slices(m):
        splits, k_chunk = grid_plan(hi - lo, n, kdim, sm_count(x),
                                    transpose=transpose,
                                    x_bytes=x.element_size())
        rc = library().rt_packed_matmul(
            x.data_ptr() + lo * kdim * x.element_size(),
            int(x.dtype == torch.bfloat16), w_packed.data_ptr(),
            out.data_ptr() + lo * n * out.element_size(), hi - lo, n, kdim,
            wwords, bits, int(transpose), splits, k_chunk, stream_ptr(x))
        check(rc, "packed_matmul")
        launches.n += 1
        transposed_launches.n += int(transpose)
    return out
