"""The decode tick's KV append, ``kernels.ops.append_kv_rows``: one
layer's new K and V rows packed as the reference packs them (the flat
(B, Hkv * D) row through ``kops.pack``) and written at the rows the
reference's ``update_kv_cache`` / ``append_kv_pool_row`` write, dense or
paged.

On the CPU the plain version (``ref.append_kv_rows_ref``, which
``ops`` takes for CPU tensors) is held to the reference word for word;
on a card the CUDA kernel is held to the plain version on the same card
tensors, and ``ops.pack`` on bf16 input to its plain version. Every
comparison is of int32 words (tolerance 0). Several idle slots can
clamp onto one scrap-page row, where which write lands is not fixed
(in the reference's scatter as in the kernel), so such rows are left
out of every comparison; every other row is compared. The reference is
imported lazily, so the ``cuda`` tests also run on a machine without
JAX; they decide inside a fixture whether there is a card and skip
without one.
"""
from __future__ import annotations

import itertools
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core.bitpack import packed_group_words
from repro_torch.core.formats import FLOAT_LADDER
from repro_torch.kernels import ops, ref

WIDTHS = FLOAT_LADDER
PAGE = 4
# dense: lengths inside the cache, at its last row, at S and past it
DENSE_LENS = (0, 5, 6, 11, 2)                     # with S = 6
# paged, 3 table entries a sequence: a live slot, a slot mid-page, two
# idle slots (all entries the scrap page 0) and a length past the table
PAGED_TABLE = ((3, 1, 0), (2, 5, 6), (0, 0, 0), (0, 0, 0), (4, 0, 0))
PAGED_LENS = (5, 11, 0, 7, 40)
POOL_PAGES = 7                                    # P + 1, page 0 the scrap


@pytest.fixture(scope="module")
def jattn():
    """The reference's attention module and jnp."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import attention
    return attention, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card (python -m pytest "
                    "tests/test_torch_append.py -k cuda)")
    return torch.device("cuda")


def _awkward(rng, shape) -> np.ndarray:
    """Floats over many magnitudes with the codec's special values: NaN,
    infs, the AF16 overflow boundary (65520), f32 subnormals."""
    x = (rng.standard_normal(shape) * np.exp2(rng.integers(-20, 20, shape))
         ).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-45,
                         65504.0, 65520.0, -65520.0, 5.96e-8, 2.98e-8,
                         1.0 + 2.0**-11], np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, specials.size, replace=False)] = specials
    return x


def _rows(rng, b, hkv, d, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_awkward(rng, (b, hkv, d))).to(dtype)


def _case(rng, layout: str, b, hkv, d, bits):
    """Random int32 caches (K, V), kv_len and the table (None when
    dense)."""
    w = packed_group_words(d, bits)
    if layout == "dense":
        shape, lens, table = (b, 6, hkv, w), DENSE_LENS, None
    else:
        shape, lens = (POOL_PAGES, PAGE, hkv, w), PAGED_LENS
        table = torch.tensor(PAGED_TABLE, dtype=torch.int32)
    caches = [torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                            dtype=np.int64).astype(np.int32))
              for _ in range(2)]
    return caches, torch.tensor(lens[:b], dtype=torch.int32), table


def _shared_rows(cache_shape, kv_len, table) -> list:
    """Flat cache rows that two or more sequences write (scrap rows)."""
    if table is None:
        return []
    rows = ref.pool_row_index(cache_shape[1], table.cpu(), kv_len.cpu())
    return [r for r, n in Counter(rows.tolist()).items() if n > 1]


def _live(cache: torch.Tensor, shared) -> torch.Tensor:
    flat = cache.detach().cpu().reshape((-1,) + tuple(cache.shape[2:])).clone()
    flat[list(shared)] = 0
    return flat


# ---------------------------------------------------------------------------
# the plain version against the reference (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", (8, 12, 16))
def test_append_matches_reference(jattn, bits, dtype, layout):
    """Word for word the reference's update_kv_cache (dense: kv_len >= S
    clamps to S - 1) or append_kv_pool_row (paged: idle slots on the
    scrap page, a length past the table)."""
    attention, jnp = jattn
    rng = np.random.default_rng(bits)
    b, hkv, d = 5, 2, 64
    k, v = _rows(rng, b, hkv, d, dtype), _rows(rng, b, hkv, d, dtype)
    (kc, vc), kv_len, table = _case(rng, layout, b, hkv, d, bits)

    def jx(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if dtype == torch.bfloat16 else a

    kw, vw = (jnp.asarray(c.numpy().view(np.uint32)) for c in (kc, vc))
    if table is None:
        want = attention.update_kv_cache(kw, vw, jx(k), jx(v),
                                         jnp.asarray(kv_len.numpy()), bits)
    else:
        want = attention.append_kv_pool_row(kw, vw, jx(k), jx(v),
                                            jnp.asarray(table.numpy()),
                                            jnp.asarray(kv_len.numpy()), bits)
    before = ops.launch_counts()
    ops.DISPATCH_RECORDS.clear()
    ops.append_kv_rows(kc, vc, k, v, kv_len, bits, table)
    assert ops.launch_counts() == before          # the plain route
    assert [(r.op, r.path) for r in ops.DISPATCH_RECORDS] == [
        ("pack", "encode")]
    shared = _shared_rows(kc.shape, kv_len, table)
    assert bool(shared) == (layout == "paged")    # the race is exercised
    for got, w in zip((kc, vc), want):
        w = torch.from_numpy(np.array(w).view(np.int32))
        assert torch.equal(_live(got, shared), _live(w, shared))


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (card only)
# ---------------------------------------------------------------------------

def _views(rng, b, hkv, d, dtype, device):
    """K as a strided slice (value stride 2) and V as a transposed view
    (not contiguous when hkv > 1), as projections may hand them over."""
    k = _rows(rng, b, hkv, 2 * d, dtype).to(device)[:, :, ::2]
    v = _rows(rng, hkv, b, d, dtype).to(device).transpose(0, 1)
    assert not k.is_contiguous() and v.is_contiguous() == (hkv == 1)
    return k, v


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_append_kv_rows(cuda, bits, dtype, layout):
    """One launch writes exactly the plain version's words, at every
    width, through non-contiguous K/V views and contiguous rows, clamped
    and scrap rows included; a second shape has one kv head of 100
    values (a ragged last group)."""
    rng = np.random.default_rng(100 + bits)
    for (b, hkv, d), dense_rows in itertools.product(
            ((5, 4, 128), (5, 1, 100)), (False, True)):
        k, v = _views(rng, b, hkv, d, dtype, cuda)
        if dense_rows:            # as the model hands them over: the
            k, v = k.contiguous(), v.contiguous()   # 4-value path
        caches, kv_len, table = _case(rng, layout, b, hkv, d, bits)
        kv_len = kv_len.to(cuda)
        table = None if table is None else table.to(cuda)
        got = [c.to(cuda) for c in caches]
        want = [c.to(cuda) for c in caches]
        before = ops.launch_counts()["pack"]
        ops.append_kv_rows(*got, k, v, kv_len, bits, table)
        assert ops.launch_counts()["pack"] == before + 1
        ref.append_kv_rows_ref(*want, k, v, kv_len, bits, table)
        torch.cuda.synchronize()
        shared = _shared_rows(got[0].shape, kv_len, table)
        for g, w in zip(got, want):
            assert torch.equal(_live(g, shared), _live(w, shared))


@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_pack_bf16_and_f32_bit_exact(cuda, bits):
    """ops.pack reads bf16 directly, bit for bit the plain version of
    the widened values; f32 NaN, overflow and subnormal rows too; rows
    of a multiple of 4 values (the 4-value path at AF8, AF16 and AF32),
    with a ragged last group, and rows that are not."""
    rng = np.random.default_rng(200 + bits)
    for shape in ((8, 1024), (3, 70), (4, 100), (2, 3, 64)):
        x = torch.from_numpy(_awkward(rng, shape)).to(cuda)
        for src in (x, x.bfloat16()):
            before = ops.launch_counts()["pack"]
            got = ops.pack(src, bits)
            assert ops.launch_counts()["pack"] == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, ref.pack_ref(src, bits))
            assert torch.equal(got.cpu(), ref.pack_ref(src.cpu(), bits))
