"""The port's kernels: plain versions against the JAX oracles, and (on a
card) the CUDA kernels against the plain versions.

The ``ref_*`` tests import the reference lazily, so the ``cuda`` tests of
this file also run on a machine without JAX. The ``cuda`` tests decide
inside a fixture whether there is a card and skip without one.
Tolerances: ``pack`` and ``take_rows`` are bit-exact; ``packed_matmul``,
``kv_decode`` and ``paged_attention`` differ from their oracles only in
summation order
(rtol = atol = 1e-5 in f32 on the CPU); on the card, bf16 outputs may
round one bf16 ulp apart from the f32 result.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import bitpack
from repro_torch.core.formats import FLOAT_FORMATS, FLOAT_LADDER
from repro_torch.kernels import ops, ref

WIDTHS = FLOAT_LADDER
INT_WIDTHS = (4, 8, 12, 16, 20, 24, 28, 32)


@pytest.fixture(scope="module")
def jref():
    """The reference's oracles (``repro.kernels.ref``) and jnp."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jax_ref
    return jax_ref, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card "
                    "(python -m pytest tests/test_torch_kernels_ref.py -k cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _awkward_floats(rng, shape) -> np.ndarray:
    """Random floats over many magnitudes, with specials mixed in."""
    x = (rng.standard_normal(shape) * np.exp2(rng.integers(-30, 30, shape))
         ).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-45,
                         65504.0, 65520.0, 6.1e-5, 5.96e-8, 2.98e-8,
                         1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 3.4e38],
                        np.float32)
    flat = x.reshape(-1)
    k = min(flat.size, specials.size)
    flat[rng.choice(flat.size, k, replace=False)] = specials[:k]
    return x


def _packed(rng, rows, n, bits) -> np.ndarray:
    """Random words holding codes of ``bits`` (pad codes zero)."""
    codes = rng.integers(0, 2**bits, (rows, n), dtype=np.uint64)
    return bitpack.pack_groups(
        torch.from_numpy(codes.astype(np.uint32).view(np.int32)), bits
    ).numpy()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().contiguous().view(torch.int32).cpu().numpy()


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal bit for bit: -0.0 and NaN payloads count."""
    assert got.dtype == want.dtype and got.shape == want.shape
    view = torch.int16 if got.element_size() == 2 else torch.int32
    assert torch.equal(got.cpu().view(view), want.cpu().view(view))


# ---------------------------------------------------------------------------
# plain versions against the JAX oracles (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", WIDTHS)
def test_ref_pack_bit_exact(jref, bits):
    jax_ref, jnp = jref
    rng = np.random.default_rng(bits)
    x = _awkward_floats(rng, (5, 70))              # a ragged last group
    want = np.asarray(jax_ref.pack_ref(jnp.asarray(x), bits)).view(np.int32)
    got = ref.pack_ref(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", WIDTHS)
def test_ref_take_rows_float_bit_exact(jref, bits):
    jax_ref, jnp = jref
    rng = np.random.default_rng(100 + bits)
    n = 45
    table = _packed(rng, 9, n, bits)
    idx = np.array([3, 0, 8, 3, 3, 7, 1], np.int32)      # repeats, any order
    want = np.asarray(jax_ref.take_rows_ref(
        jnp.asarray(table.view(np.uint32)), jnp.asarray(idx), bits, n))
    got = ref.take_rows_ref(torch.from_numpy(table), torch.from_numpy(idx),
                            bits, n)
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))


def _special_codes(rng, rows, n, bits) -> torch.Tensor:
    """Random codes of a Table 3 width with NaNs (several payloads), ±inf,
    subnormals and zeros of both signs mixed in, as a packed table."""
    fmt = FLOAT_FORMATS[bits]
    m, top = fmt.mantissa_bits, fmt.max_biased_exp << fmt.mantissa_bits
    mags = [top | 1, top | (1 << (m - 1)), top | ((1 << m) - 1),    # NaNs
            top, 1, (1 << m) - 1, 0, 1 << m]          # inf, subnormals, 0
    special = [s | v for s in (0, 1 << (bits - 1)) for v in mags]
    codes = rng.integers(0, 2**bits, (rows, n), dtype=np.uint64)
    flat = codes.reshape(-1)
    flat[rng.choice(flat.size, len(special), replace=False)] = special
    return bitpack.pack_groups(
        torch.from_numpy(codes.astype(np.uint32).view(np.int32)), bits)


@pytest.mark.parametrize("bits", WIDTHS)
def test_ref_take_rows_bf16_bit_exact(jref, bits):
    """bf16 output bit for bit, NaN signs and payloads included (the
    reference writes a NaN as its sign | 0x7FC0)."""
    jax_ref, jnp = jref
    rng = np.random.default_rng(150 + bits)
    n = 45
    table = _special_codes(rng, 4, n, bits)
    idx = np.array([2, 0, 3, 2, 1, 2], np.int32)         # repeats, any order
    want = np.asarray(jax_ref.take_rows_ref(
        jnp.asarray(table.numpy().view(np.uint32)), jnp.asarray(idx), bits,
        n, out_dtype=jnp.bfloat16))
    got = ref.take_rows_ref(table, torch.from_numpy(idx), bits, n,
                            out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("bits", INT_WIDTHS)
@pytest.mark.parametrize("signed", [True, False])
def test_ref_take_rows_int_bit_exact(jref, bits, signed):
    jax_ref, jnp = jref
    rng = np.random.default_rng(200 + bits)
    n = 40
    table = _packed(rng, 6, n, bits)
    idx = np.array([5, 5, 0, 2], np.int32)
    want = np.asarray(jax_ref.take_rows_ref(
        jnp.asarray(table.view(np.uint32)), jnp.asarray(idx), bits, n,
        kind="int", signed=signed, out_dtype=jnp.int32))
    got = ref.take_rows_ref(torch.from_numpy(table), torch.from_numpy(idx),
                            bits, n, kind="int", signed=signed,
                            out_dtype=torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bits", (8, 16, 20))
def test_ref_packed_matmul(jref, transpose, bits):
    jax_ref, jnp = jref
    rng = np.random.default_rng(300 + bits)
    m, k, n = 5, 70, 37
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    wp = (_packed_w(rng, n, k, bits) if transpose
          else _packed_w(rng, k, n, bits))
    want = np.asarray(jax_ref.packed_matmul_ref(
        jnp.asarray(x), jnp.asarray(wp.view(np.uint32)), bits, n, transpose))
    got = ref.packed_matmul_ref(torch.from_numpy(x), torch.from_numpy(wp),
                                bits, n, transpose)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # bf16 activations: the same f32 product of the bf16-rounded x
    xb = torch.from_numpy(x).bfloat16()
    want_b = np.asarray(jax_ref.packed_matmul_ref(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(wp.view(np.uint32)), bits, n, transpose))
    got_b = ref.packed_matmul_ref(xb, torch.from_numpy(wp), bits, n,
                                  transpose)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-5, atol=1e-5)


def _packed_w(rng, rows, cols, bits) -> np.ndarray:
    """A (rows, cols) weight of moderate values packed along cols."""
    w = (rng.standard_normal((rows, cols)) / np.sqrt(rows)).astype(np.float32)
    return ref.pack_ref(torch.from_numpy(w), bits).numpy()


@pytest.mark.parametrize("bits", (8, 16, 32))
def test_ref_kv_decode(jref, bits):
    jax_ref, jnp = jref
    rng = np.random.default_rng(400 + bits)
    b, h, hkv, d, s = 4, 8, 2, 32, 13
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = _packed_w(rng, b * s * hkv, d, bits).reshape(b, s, hkv, -1)
    vp = _packed_w(rng, b * s * hkv, d, bits).reshape(b, s, hkv, -1)
    kv_len = np.array([0, 1, s, s + 3], np.int32)
    want = np.asarray(jax_ref.kv_decode_ref(
        jnp.asarray(q), jnp.asarray(kp.view(np.uint32)),
        jnp.asarray(vp.view(np.uint32)), bits, d, jnp.asarray(kv_len)))
    got = ref.kv_decode_ref(torch.from_numpy(q), torch.from_numpy(kp),
                            torch.from_numpy(vp), bits, d,
                            torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not got[0].any()                       # kv_len == 0 gives zeros


def test_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version: a CPU tensor is an
    error there (``ops`` sends CPU tensors to ``ref`` itself)."""
    from repro_torch.kernels import (convert, kv_decode, pack, packed_matmul,
                                     paged_attention, take, unpack)
    x = torch.zeros(2, 32)
    w = torch.zeros(32, 16, dtype=torch.int32)
    cache = torch.zeros(1, 4, 1, 16, dtype=torch.int32)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        pack.pack(x, 16)
    with pytest.raises(ValueError, match="CUDA"):
        take.take_rows(w, torch.zeros(1, dtype=torch.int32), 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        packed_matmul.packed_matmul(x, w, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kv_decode.kv_decode(torch.zeros(1, 2, 32), cache, cache,
                            torch.ones(1, dtype=torch.int32), 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention(
            torch.zeros(1, 2, 32), cache, cache,
            torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        unpack.unpack(w, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        convert.convert(w, 16)
    with pytest.raises(ValueError, match="CUDA"):
        convert.truncate(x, 16)
    with pytest.raises(ValueError, match="CUDA"):
        pack.append_kv_rows(cache, cache, torch.zeros(1, 1, 32),
                            torch.zeros(1, 1, 32),
                            torch.ones(1, dtype=torch.int32), 16)
    assert ops.launch_counts() == before


def _unfused_case(case: str, device):
    """A packed weight that no kernel takes, and the layer call on it:
    an odd einsum spec, an int-kind head, a 3-D embedding table."""
    from repro_torch.core.tensor_store import pack_tensor
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 32, generator=gen)
    if case == "linear_spec":
        w = pack_tensor(torch.randn(16, 32, generator=gen), 16)
        want = torch.einsum("...d,fd->...f", x, w.unpack())
        return (lambda: layers.linear(x.to(device), w.to(device),
                                      "...d,fd->...f")), want
    if case == "unembed_int":
        w = pack_tensor(torch.randint(-8, 8, (32, 16), generator=gen,
                                      dtype=torch.int32), 8)
        want = x @ w.unpack().float()
        return (lambda: layers.unembed(x.to(device), w.to(device),
                                       tied=False)), want
    table = pack_tensor(torch.randn(3, 5, 32, generator=gen), 16)
    tok = torch.tensor([2, 0, 2])
    return (lambda: layers.embed(tok.to(device), table.to(device))), \
        table.unpack()[tok]


UNFUSED = ("linear_spec", "unembed_int", "embed_3d")


@pytest.mark.parametrize("case", UNFUSED)
def test_unfused_packed_weight_materializes_on_cpu(case):
    """On the CPU a packed weight that no kernel takes decodes in full
    (the plain version) and leaves a fallback record."""
    call, want = _unfused_case(case, "cpu")
    ops.FALLBACK_RECORDS.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # the odd-spec warning
        got = call()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert [r.op for r in ops.FALLBACK_RECORDS] == [case.split("_")[0]]


def test_split_plans_cover_the_work():
    """The grid plans of the CUDA wrappers: every K row and every cache
    row falls in exactly one slice, slices are 32-aligned."""
    from repro_torch.kernels.kv_decode import chunk_plan
    from repro_torch.kernels.packed_matmul import split_plan
    for m, n, k in ((8, 1024, 4096), (8, 151936, 4096), (1, 7, 5),
                    (8, 4096, 12288), (300, 96, 33)):
        splits, chunk = split_plan(m, n, k, 132)
        assert chunk % 32 == 0 and splits >= 1
        assert (splits - 1) * chunk < k <= splits * chunk or k <= chunk
    for pairs, s in ((64, 256), (1, 32768), (8, 1), (512, 4096)):
        chunk, n_chunks = chunk_plan(pairs, s, 132)
        assert chunk % 32 == 0 and chunk <= 512
        assert (n_chunks - 1) * chunk < s <= n_chunks * chunk


def test_row_slices_stay_within_the_grid():
    """x's rows are walked in launches of at most MAX_ROWS (65,535 row
    tiles of BM = 8 on the grid's y axis): contiguous, covering every row
    once; one launch up to MAX_ROWS, two just past it."""
    from repro_torch.kernels.packed_matmul import BM, MAX_ROWS, row_slices
    assert MAX_ROWS == 65535 * BM == 524280
    for m in (1, 8, 1024, MAX_ROWS - 1, MAX_ROWS, MAX_ROWS + 1,
              524288 + 8, 3 * MAX_ROWS + 5):
        plan = row_slices(m)
        assert plan[0][0] == 0 and plan[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
        assert all(0 < hi - lo <= MAX_ROWS for lo, hi in plan)
        assert len(plan) == -(-m // MAX_ROWS)
    assert row_slices(0) == []


def test_split_plan_fits_a_cluster():
    """A tile's K slices are one thread-block cluster: at most MAX_SPLITS
    (8) of them, in either orientation; the transposed one's x slice fits
    its shared-memory budget wherever 8 slices can hold K. At every
    normal-orientation shape of a full-width decode tick (8 slots,
    chip_smoke.py phase 2) of qwen3-8b and deepseek-moe-16b the grid has a
    block for each of the H100's 132 SMs, except where that cap binds:
    qwen3's wk/wv (16 column tiles x 8 slices, 128 blocks) and deepseek's
    router (one tile, 8 blocks)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_matmul import (BM, BN, BN_T, MAX_SPLITS,
                                                   X_SLICE_BYTES, grid_plan,
                                                   split_plan)
    from repro_torch.models import blocks as B
    rng = np.random.default_rng(7)
    for _ in range(300):
        m, n, k, e = (int(v) for v in
                      rng.integers(1, (400, 200000, 40000, 80)))
        for transpose in (False, True):
            splits, chunk = grid_plan(m, n, k, 132, e, transpose)
            assert 1 <= splits <= MAX_SPLITS and chunk % 32 == 0
            assert (splits - 1) * chunk < k <= splits * chunk or k <= chunk
    capped = []
    for name in ("qwen3_8b", "deepseek_moe_16b"):
        cfg = get_config(name)
        d, hq = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim
        hkv = cfg.n_kv_heads * cfg.resolved_head_dim
        # (what, rows of x, K, N, experts)
        shapes = [("wq", 8, d, hq, 1), ("wo", 8, hq, d, 1),
                  ("wk", 8, d, hkv, 1), ("lm_head", 8, d, cfg.vocab_size, 1)]
        if cfg.family == "moe":
            fs = cfg.moe_d_ff * cfg.n_shared_experts
            cap = B.capacity(cfg, 8)
            shapes += [("router", 8, d, cfg.n_experts, 1),
                       ("w_in", 8, d, fs, 1), ("w_out", 8, fs, d, 1),
                       ("bank_in", cap, d, cfg.moe_d_ff, cfg.n_experts),
                       ("bank_out", cap, cfg.moe_d_ff, d, cfg.n_experts)]
        else:
            shapes += [("w_in", 8, d, cfg.d_ff, 1),
                       ("w_out", 8, cfg.d_ff, d, 1)]
        for what, m, k, n, e in shapes:
            splits, _ = split_plan(m, n, k, 132, e)
            blocks = e * -(-n // BN) * -(-m // BM) * splits
            assert splits <= MAX_SPLITS
            if blocks < 132:
                assert splits == MAX_SPLITS, (name, what, blocks)
                capped.append((name, what, blocks))
    assert capped == [("qwen3_8b", "wk", 128),
                      ("deepseek_moe_16b", "router", 8)]
    # a full cluster at w_out's depth, as the card test runs it
    assert split_plan(8, 1024, 12288, 132) == (8, 1536)
    # the transposed orientation: a block holds its BM rows of x's K slice
    # in X_SLICE_BYTES, so K splits until the slice fits (a longer K walks
    # its slices in passes); at the tied heads, qwen3's 4096 x 4096 check
    # shape, deepseek's banks and the speculative verify's 40 rows, every
    # SM of the H100 gets a block
    for _ in range(300):
        m, n, k, e = (int(v) for v in
                      rng.integers(1, (400, 200000, 40000, 80)))
        for x_bytes in (2, 4):
            splits, chunk = grid_plan(m, n, k, 132, e, True, x_bytes)
            fits = BM * chunk * x_bytes <= X_SLICE_BYTES
            assert fits or splits == MAX_SPLITS
            assert fits or k > MAX_SPLITS * X_SLICE_BYTES // (BM * x_bytes)
    pali, rgemma = get_config("paligemma_3b"), get_config("recurrentgemma_9b")
    moe = get_config("deepseek_moe_16b")
    cap = B.capacity(moe, 8)
    # (what, rows of x, K, N, experts, K splits)
    for what, m, k, n, e, want in (
            ("paligemma head", 8, pali.d_model, pali.vocab_size, 1, 1),
            ("paligemma verify", 40, pali.d_model, pali.vocab_size, 1, 1),
            ("recurrentgemma head", 8, rgemma.d_model, rgemma.vocab_size, 1,
             2),
            ("qwen3 check", 8, 4096, 4096, 1, 5),
            ("bank dx in", cap, moe.d_model, moe.moe_d_ff, moe.n_experts, 1),
            ("bank dx out", cap, moe.moe_d_ff, moe.d_model, moe.n_experts,
             1)):
        splits, chunk = grid_plan(m, n, k, 132, e, True)
        blocks = e * -(-n // BN_T) * -(-m // BM) * splits
        assert splits == want, (what, splits)
        assert (splits - 1) * chunk < k <= splits * chunk, what
        assert BM * chunk * 2 <= X_SLICE_BYTES, what
        assert blocks >= 132, (what, blocks)


# Card shapes (b, h, hkv, d, s) on which the attention body stages a
# chunk over several shared-memory tiles, so its ring of two tiles turns
# over: a long cache, the largest row (head_dim 256, 1 KB at AF32), and
# 48 query heads per kv head.
KV_RING_SHAPES = {"ring": (8, 32, 8, 128, 4096),
                  "wide_row": (4, 16, 8, 256, 2048),
                  "g48_ring": (34, 48, 1, 128, 4096)}
# decode-tick shapes (pairs, s, head_dim) whose chunk is staged whole:
# qwen3-8b at 8 slots, deepseek-moe-16b at 8 slots
KV_TICK_SHAPES = {"qwen3_tick": (64, 256, 128), "deepseek_tick": (128, 64, 128)}


@pytest.mark.parametrize("case", list(KV_RING_SHAPES) + list(KV_TICK_SHAPES))
def test_tile_plans_stage_the_chunk(case):
    """The attention body's staging plan: tiles are whole chunks at the
    decode tick, and a ring of 32-aligned tiles within the staging budget
    on the card tests' long shapes, at every float width."""
    from repro_torch.kernels.kv_decode import (STAGE_BYTES, chunk_plan,
                                               tile_rows)
    if case in KV_RING_SHAPES:
        b, _, hkv, d, s = KV_RING_SHAPES[case]
        pairs = b * hkv
    else:
        pairs, s, d = KV_TICK_SHAPES[case]
    chunk, _ = chunk_plan(pairs, s, 132)
    for bits in WIDTHS:
        row = bitpack.packed_group_words(d, bits) * 4
        tile = tile_rows(chunk, row)
        if case in KV_TICK_SHAPES and bits <= 16:
            assert tile == chunk
        elif case in KV_RING_SHAPES:
            assert 32 <= tile < chunk and tile % 32 == 0
            assert 4 * tile * (row + 16) <= STAGE_BYTES or tile == 32


# ---------------------------------------------------------------------------
# CUDA kernels against the plain versions (on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_pack_bit_exact(cuda, bits):
    rng = np.random.default_rng(bits)
    for shape in ((3, 1), (4, 33), (8, 1024), (5, 70), (2, 3, 64)):
        x = torch.from_numpy(_awkward_floats(rng, shape)).to(cuda)
        got = ops.pack(x, bits)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.pack_ref(x.cpu(), bits))


@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_take_rows_float_bit_exact(cuda, bits):
    rng = np.random.default_rng(100 + bits)
    n = 70
    table = torch.from_numpy(_packed(rng, 9, n, bits))
    for idx in (torch.tensor([3, 0, 8, 3, 3, 7, 1], dtype=torch.int32),
                torch.tensor([8, 8], dtype=torch.int64)):
        want = ref.take_rows_ref(table, idx, bits, n)
        got = ops.take_rows(table.to(cuda), idx.to(cuda), bits, n)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        got_b = ops.take_rows(table.to(cuda), idx.to(cuda), bits, n,
                              out_dtype=torch.bfloat16)
        _same_bits(got_b, ref.take_rows_ref(table, idx, bits, n,
                                            out_dtype=torch.bfloat16))


@pytest.mark.parametrize("bits", INT_WIDTHS)
@pytest.mark.parametrize("signed", [True, False])
def test_cuda_take_rows_int_bit_exact(cuda, bits, signed):
    rng = np.random.default_rng(200 + bits)
    n = 40
    table = torch.from_numpy(_packed(rng, 6, n, bits))
    idx = torch.tensor([5, 5, 0, 2], dtype=torch.int32)
    want = ref.take_rows_ref(table, idx, bits, n, kind="int", signed=signed,
                             out_dtype=torch.int32)
    got = ops.take_rows(table.to(cuda), idx.to(cuda), bits, n, kind="int",
                        signed=signed, out_dtype=torch.int32)
    assert torch.equal(got.cpu(), want)


# name: (table rows, n, gathered rows, 16-byte aligned table base). The
# tick shapes give a chunk (8 codes) a thread; the others stream over a
# resident grid, more than one round of 4 chunks a thread.
TAKE_SHAPES = {"tick": (3000, 4096, 8, True),
               "stream": (3000, 4096, 4096, True),
               "ragged_tick": (500, 70, 8, False),
               "ragged_aligned": (500, 70, 2048, True),
               "ragged_stream": (500, 70, 100_000, False)}


def _take_case(cuda, shape, bits, seed):
    """A table of random words made on the card (every code, NaNs
    included), its base 4 bytes off 16-byte alignment where the shape
    says so, and int64 indices that overrun both ends."""
    rows, n, count, aligned = TAKE_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    words = -(-n // 32) * bits
    flat = torch.randint(0, 2**32, (rows * words + 1,), generator=gen,
                         device=cuda).to(torch.int32)
    table = (flat[:-1] if aligned else flat[1:]).view(rows, words)
    assert (table.data_ptr() % 16 == 0) == aligned
    idx = torch.randint(-3, rows + 3, (count,), generator=gen, device=cuda)
    idx[:4] = torch.tensor([-1, rows, 0, rows - 1])
    return table, idx, idx.clamp(0, rows - 1), n


@pytest.mark.parametrize("shape", TAKE_SHAPES)
@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_take_rows_routes_float(cuda, shape, bits):
    """Both routes, ragged n, an unaligned base, int64 and int32 indices,
    out-of-range indices clamped: bit for bit against the plain version
    and against the decoded table's rows, f32 and bf16."""
    table, idx, clamped, n = _take_case(cuda, shape, bits, bits)
    for dt in (torch.float32, torch.bfloat16):
        want = ref.take_rows_ref(table, clamped, bits, n, out_dtype=dt)
        for ix in (idx, idx.to(torch.int32)):
            _same_bits(ops.take_rows(table, ix, bits, n, out_dtype=dt), want)
        _same_bits(ops.unpack(table, bits, n, dt)[clamped], want)


@pytest.mark.parametrize("shape", TAKE_SHAPES)
@pytest.mark.parametrize("bits", INT_WIDTHS)
def test_cuda_take_rows_routes_int(cuda, shape, bits):
    table, idx, clamped, n = _take_case(cuda, shape, bits, 50 + bits)
    for signed in (True, False):
        for dt in (torch.int32, torch.float32):
            want = ref.take_rows_ref(table, clamped, bits, n, kind="int",
                                     signed=signed, out_dtype=dt)
            _same_bits(ops.take_rows(table, idx, bits, n, kind="int",
                                     signed=signed, out_dtype=dt), want)


def test_cuda_decode_every_af16_code(cuda):
    """The AF16 decode (hardware conversion + NaN canonicalisation) is
    bit-equal to decode_float on all 65536 codes; AF8 and AF12 too."""
    for bits in (8, 12, 16):
        codes = torch.arange(2**bits, dtype=torch.int64).to(torch.int32)
        table = bitpack.pack_groups(codes.reshape(-1, 32), bits)
        idx = torch.arange(table.shape[0], dtype=torch.int32)
        want = ref.take_rows_ref(table, idx, bits, 32)
        got = ops.take_rows(table.to(cuda), idx.to(cuda), bits, 32)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bits", (8, 12, 16, 20, 24, 32))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packed_matmul(cuda, transpose, bits, dtype):
    """The kernel against its plain version: ragged shapes, the
    speculative verify's 40 rows of x, and w_out's shape (a 3-way K
    split), a full cluster (8-way) and a K past 8 slices of the transposed
    orientation's x buffer (slices walked in passes; K odd, so x is
    copied element by element) made on the card; a misaligned W raises.
    bf16 x at AF8-AF16 runs on the tensor cores, the rest on f32 FMAs
    (AF20 and AF24 codes straddle words)."""
    rng = np.random.default_rng(300 + bits)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for m, k, n in ((1, 5, 7), (3, 100, 33), (8, 64, 96), (17, 300, 260),
                    (40, 1000, 300), (8, 4096, 1024)):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        x = x.to(dtype)
        wp = torch.from_numpy(_packed_w(rng, n, k, bits) if transpose
                              else _packed_w(rng, k, n, bits))
        want = ref.packed_matmul_ref(x, wp, bits, n, transpose)
        got = ops.packed_matmul(x.to(cuda), wp.to(cuda), bits, n, transpose)
        assert got.dtype == dtype and got.shape == (m, n)
        torch.testing.assert_close(got.float().cpu(), want.to(dtype).float(),
                                   rtol=tol, atol=tol)
    gen = torch.Generator(device=cuda).manual_seed(300 + bits)
    for m, k, n in ((8, 12288, 4096), (8, 12288, 1024), (40, 20001, 300)):
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        w = torch.randn((n, k) if transpose else (k, n), generator=gen,
                        device=cuda) / np.sqrt(k)
        wp = ref.pack_ref(w, bits)
        want = ref.packed_matmul_ref(x, wp, bits, n, transpose)
        got = ops.packed_matmul(x, wp, bits, n, transpose)
        assert got.dtype == dtype and got.shape == (m, n)
        torch.testing.assert_close(got.float(), want.to(dtype).float(),
                                   rtol=tol, atol=tol)
    # W off the 16-byte grid is refused, in either orientation
    flat = torch.zeros(wp.numel() + 1, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.packed_matmul(x, flat[1:].view(wp.shape), bits, n, transpose)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packed_matmul_past_the_row_tile_limit(cuda, transpose, dtype):
    """524,288 + 8 rows of x, past the 524,280 one launch's grid covers
    (65,535 row tiles on its y axis): two launches, every row held to the
    plain version, the rows of the second launch included."""
    from repro_torch.kernels.packed_matmul import MAX_ROWS
    m, k, n, bits = 524288 + 8, 64, 40, 16
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn((2, m // 2, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((n, k) if transpose else (k, n), generator=gen,
                    device=cuda) / np.sqrt(k)
    wp = ref.pack_ref(w, bits)
    before = ops.launch_counts()["packed_matmul"]
    got = ops.packed_matmul(x, wp, bits, n, transpose)
    assert ops.launch_counts()["packed_matmul"] == before + 2
    want = ref.packed_matmul_ref(x, wp, bits, n, transpose)
    assert got.dtype == dtype and got.shape == (2, m // 2, n)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=tol,
                               atol=tol)
    tail = got.reshape(m, n)[MAX_ROWS:]
    assert tail.shape[0] == m - MAX_ROWS and bool(tail.abs().sum() > 0)


@pytest.mark.parametrize("bits", (8, 12, 16))
def test_cuda_packed_matmul_mma_decode_exact(cuda, bits):
    """The tensor-core path's decode is exact for every code, in both
    orientations: one-hot bf16 rows of x against a W holding each code
    once (code c in column c, row c % 64, zeros elsewhere; transposed,
    the same table laid out along K, (2^bits, 64)) give the plain
    version's bf16 values bit for bit, with +0 and -0 equal and NaN
    compared as NaN-ness (a zero times an inf or NaN code is NaN in
    both)."""
    k, n = 64, 2**bits
    cols = torch.arange(n)
    codes = torch.zeros((k, n), dtype=torch.int32)
    codes[cols % k, cols] = cols.to(torch.int32)
    x = torch.eye(k, dtype=torch.bfloat16, device=cuda)
    for transpose in (False, True):
        table = codes.t().contiguous() if transpose else codes
        wp = bitpack.pack_groups(table, bits).to(cuda)
        got = ops.packed_matmul(x, wp, bits, n, transpose)
        want = ref.packed_matmul_ref(x, wp, bits, n, transpose).bfloat16()
        assert got.dtype == torch.bfloat16 and got.shape == (k, n)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert torch.equal(got[keep].float(), want[keep].float())
        # the diagonal (row c % 64 of column c) is code c itself
        diag = want[cols % k, cols].float()
        assert torch.isinf(diag).sum().item() == 2


def _ring_lens(rng, b, s):
    """Lengths 0, 1, s, s + 3, then random ones in [1, s]."""
    lens = [0, 1, s, s + 3] + [int(n) for n in rng.integers(1, s + 1, b)]
    return lens[:b]


def _kv_ring_case(rng, b, h, hkv, d, s, bits, dtype, dev):
    """q and a dense K, V cache of unit-normal rows packed at ``bits``,
    made on the card; lengths from ``_ring_lens``."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    kp, vp = (ref.pack_ref(torch.randn((b, s, hkv, d), generator=gen,
                                       device=dev), bits) for _ in range(2))
    kv_len = torch.tensor(_ring_lens(rng, b, s), dtype=torch.int32)
    return q, kp, vp, kv_len


@pytest.mark.parametrize("shapes", ["base"] + list(KV_RING_SHAPES))
@pytest.mark.parametrize("bits", (8, 16, 32))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kv_decode(cuda, bits, dtype, shapes):
    """The kernel against its plain version: small shapes, and the ring
    shapes (a chunk staged over several tiles, the largest row, G 48)."""
    rng = np.random.default_rng(400 + bits)
    cases = (((4, 8, 2, 32, 13), (4, 32, 8, 128, 300), (4, 6, 1, 64, 1),
              (4, 48, 1, 128, 40)) if shapes == "base"
             else (KV_RING_SHAPES[shapes],))
    for b, h, hkv, d, s in cases:
        if shapes == "base":
            q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(
                np.float32)).to(dtype)
            kp = torch.from_numpy(
                _packed_w(rng, b * s * hkv, d, bits).reshape(b, s, hkv, -1))
            vp = torch.from_numpy(
                _packed_w(rng, b * s * hkv, d, bits).reshape(b, s, hkv, -1))
            kv_len = torch.tensor([0, 1, s, s + 3], dtype=torch.int32)
        else:
            q, kp, vp, kv_len = _kv_ring_case(rng, b, h, hkv, d, s, bits,
                                              dtype, cuda)
        want = ref.kv_decode_ref(q, kp, vp, bits, d, kv_len.to(q.device))
        got = ops.kv_decode(q.to(cuda), kp.to(cuda), vp.to(cuda),
                            kv_len.to(cuda), bits, d)
        assert got.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                                   rtol=tol, atol=tol)
        assert not got[0].any()


def _paged_case(rng, b, h, hkv, d, page, lens, bits, dtype, dev=None):
    """Pools of ``bits``-wide words (bf16/f32 rows when 0) with shuffled
    page ids, entries past each length on the scrap page 0, which holds
    large finite poison; slots 0 and 1 share their first page. With
    ``dev`` the rows are made there (the large card cases)."""
    mp = max(1, -(-max(lens) // page))
    n_pages = 1 + b * mp
    shape = (2, n_pages, page, hkv * d)
    if dev is None:
        rows = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    else:
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.integers(2**31)))
        rows = torch.randn(shape, generator=gen, device=dev)
    rows[:, 0] = 10.0
    pools = [r.reshape(n_pages, page, hkv, d) for r in rows]
    # each head's row packed on its own (head_dim need not be 32-aligned)
    pools = [ref.pack_ref(p, bits) if bits else p.to(dtype) for p in pools]
    table = rng.permutation(np.arange(1, n_pages))[: b * mp].astype(
        np.int32).reshape(b, mp)
    table[1, 0] = table[0, 0]
    for i, ln in enumerate(lens):
        table[i, -(-ln // page):] = 0
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    return (q.to(dtype), *pools, torch.from_numpy(table),
            torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("shapes", ["base", "narrow_rows"]
                         + list(KV_RING_SHAPES))
@pytest.mark.parametrize("bits", (0, 8, 16, 32))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention(cuda, bits, dtype, shapes):
    """The paged kernel against its plain version; with packed pools
    also bit for bit against ``kv_decode`` over the same rows laid out
    dense (one body, one chunk and tile plan). ``narrow_rows``: plain
    rows of 66-144 bytes, copied 8 or 4 bytes at a time; bf16 rows of
    an odd head_dim (not a multiple of 4 bytes) raise. The ring shapes
    run through pages of 16 rows."""
    rng = np.random.default_rng(500 + bits)
    if shapes == "base":
        cases = ((4, 8, 2, 32, 4, [0, 1, 4, 13]),
                 (6, 32, 8, 128, 16, [0, 1, 15, 16, 17, 300]),
                 (3, 6, 1, 64, 8, [9, 1, 200]))
    elif shapes == "narrow_rows":
        cases = tuple((3, 4, 2, d, 8, [0, 19, 40]) for d in (36, 34, 33))
    else:
        b, h, hkv, d, s = KV_RING_SHAPES[shapes]
        cases = ((b, h, hkv, d, 16, _ring_lens(rng, b, s)),)
    for b, h, hkv, d, page, lens in cases:
        case = _paged_case(rng, b, h, hkv, d, page, lens, bits, dtype,
                           None if shapes in ("base", "narrow_rows")
                           else cuda)
        q, kp, vp, table, kv_len = case
        if bits == 0 and dtype == torch.bfloat16 and d % 2:
            with pytest.raises(ValueError, match="4-byte"):
                ops.paged_attention(*(t.to(cuda) for t in case), bits, d)
            continue
        want = ref.paged_attention_ref(*(t.to(kp.device) for t in case),
                                       bits, d)
        before = ops.launch_counts()["paged_attention"]
        got = ops.paged_attention(*(t.to(cuda) for t in case), bits, d)
        assert ops.launch_counts()["paged_attention"] == before + 1
        assert got.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                                   rtol=tol, atol=tol)
        assert lens[0] or not got[0].any()        # kv_len == 0 gives zeros
        if bits:
            dense = ops.kv_decode(
                q.to(cuda), ref.gather_pages_ref(kp, table).to(cuda),
                ref.gather_pages_ref(vp, table).to(cuda), kv_len.to(cuda),
                bits, d)
            assert torch.equal(dense, got)


def test_cuda_gather_route_raises(cuda):
    """No CUDA path reaches the gather route: the gather and the scatter,
    and a gather-route engine, all raise."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import gather_kv_pages, scatter_kv_row
    from repro_torch.serving import ServeEngine
    case = _paged_case(np.random.default_rng(0), 2, 4, 2, 32, 4, [3, 5], 16,
                       torch.float32)
    _, kp, _, table, kv_len = (t.to(cuda) for t in case)
    with pytest.raises(NotImplementedError, match="fused"):
        gather_kv_pages(kp, table)
    with pytest.raises(NotImplementedError, match="fused"):
        scatter_kv_row(kp, kp[None], table, kv_len)
    with pytest.raises(NotImplementedError, match="CPU only"):
        ServeEngine(get_config("qwen3_8b").reduced(), max_slots=2,
                    paged=True, paged_attn=False, device=cuda)


def test_cuda_paged_engine_matches_cpu(cuda):
    """Reduced qwen3 paged engine on the card against the CPU with the
    same packed weights, on a shared-prefix traffic: identical tokens and
    pool counters; the card's path launches paged_attention, never
    kv_decode."""
    from repro_torch.configs import get_config
    from repro_torch.core.compress import repack, uniform_plan
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeEngine
    cfg = get_config("qwen3_8b").reduced()
    params = LM(cfg, device=cuda).init()
    params = repack(params, uniform_plan(params, 16))
    rng = np.random.default_rng(2)
    system = [int(t) for t in rng.integers(1, cfg.vocab_size, 16)]
    prompts = [system + [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (1, 5, 9, 3, 7)]
    res = {}
    for dev in (cuda, torch.device("cpu")):
        eng = ServeEngine(cfg, max_seq_len=48, max_slots=3, paged=True,
                          kv_page_size=8, params=tree_to(params, dev),
                          device=dev)
        before = ops.launch_counts()
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        stats = eng.run_until_drained()
        after = ops.launch_counts()
        res[dev.type] = ([eng.result(r) for r in rids],
                         {k: stats[k] for k in ("prefix_hits", "cow_copies",
                                                "table_uploads",
                                                "kv_pages_read",
                                                "pool_alloc_total")})
        if dev.type == "cuda":
            assert after["paged_attention"] > before["paged_attention"]
            assert after["kv_decode"] == before["kv_decode"]
    assert res["cuda"] == res["cpu"]
    assert res["cpu"][1]["prefix_hits"] > 0


@pytest.mark.parametrize("case", UNFUSED)
def test_cuda_unfused_packed_weight_raises(cuda, case):
    """On the card a packed weight that no kernel takes is an error, not
    a full decode through the plain version."""
    call, _ = _unfused_case(case, cuda)
    ops.FALLBACK_RECORDS.clear()
    with pytest.raises(NotImplementedError, match="no kernel path"):
        call()
    assert not ops.FALLBACK_RECORDS


def test_cuda_decode_step_matches_cpu(cuda):
    """Reduced qwen3 decode_step on the card (kernels) against the CPU
    (plain versions), same packed weights: logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.core.compress import repack, uniform_plan
    from repro_torch.core.tensor_store import tree_to
    from repro_torch.models.lm import LM
    cfg = get_config("qwen3_8b").reduced()
    lm_gpu, lm_cpu = LM(cfg, device=cuda), LM(cfg, device="cpu")
    params = lm_gpu.init()
    params = repack(params, uniform_plan(params, 16))
    params_cpu = tree_to(params, "cpu")
    st_g, st_c = lm_gpu.init_decode_state(3, 40), lm_cpu.init_decode_state(3, 40)
    rng = np.random.default_rng(0)
    before = dict(ops.launch_counts())
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))
        lg, st_g = lm_gpu.decode_step(params, st_g, toks.to(cuda))
        lc, st_c = lm_cpu.decode_step(params_cpu, st_c, toks)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    after = ops.launch_counts()
    unused = ("packed_matmul_transposed", "packed_matmul_batched",
              "paged_attention", "unpack", "convert", "truncate")
    assert all(after[k] > before[k] for k in before if k not in unused)
    # qwen3's head is untied (no transposed product), a dense model has
    # no expert banks, a dense cache no page table, and no model path
    # calls unpack, convert or truncate
    assert all(after[k] == before[k] for k in unused)
