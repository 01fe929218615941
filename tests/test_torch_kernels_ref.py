"""The port's four kernels: plain versions against the JAX oracles, and
(on a card) the CUDA kernels against the plain versions.

The ``ref_*`` tests import the reference lazily, so the ``cuda`` tests of
this file also run on a machine without JAX. The ``cuda`` tests decide
inside a fixture whether there is a card and skip without one.
Tolerances: ``pack`` and ``take_rows`` are bit-exact; ``packed_matmul``
and ``kv_decode`` differ from their oracles only in summation order
(rtol = atol = 1e-5 in f32 on the CPU); on the card, bf16 outputs may
round one bf16 ulp apart from the f32 result.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import bitpack
from repro_torch.core.formats import FLOAT_LADDER
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


def _assert_same_bf16(got: torch.Tensor, want_f32: torch.Tensor) -> None:
    """bf16 results equal bit for bit, NaN for NaN (the host conversion
    drops a NaN's sign, the device conversion keeps it)."""
    want = want_f32.bfloat16()
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep].view(torch.int16), want[keep].view(torch.int16))


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
    from repro_torch.kernels import kv_decode, pack, packed_matmul, take
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
        _assert_same_bf16(got_b, want)


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
@pytest.mark.parametrize("bits", (8, 12, 16, 32))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packed_matmul(cuda, transpose, bits, dtype):
    rng = np.random.default_rng(300 + bits)
    for m, k, n in ((1, 5, 7), (3, 100, 33), (8, 64, 96), (17, 300, 260),
                    (8, 4096, 1024)):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        x = x.to(dtype)
        wp = torch.from_numpy(_packed_w(rng, n, k, bits) if transpose
                              else _packed_w(rng, k, n, bits))
        want = ref.packed_matmul_ref(x, wp, bits, n, transpose)
        got = ops.packed_matmul(x.to(cuda), wp.to(cuda), bits, n, transpose)
        assert got.dtype == dtype and got.shape == (m, n)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float().cpu(), want.to(dtype).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("bits", (8, 16, 32))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kv_decode(cuda, bits, dtype):
    rng = np.random.default_rng(400 + bits)
    for b, h, hkv, d, s in ((4, 8, 2, 32, 13), (4, 32, 8, 128, 300),
                            (4, 6, 1, 64, 1), (4, 48, 1, 128, 40)):
        q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(
            np.float32)).to(dtype)
        kp = torch.from_numpy(
            _packed_w(rng, b * s * hkv, d, bits).reshape(b, s, hkv, -1))
        vp = torch.from_numpy(
            _packed_w(rng, b * s * hkv, d, bits).reshape(b, s, hkv, -1))
        kv_len = torch.tensor([0, 1, s, s + 3], dtype=torch.int32)
        want = ref.kv_decode_ref(q, kp, vp, bits, d, kv_len)
        got = ops.kv_decode(q.to(cuda), kp.to(cuda), vp.to(cuda),
                            kv_len.to(cuda), bits, d)
        assert got.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=tol, atol=tol)
        assert not got[0].any()


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
    assert all(after[k] > before[k] for k in before
               if k != "packed_matmul_batched")
    # a dense model has no expert banks
    assert after["packed_matmul_batched"] == before["packed_matmul_batched"]
