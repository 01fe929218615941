"""The kernel-granularity compression flow (Fig. 7): the port against the
reference.

The reference's suite kernels (``benchmarks/kernel_suite.py``) are
written here twice, in JAX and in torch, the torch twins in the
reference's operation order, so that ``torch.export`` gives one graph
node per jaxpr equation and one float value per float SSA value.

* ``QuantizedKernel``: the same values (vid, shape, size), and ``run``
  at no quantization and at each uniform Table 3 width the reference's
  output bit for bit; Deferred runs ``exp``, whose f32 result may differ
  by an ulp or two between XLA and ATen, so its outputs are held within
  2 ulps of the run's narrowest format instead.
* ``compress_kernel``: Deferred at the perfect and high thresholds and
  Hotspot and CFD at perfect give the reference's ``KernelCompression``
  field for field (vids' formats, int bits, both pressures, split count,
  operands and live ranges, table words in order) and its ``repressure``
  for Fig. 9's isolated bars. ``tune_kernel`` over a short ladder gives
  the reference's formats and evaluations for Hotspot and IMGVF at high.
* GICOV and DWT2D, whose graphs differ from the jaxprs, are held to the
  flow's properties, as the reference's ``tests/test_static_analysis.py``
  states them.
* Fig. 8's e-SSA ranges and bit widths equal the reference's.

The reference is imported in fixtures, and its round trip is jitted
there (the same bits; its eager form costs ~1 ms a value), so the
``cuda`` tests run without JAX: the card's ``QuantizedKernel`` and
``compress_kernel`` against the CPU's. They skip without a card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.compress import KernelCompression, compress_kernel
from repro_torch.core import essa
from repro_torch.core.essa import figure8_program, merged_ranges, solve_ranges
from repro_torch.core.formats import FLOAT_FORMATS, FLOAT_LADDER
from repro_torch.core.precision_tuning import QuantizedKernel, tune_kernel
from repro_torch.core.quality import HIGH, PERFECT, QualitySpec
from repro_torch.core.range_analysis import Interval
from repro_torch.interop import kernel_compression_from_fields
from repro_torch.kernels import ops

N = 16                                   # the suite's image side


# -- the torch twins, in the reference's operation order ----------------------

def deferred(albedo, normal_z, depth):
    light = torch.clamp(normal_z, 0.0, 1.0)
    fog = torch.exp(-depth * 0.5)
    return albedo * light * fog + 0.1 * albedo


def hotspot(temp, power):
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


def cfd(rho, mom):
    for _ in range(3):
        flux = 0.25 * (torch.roll(rho, 1, 0) + torch.roll(rho, -1, 0)
                       + torch.roll(rho, 1, 1) + torch.roll(rho, -1, 1))
        rho = rho + 0.1 * (flux - rho) + 0.01 * mom
        mom = mom * 0.99
    return rho


def imgvf(grad, mask):
    v = grad
    for _ in range(5):
        lap = (torch.roll(v, 1, 0) + torch.roll(v, -1, 0)
               + torch.roll(v, 1, 1) + torch.roll(v, -1, 1) - 4 * v)
        v = v + 0.2 * lap - 0.1 * mask * (v - grad)
    return v


def gicov(img, kernel_row):
    score = torch.zeros_like(img)
    for k in range(4):
        shifted = torch.roll(img, k - 2, 1)
        score = score + shifted * kernel_row[k]
    mean = score / 4.0
    var = (score - mean) ** 2 + 1e-3
    return mean / var


def dwt2d(img):
    a = (img[0::2, :] + img[1::2, :]) * 0.5
    d = (img[0::2, :] - img[1::2, :]) * 0.5
    aa = (a[:, 0::2] + a[:, 1::2]) * 0.5
    ad = (a[:, 0::2] - a[:, 1::2]) * 0.5
    return torch.cat(
        [torch.cat([aa, ad], 1),
         torch.cat([(d[:, 0::2] + d[:, 1::2]) * 0.5,
                    (d[:, 0::2] - d[:, 1::2]) * 0.5], 1)], 0)


# name -> (twin, number of N x N inputs, quality metric)
SUITE = {"Deferred": (deferred, 3, "ssim"), "Hotspot": (hotspot, 2,
                                                         "deviation"),
         "CFD": (cfd, 2, "deviation"), "IMGVF": (imgvf, 2, "deviation")}


def _inputs(name, n=N):
    rng = np.random.default_rng(sorted(SUITE).index(name))
    return [rng.random((n, n), dtype=np.float32)
            for _ in range(SUITE[name][1])]


def _torch_args(arrays, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.fixture(scope="module")
def jref():
    """The reference's flow (its round trip jitted: the same bits) and
    the suite's JAX kernels, written as ``benchmarks/kernel_suite.py``
    writes them."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.core import compress as rcompress
    from repro.core import essa as ressa
    from repro.core import precision_tuning as rpt
    from repro.core.quality import QualitySpec as RQualitySpec

    def jdeferred(albedo, normal_z, depth):
        light = jnp.clip(normal_z, 0.0, 1.0)
        fog = jnp.exp(-depth * 0.5)
        return albedo * light * fog + 0.1 * albedo

    def jhotspot(temp, power):
        rows = jnp.arange(temp.shape[0])
        cols = jnp.arange(temp.shape[1])
        border = ((rows[:, None] % (temp.shape[0] - 1)) == 0) | (
            (cols[None, :] % (temp.shape[1] - 1)) == 0)
        for _ in range(4):
            up = jnp.roll(temp, 1, 0)
            dn = jnp.roll(temp, -1, 0)
            lf = jnp.roll(temp, 1, 1)
            rt = jnp.roll(temp, -1, 1)
            delta = 0.1 * (up + dn + lf + rt - 4 * temp) + 0.05 * power
            temp = jnp.where(border, temp, temp + delta)
        return temp

    def jcfd(rho, mom):
        for _ in range(3):
            flux = 0.25 * (jnp.roll(rho, 1, 0) + jnp.roll(rho, -1, 0)
                           + jnp.roll(rho, 1, 1) + jnp.roll(rho, -1, 1))
            rho = rho + 0.1 * (flux - rho) + 0.01 * mom
            mom = mom * 0.99
        return rho

    def jimgvf(grad, mask):
        v = grad
        for _ in range(5):
            lap = (jnp.roll(v, 1, 0) + jnp.roll(v, -1, 0)
                   + jnp.roll(v, 1, 1) + jnp.roll(v, -1, 1) - 4 * v)
            v = v + 0.2 * lap - 0.1 * mask * (v - grad)
        return v

    mp = pytest.MonkeyPatch()
    mp.setattr(rpt, "quantize_dequantize",
               jax.jit(rpt.quantize_dequantize, static_argnums=1))
    yield {"jnp": jnp, "compress": rcompress, "pt": rpt, "essa": ressa,
           "QualitySpec": RQualitySpec,
           "fns": {"Deferred": jdeferred, "Hotspot": jhotspot, "CFD": jcfd,
                   "IMGVF": jimgvf}, "results": {}}
    mp.undo()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card (python -m pytest "
                    "tests/test_torch_kernel_flow.py -k cuda)")
    return torch.device("cuda")


def _spec(metric, perfect):
    return (PERFECT if perfect else HIGH)[metric]


def _bits(t) -> np.ndarray:
    return np.asarray(t).view(np.int32).astype(np.int64)


def _check_close(name, got, want, width):
    """Bit for bit, or for Deferred (``exp``) within 2 ulps of the
    narrowest format in the run."""
    got, want = np.asarray(got), np.asarray(want)
    if name != "Deferred":
        assert (_bits(got) == _bits(want)).all(), (name, width)
        return
    tol = 2.0 * 2.0 ** -FLOAT_FORMATS[width].mantissa_bits
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


# -- QuantizedKernel ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SUITE))
def test_quantized_kernel_run_matches_reference(jref, name):
    twin = SUITE[name][0]
    arrays = _inputs(name)
    rqk = jref["pt"].QuantizedKernel(jref["fns"][name],
                                     *map(jref["jnp"].asarray, arrays))
    qk = QuantizedKernel(twin, *_torch_args(arrays), device="cpu")
    assert [(v.vid, v.shape, v.size) for v in qk.values] == \
        [(v.vid, v.shape, v.size) for v in rqk.values]
    jargs = [jref["jnp"].asarray(a) for a in arrays]
    for width in (None,) + FLOAT_LADDER:
        formats = {} if width is None else {v.vid: width for v in qk.values}
        got = qk.run(formats, *_torch_args(arrays))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _check_close(name, got.numpy(), rqk.run(formats, *jargs),
                     width or 32)


def test_quantized_kernel_launches_b8_per_narrow_value(monkeypatch):
    """Each value narrower than 32 bits is one truncate and one convert;
    a 32-bit value passes through without either."""
    qk = QuantizedKernel(cfd, *_torch_args(_inputs("CFD")), device="cpu")
    calls = []
    for name in ("truncate", "convert"):
        def wrapped(x, bits, _fn=getattr(ops, name), _name=name):
            calls.append((_name, bits))
            return _fn(x, bits)
        monkeypatch.setattr(ops, name, wrapped)
    formats = {v.vid: FLOAT_LADDER[v.vid % 7] for v in qk.values}
    qk.run(formats, *_torch_args(_inputs("CFD")))
    narrow = [b for b in formats.values() if b < 32]
    assert sorted(calls) == sorted([("truncate", b) for b in narrow]
                                   + [("convert", b) for b in narrow])


# -- compress_kernel ----------------------------------------------------------

def _reference_compression(jref, name, perfect):
    key = (name, perfect)
    if key not in jref["results"]:
        metric = SUITE[name][2]
        threshold = _spec(metric, perfect).threshold
        jref["results"][key] = jref["compress"].compress_kernel(
            name, jref["fns"][name],
            [tuple(map(jref["jnp"].asarray, _inputs(name)))],
            jref["QualitySpec"](metric, threshold))
    return jref["results"][key]


@pytest.mark.parametrize("name,perfect", [("Deferred", True),
                                          ("Deferred", False),
                                          ("Hotspot", True), ("CFD", True)])
def test_compress_kernel_matches_reference(jref, name, perfect):
    ref = _reference_compression(jref, name, perfect)
    kc = compress_kernel(name, SUITE[name][0], [_torch_args(_inputs(name))],
                         _spec(SUITE[name][2], perfect), device="cpu")
    want = kernel_compression_from_fields(dataclasses.asdict(ref))
    assert isinstance(kc, KernelCompression)
    assert kc.float_formats == want.float_formats
    assert kc.int_bits == want.int_bits
    assert kc.operands == want.operands
    assert kc.allocation.table_words() == ref.allocation.table_words()
    assert kc == want
    assert kc.pressure_reduction == ref.pressure_reduction
    for use_ints in (True, False):
        for use_floats in (True, False):
            for contiguous in (False, True):
                assert kc.repressure(use_ints, use_floats, contiguous) == \
                    ref.repressure(use_ints, use_floats, contiguous)
    if name == "Hotspot":                 # its integer tile-coordinate path
        assert kc.int_bits and all(b <= 5 for b, _ in kc.int_bits.values())


@pytest.mark.parametrize("name", ["Hotspot", "IMGVF"])
def test_tune_kernel_short_ladder_matches_reference(jref, name):
    arrays = _inputs(name)
    jargs = tuple(map(jref["jnp"].asarray, arrays))
    metric = SUITE[name][2]
    ladder = (16, 32)
    ref = jref["pt"].tune_kernel(
        jref["pt"].QuantizedKernel(jref["fns"][name], *jargs), [jargs],
        jref["QualitySpec"](metric, HIGH[metric].threshold), ladder=ladder)
    qk = QuantizedKernel(SUITE[name][0], *_torch_args(arrays), device="cpu")
    got = tune_kernel(qk, [_torch_args(arrays)], HIGH[metric], ladder=ladder)
    assert got.formats == ref.formats
    assert got.evaluations == ref.evaluations
    assert got.mean_bits() == ref.mean_bits()


# -- the flow's properties where the graphs differ ----------------------------

def _gicov_args():
    rng = np.random.default_rng(17)
    return (torch.from_numpy(rng.random((N, N), dtype=np.float32)),
            torch.from_numpy(rng.random(4, dtype=np.float32)))


def _dwt2d_args():
    rng = np.random.default_rng(10)
    return (torch.from_numpy(rng.random((N, N), dtype=np.float32)),)


@pytest.mark.parametrize("fn,args", [(gicov, _gicov_args),
                                     (dwt2d, _dwt2d_args)],
                         ids=["GICOV", "DWT2D"])
def test_flow_properties(fn, args):
    args = args()
    qk = QuantizedKernel(fn, *args, device="cpu")
    ref = qk.run({}, *args)
    res = {}
    for spec in (QualitySpec("deviation", 0.0), QualitySpec("deviation", 1.0),
                 QualitySpec("deviation", 10.0)):
        res[spec.threshold] = tune_kernel(qk, [args], spec)
        # the formats meet the gate they were tuned to
        assert spec.accepts(ref, qk.run(res[spec.threshold].formats, *args))
        assert set(res[spec.threshold].formats.values()) <= set(FLOAT_LADDER)
    # a looser threshold never needs more bits
    assert res[10.0].mean_bits() <= res[1.0].mean_bits() <= \
        res[0.0].mean_bits()
    # perfect: bit-identical output
    assert torch.equal(qk.run(res[0.0].formats, *args), ref)
    kc = compress_kernel(fn.__name__, fn, [args],
                         QualitySpec("deviation", 10.0), device="cpu")
    base = compress_kernel(fn.__name__, fn, [args],
                           QualitySpec("deviation", 0.0), device="cpu")
    assert kc.float_formats == res[10.0].formats
    assert kc.packed_pressure < kc.baseline_pressure
    assert kc.packed_pressure <= base.packed_pressure
    assert kc.baseline_pressure == base.baseline_pressure
    assert all(0 <= w < 2**32 for w in kc.allocation.table_words())


def _stencil(t, p):
    up = torch.roll(t, 1, 0)
    dn = torch.roll(t, -1, 0)
    return t + 0.1 * (up + dn - 2 * t) + 0.05 * p


def test_stencil_perfect_keeps_32_bits():
    args = _inputs("CFD")
    qk = QuantizedKernel(_stencil, *_torch_args(args), device="cpu")
    perfect = tune_kernel(qk, [_torch_args(args)],
                          QualitySpec("deviation", 0.0))
    assert all(b == 32 for b in perfect.formats.values())
    loose = tune_kernel(qk, [_torch_args(args)],
                        QualitySpec("deviation", 10.0))
    assert loose.mean_bits() < perfect.mean_bits()


def test_compress_kernel_with_integer_inputs():
    """The reference's end-to-end demo: a gather through an integer
    index with a declared range, and a blur."""
    def kernel(img, idx):
        g = img.reshape(-1)[idx % img.numel()]
        blur = _stencil(img, img)
        return blur.sum() + g.sum()

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((N, N), dtype=np.float32))
    idx = torch.arange(32, dtype=torch.int32)
    kc = compress_kernel("demo", kernel, [(img, idx)],
                         QualitySpec("deviation", 10.0),
                         input_ranges=[None, Interval(0, 31)], device="cpu")
    assert kc.packed_pressure < kc.baseline_pressure
    assert kc.pressure_reduction > 0.2
    assert kc.allocation.total_slices > 0
    # the index keeps its declared range: 5 unsigned bits (v1 is idx)
    assert kc.int_bits["v1"] == (5, False)
    assert all(b < 32 for b, _ in kc.int_bits.values())


# -- Fig. 8: e-SSA ------------------------------------------------------------

def _div_program(mod):
    blocks = {
        "entry": mod.Block("entry", (), mod.Branch("n", ">=", mod.Const(8),
                                                   "big", "small")),
        "big": mod.Block("big", (mod.Assign("q", "div", "n", mod.Const(3)),),
                         mod.Jump("end")),
        "small": mod.Block("small", (mod.Assign("r", "div", "n",
                                                mod.Const(-2)),),
                           mod.Jump("end")),
        "end": mod.Block("end", (mod.Assign("s", "phi", "q", "r"),
                                 mod.Assign("u", "sub", "s", "n")), None),
    }
    return mod.Program(blocks=blocks, entry="entry",
                       inputs={"n": mod.Interval(-7, 29)})


def _as_tuples(env):
    return {k: (v.lo, v.hi) for k, v in env.items()}


def test_figure8_essa_matches_reference(jref):
    ressa = jref["essa"]
    env = solve_ranges(figure8_program())
    assert _as_tuples(env) == _as_tuples(ressa.solve_ranges(
        ressa.figure8_program()))
    assert (env["k_t"].lo, env["k_t"].hi) == (0, 49)
    assert (env["k_f"].lo, env["k_f"].hi) == (50, 99)
    merged = merged_ranges(figure8_program())
    want = ressa.merged_ranges(ressa.figure8_program())
    assert {k: ((i.lo, i.hi), b) for k, (i, b) in merged.items()} == \
        {k: ((i.lo, i.hi), b) for k, (i, b) in want.items()}
    assert merged["k"][1] == (7, False) and merged["b"][1] == (6, False)
    assert merged["j"][1] == (7, False) and merged["a"][0].hi == 98
    # a floored division on both edges of a branch
    got = merged_ranges(_div_program(essa))
    want = ressa.merged_ranges(_div_program(ressa))
    assert {k: ((i.lo, i.hi), b) for k, (i, b) in got.items()} == \
        {k: ((i.lo, i.hi), b) for k, (i, b) in want.items()}


# -- on the card --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SUITE))
def test_cuda_quantized_kernel_matches_cpu(cuda, name):
    """The card's run (B8's CUDA truncate and convert) against the CPU's
    (their plain versions), at no quantization and each uniform width:
    bit for bit, Deferred (``exp``) within 2 ulps of the narrowest
    format; two B8 launches per value below 32 bits."""
    twin = SUITE[name][0]
    arrays = _inputs(name)
    qk = {d: QuantizedKernel(twin, *_torch_args(arrays, d), device=d)
          for d in ("cuda", "cpu")}
    for width in (None,) + FLOAT_LADDER:
        formats = ({} if width is None
                   else {v.vid: width for v in qk["cpu"].values})
        ops.reset_launch_counts()
        got = qk["cuda"].run(formats, *_torch_args(arrays, "cuda"))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        narrow = sum(b < 32 for b in formats.values())
        assert counts["truncate"] == counts["convert"] == narrow
        assert got.device.type == "cuda"
        _check_close(name, got.cpu().numpy(),
                     qk["cpu"].run(formats, *_torch_args(arrays)).numpy(),
                     width or 32)


def test_cuda_quantized_kernel_refuses_float64(cuda):
    """A dtype B8 refuses on the card raises; it is not sent to the plain
    version."""
    x = torch.rand(N, N, dtype=torch.float64)
    qk = QuantizedKernel(lambda a: a * 2.0 + 1.0, x, device="cuda")
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        qk.run({0: 16}, x)


def test_cuda_compress_kernel_matches_cpu(cuda):
    arrays = _inputs("Hotspot")
    res = {d: compress_kernel("Hotspot", hotspot,
                              [_torch_args(arrays, d)], HIGH["deviation"],
                              device=d) for d in ("cuda", "cpu")}
    assert res["cuda"] == res["cpu"]
    assert res["cuda"].allocation.table_words() == \
        res["cpu"].allocation.table_words()


def test_entry_points_need_the_card_unless_asked():
    """The flow's entry points default to the card: without one they
    raise unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core.allocator import SliceAllocator
    from repro_torch.core.regfile import (PackedRegisterFile,
                                          baseline_register_file)
    args = _torch_args(_inputs("CFD"))
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantizedKernel(cfd, *args)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_kernel("CFD", cfd, [args], HIGH["deviation"])
    alloc = SliceAllocator().allocate([])
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedRegisterFile(alloc)
    with pytest.raises(RuntimeError, match="CUDA"):
        baseline_register_file(4)
    assert PackedRegisterFile(alloc, device="cpu").storage.device.type == \
        "cpu"
