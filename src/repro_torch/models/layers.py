"""Shared layers: norms, RoPE, MLP, embeddings, linear, and the
straight-through training weights.

Port of ``repro.models.layers``. Weights arrive as tensors,
``PackedTensor``s or ``STWeight``s (codes plus a dense master, the
packed-master training mode) and the dispatch is the reference's:

  * ``linear`` / ``unembed`` with a 2-D float ``PackedTensor`` weight go
    through ``kernels.ops.packed_matmul`` when the einsum spec is the
    plain last-axis x first-axis contraction (the tied ``unembed`` takes
    the kernel's transpose orientation); the decoded weight never
    reaches device memory.
  * ``expert_linear`` with a 3-D float ``PackedTensor`` expert bank goes
    through ``kernels.ops.packed_matmul_batched``: one launch for every
    expert, no expert's weights decoded into device memory.
  * ``embed`` with a packed table gathers packed rows and decodes only
    those (``PackedTensor.take`` -> ``kernels.ops.take_rows``).
  * The backward is fused too. Each kernel path is a
    ``torch.autograd.Function`` whose dx re-enters the kernel with the
    orientation flipped (dx = g @ Wᵀ contracts over the packed axis of
    a normal-orientation weight, and vice versa), so the backward
    streams packed words as well; the int32 words get no gradient. An
    ``STWeight`` takes the same kernels forward (``st_linear``, the
    batched ``_FusedBMMST``) and returns dW to its master from the
    residuals alone (``kernels.ops.packed_matmul_dw``), never decoding
    W. Its embedding gathers packed rows forward and scatters the
    gradient into the gathered rows of the master.
  * A packed weight that ``linear``, ``unembed``, ``expert_linear`` or
    ``embed`` cannot hand to a kernel (int-kind leaves, the wrong rank,
    other specs) decodes in full through ``unpack_maybe`` on the CPU,
    where that is the plain version of the kernel. On the card it
    raises ``FusedPathRefused`` (a ``NotImplementedError``): no kernel
    computes it.
  * Packed norm scales (and the conv and recurrent diagonals) decode
    through ``unpack_maybe``, as in the reference (a materialized
    decode, no kernel); an ``STWeight`` one decodes straight through:
    the value from the codes, the gradient to the master.

Every function takes any leading dims of x: (B, 1) when decoding,
(B, T) over a sequence.
"""
from __future__ import annotations

import functools
import re
import warnings

import torch
import torch.nn.functional as F

from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.core.tensor_store import (Draw, PackedTensor, STWeight,
                                           is_packed, is_st)
from repro_torch.kernels import ops as kops


def _st_decode(w: STWeight) -> torch.Tensor:
    """The materialized straight-through decode: the value comes from the
    codes, the gradient flows to the master (``master - master.detach()``
    is zero-valued)."""
    dec = w.packed.unpack()
    return dec + (w.master - w.master.detach()).to(dec.dtype)


def unpack_maybe(w, dtype=None):
    """PackedTensor -> tensor (the materialized decode); ``STWeight`` ->
    the straight-through decode; tensors pass through, cast to ``dtype``
    when one is given."""
    if is_st(w):
        kops.record_dispatch("unpack_maybe", "materialized",
                             shape=w.logical_shape, bits=w.packed.bits)
        x = _st_decode(w)
        return x.to(dtype) if dtype is not None else x
    if is_packed(w):
        kops.record_dispatch("unpack_maybe", "materialized",
                             shape=w.logical_shape, bits=w.bits)
        x = w.unpack()
        return x.to(dtype) if dtype is not None else x
    return w if dtype is None else w.to(dtype)


def _fusable(w) -> bool:
    """True when a weight can take the fused packed-matmul path."""
    return (is_packed(w) and w.kind == "float"
            and len(w.logical_shape) == 2 and w.bits in FLOAT_FORMATS)


def _fusable_batched(w) -> bool:
    """True when a stacked expert bank can take the batched fused path."""
    return (is_packed(w) and w.kind == "float"
            and len(w.logical_shape) == 3 and w.bits in FLOAT_FORMATS)


@functools.lru_cache(maxsize=None)
def _normalize_spec(spec: str) -> str:
    return re.sub(r"\s+", "", spec)


@functools.lru_cache(maxsize=None)
def _plain_matmul_spec(spec: str) -> bool:
    """True for specs of the form ``"...a,ab->...b"`` (a != b): the
    contraction the fused kernel computes."""
    m = re.fullmatch(r"\.\.\.(\w),(\w)(\w)->\.\.\.(\w)",
                     _normalize_spec(spec))
    return (bool(m) and m.group(1) == m.group(2)
            and m.group(3) == m.group(4) and m.group(1) != m.group(3))


@functools.lru_cache(maxsize=None)
def _warn_unfused_spec(spec: str) -> None:
    warnings.warn(
        f"einsum spec {spec!r} against a packed weight is not the plain "
        "last-axis x first-axis contraction; taking the materialized "
        "unpack path", stacklevel=3)


class FusedPathRefused(NotImplementedError):
    """A packed weight that no kernel takes, refused on the card. It
    carries the fields of the fallback record the CPU keeps (``op``,
    ``spec``, ``shape``, ``bits``, ``reason``), so that a caller auditing
    dispatch (``analysis.dispatch``) can record it as one."""

    def __init__(self, op: str, spec: str, shape, bits: int, reason: str,
                 kind: str):
        super().__init__(
            f"{op}: packed {kind} weight {tuple(shape)} at {bits} bits "
            f"with spec {spec!r} has no kernel path on the card ({reason})")
        self.op, self.spec, self.reason = op, spec, reason
        self.shape, self.bits = tuple(shape), bits


def _record_unfused(op: str, spec: str, w, x: torch.Tensor) -> None:
    """A packed weight off the kernel path: recorded (and warned about,
    for an odd spec) on the CPU, refused on the card."""
    nspec = _normalize_spec(spec)
    reason = "unrecognized_spec" if _fusable(w) else "not_fusable"
    if x.is_cuda:
        raise FusedPathRefused(op, nspec, w.logical_shape, w.bits, reason,
                               w.kind)
    kops.record_fallback(op, spec=nspec, shape=w.logical_shape,
                         bits=w.bits, reason=reason)
    if reason == "unrecognized_spec":
        _warn_unfused_spec(nspec)


def _fused_dx(data, bits, k, transpose, g):
    """dx of either orientation through the kernel itself, flipped:
    normal forward (out = x @ W, W (K, N) packed along N): dx = g @ Wᵀ
    contracts over the packed axis, the transposed orientation;
    transposed forward (W (N, K) packed along K): dx = g @ W, the
    normal orientation. W never materializes."""
    return kops.packed_matmul(g, data, bits, k, transpose=not transpose)


class _FusedMM(torch.autograd.Function):
    """x @ decode(W) (or ``transpose``: x @ decode(W)ᵀ) through the
    kernel; dx through the kernel flipped. The packed words get no
    gradient."""

    @staticmethod
    def forward(ctx, x, data, bits, n, transpose):
        ctx.save_for_backward(data)
        ctx.meta = (bits, x.shape[-1], transpose, x.dtype)
        return kops.packed_matmul(x, data, bits, n, transpose=transpose)

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        bits, k, transpose, dt = ctx.meta
        gx = (_fused_dx(data, bits, k, transpose, g).to(dt)
              if ctx.needs_input_grad[0] else None)
        return gx, None, None, None, None


class _FusedMMST(torch.autograd.Function):
    """``_FusedMM`` with a dense master riding along as the handle of
    dW: the forward value comes from the words alone; dW = xᵀ g (gᵀ x
    transposed) from the residuals, never reading W."""

    @staticmethod
    def forward(ctx, x, data, master, bits, n, transpose):
        ctx.save_for_backward(x, data)
        ctx.meta = (bits, transpose, master.dtype)
        return kops.packed_matmul(x, data, bits, n, transpose=transpose)

    @staticmethod
    def backward(ctx, g):
        x, data = ctx.saved_tensors
        bits, transpose, mdt = ctx.meta
        gx = (_fused_dx(data, bits, x.shape[-1], transpose, g).to(x.dtype)
              if ctx.needs_input_grad[0] else None)
        dw = (kops.packed_matmul_dw(x, g, transpose=transpose).to(mdt)
              if ctx.needs_input_grad[2] else None)
        return gx, None, dw, None, None, None


class _FusedBMM(torch.autograd.Function):
    """Per expert x[e] @ decode(W[e]) through the batched kernel; dx[e] =
    g[e] @ W[e]ᵀ through its transposed orientation over the same
    bank."""

    @staticmethod
    def forward(ctx, x, data, bits, n):
        ctx.save_for_backward(data)
        ctx.meta = (bits, x.shape[-1], x.dtype)
        return kops.packed_matmul_batched(x, data, bits, n)

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        bits, k, dt = ctx.meta
        gx = (kops.packed_matmul_batched(g, data, bits, k, transpose=True)
              .to(dt) if ctx.needs_input_grad[0] else None)
        return gx, None, None, None


class _FusedBMMST(torch.autograd.Function):
    """``_FusedBMM`` with a master bank: dW[e] = x[e]ᵀ g[e] per expert
    from the residuals."""

    @staticmethod
    def forward(ctx, x, data, master, bits, n):
        ctx.save_for_backward(x, data)
        ctx.meta = (bits, master.dtype)
        return kops.packed_matmul_batched(x, data, bits, n)

    @staticmethod
    def backward(ctx, g):
        x, data = ctx.saved_tensors
        bits, mdt = ctx.meta
        gx = (kops.packed_matmul_batched(g, data, bits, x.shape[-1],
                                         transpose=True).to(x.dtype)
              if ctx.needs_input_grad[0] else None)
        dw = (kops.packed_matmul_dw(x, g, batched=True).to(mdt)
              if ctx.needs_input_grad[2] else None)
        return gx, None, dw, None, None


def _out_and_contract(w: PackedTensor, transpose: bool, x: torch.Tensor):
    """(output width, contraction width) of ``w`` in an orientation,
    after checking x against the latter."""
    n = w.logical_shape[0] if transpose else w.logical_shape[1]
    contract = w.logical_shape[1] if transpose else w.logical_shape[0]
    if x.shape[-1] != contract:
        raise ValueError(f"x {tuple(x.shape)} does not contract with "
                         f"{w.logical_shape} (transpose={transpose})")
    return n, contract


def _packed_matmul(x: torch.Tensor, w: PackedTensor,
                   transpose: bool) -> torch.Tensor:
    n, _ = _out_and_contract(w, transpose, x)
    return _FusedMM.apply(x, w.data, w.bits, n, transpose).to(x.dtype)


def st_linear(x: torch.Tensor, w: PackedTensor, w_master: torch.Tensor,
              transpose: bool = False, fallback: bool = False
              ) -> torch.Tensor:
    """Straight-through packed training: the forward streams the packed
    weight ``w``, the backward returns dx through the kernel and dW to
    ``w_master``, the dense master (of ``w``'s logical shape; its value
    is unused forward). ``fallback=True`` is the materialized parity
    oracle for both gradients (decode, einsum, the same straight-through
    wiring), on CPU tensors only."""
    if not (is_packed(w) and w.kind == "float"):
        raise ValueError("st_linear needs a float PackedTensor weight")
    if tuple(w_master.shape) != tuple(w.logical_shape):
        raise ValueError(f"master {tuple(w_master.shape)} is not the "
                         f"weight's {w.logical_shape}")
    n, _ = _out_and_contract(w, transpose, x)
    if not fallback:
        return _FusedMMST.apply(x, w.data, w_master, w.bits, n,
                                transpose).to(x.dtype)
    if x.is_cuda:
        raise NotImplementedError("st_linear(fallback=True) is the CPU "
                                  "parity oracle; the card takes the kernels")
    kops.record_dispatch("st_linear", "fallback")
    w_st = (unpack_maybe(w, torch.float32)
            + (w_master - w_master.detach()).float())
    spec = "...k,nk->...n" if transpose else "...k,kn->...n"
    return torch.einsum(spec, x.float(), w_st).to(x.dtype)


def linear(x: torch.Tensor, w, spec: str = "...d,df->...f") -> torch.Tensor:
    """einsum against a (possibly packed, or straight-through) weight."""
    if is_st(w):
        if _fusable(w.packed) and _plain_matmul_spec(spec):
            return st_linear(x, w.packed, w.master)
        _record_unfused("linear", spec, w.packed, x)
    elif is_packed(w):
        if _fusable(w) and _plain_matmul_spec(spec):
            return _packed_matmul(x, w, transpose=False)
        _record_unfused("linear", spec, w, x)
    return torch.einsum(spec, x, unpack_maybe(w, x.dtype))


def expert_linear(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert matmul ``out[e] = x[e] @ W[e]`` against an expert bank
    (E, K, N), x (E, C, K): the MoE dispatch. A 3-D float packed bank
    (a per-layer slice of the stacked (L, E, K, N) leaf) streams through
    the batched kernel, with dW per expert to the master of an
    ``STWeight`` bank; plain banks einsum."""
    spec = "...ck,...kn->...cn"
    pk = w.packed if is_st(w) else w
    if is_packed(pk):
        if _fusable_batched(pk):
            e, contract, n = pk.logical_shape
            if x.ndim != 3 or x.shape[0] != e or x.shape[-1] != contract:
                raise ValueError(f"x {tuple(x.shape)} is not (E, C, K) for "
                                 f"the bank {pk.logical_shape}")
            if is_st(w):
                return _FusedBMMST.apply(x, pk.data, w.master, pk.bits,
                                         n).to(x.dtype)
            return _FusedBMM.apply(x, pk.data, pk.bits, n).to(x.dtype)
        _record_unfused("expert_linear", spec, pk, x)
    return torch.einsum(spec, x, unpack_maybe(w, x.dtype))


def rms_norm(x: torch.Tensor, scale, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + unpack_maybe(scale, torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exponent)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def mlp(x, w_in, w_gate, w_out, gated: bool) -> torch.Tensor:
    """SwiGLU (gated) or GELU MLP; packed weights go through ``linear``."""
    h = linear(x, w_in)
    if gated:
        h = F.silu(linear(x, w_gate)) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return linear(h, w_out, "...f,fd->...d")


def embed(tokens: torch.Tensor, table) -> torch.Tensor:
    """Token embedding; a packed 2-D table gathers packed rows and
    decodes only those. An ``STWeight`` table adds the gathered master
    rows' zero-valued ``m - m.detach()``, so the gradient scatters into
    those rows of the master."""
    if is_st(table) and len(table.logical_shape) == 2:
        rows = table.packed.take(tokens)
        m = table.master[tokens.long()]
        return rows + (m - m.detach()).to(rows.dtype)
    pk = table.packed if is_st(table) else table
    if is_packed(pk):
        if len(pk.logical_shape) == 2:
            return pk.take(tokens)
        _record_unfused("embed", "", pk, tokens)
    return unpack_maybe(table)[tokens.long()]


def unembed(x: torch.Tensor, table_or_head, tied: bool) -> torch.Tensor:
    """Vocabulary projection: a tied (V, D) table packed along D takes
    the kernel's transpose orientation, an untied (D, V) head the
    normal one; an ``STWeight`` head the matching ``st_linear``."""
    spec = "...d,vd->...v" if tied else "...d,dv->...v"
    w = table_or_head
    if is_st(w):
        if _fusable(w.packed):
            return st_linear(x, w.packed, w.master, transpose=tied)
        _record_unfused("unembed", spec, w.packed, x)
    elif is_packed(w):
        if _fusable(w):
            return _packed_matmul(x, w, transpose=tied)
        _record_unfused("unembed", spec, w, x)
    return torch.einsum(spec, x, unpack_maybe(w, x.dtype))


def init_dense(gen: torch.Generator, shape, scale=None,
               dtype: torch.dtype = torch.bfloat16) -> Draw:
    """Normal weights scaled by 1/sqrt(fan_in), to be drawn on the
    generator's device in float32 and cast (a ``Draw``: ``LM.init`` draws
    it whole, a packing engine slice by slice into its packed words)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return Draw(gen, tuple(shape), s, dtype)
