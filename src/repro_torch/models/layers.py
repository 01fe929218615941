"""Shared layers, inference subset: norms, RoPE, MLP, embeddings, linear.

Port of ``repro.models.layers``. Weights arrive as tensors or
``PackedTensor``s and the dispatch is the reference's:

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
  * A packed weight that ``linear``, ``unembed``, ``expert_linear`` or
    ``embed`` cannot hand to a kernel (int-kind leaves, the wrong rank,
    other specs) decodes in full through ``unpack_maybe`` on the CPU,
    where that is the plain version of the kernel. On the card it
    raises: no kernel computes it.
  * Packed norm scales decode through ``unpack_maybe``, as in the
    reference (a materialized decode, no kernel).

The training pieces (custom gradients, ``STWeight``) come with ROADMAP
A13.
"""
from __future__ import annotations

import functools
import re
import warnings

import torch
import torch.nn.functional as F

from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.core.tensor_store import PackedTensor, is_packed
from repro_torch.kernels import ops as kops


def unpack_maybe(w, dtype=None):
    """PackedTensor -> tensor (the materialized decode); tensors pass
    through, cast to ``dtype`` when one is given."""
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


def _record_unfused(op: str, spec: str, w, x: torch.Tensor) -> None:
    """A packed weight off the kernel path: recorded (and warned about,
    for an odd spec) on the CPU, refused on the card."""
    nspec = _normalize_spec(spec)
    reason = "unrecognized_spec" if _fusable(w) else "not_fusable"
    if x.is_cuda:
        raise NotImplementedError(
            f"{op}: packed {w.kind} weight {tuple(w.logical_shape)} at "
            f"{w.bits} bits with spec {nspec!r} has no kernel path on the "
            f"card ({reason})")
    kops.record_fallback(op, spec=nspec, shape=w.logical_shape,
                         bits=w.bits, reason=reason)
    if reason == "unrecognized_spec":
        _warn_unfused_spec(nspec)


def _packed_matmul(x: torch.Tensor, w: PackedTensor,
                   transpose: bool) -> torch.Tensor:
    n = w.logical_shape[0] if transpose else w.logical_shape[1]
    contract = w.logical_shape[1] if transpose else w.logical_shape[0]
    if x.shape[-1] != contract:
        raise ValueError(f"x {tuple(x.shape)} does not contract with "
                         f"{w.logical_shape} (transpose={transpose})")
    return kops.packed_matmul(x, w.data, w.bits, n,
                              transpose=transpose).to(x.dtype)


def linear(x: torch.Tensor, w, spec: str = "...d,df->...f") -> torch.Tensor:
    """einsum against a (possibly packed) weight."""
    if is_packed(w):
        if _fusable(w) and _plain_matmul_spec(spec):
            return _packed_matmul(x, w, transpose=False)
        _record_unfused("linear", spec, w, x)
    return torch.einsum(spec, x, unpack_maybe(w, x.dtype))


def expert_linear(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert matmul ``out[e] = x[e] @ W[e]`` against an expert bank
    (E, K, N), x (E, C, K): the MoE dispatch. A 3-D float packed bank
    (a per-layer slice of the stacked (L, E, K, N) leaf) streams through
    the batched kernel; plain banks einsum."""
    spec = "...ck,...kn->...cn"
    if is_packed(w):
        if _fusable_batched(w):
            e, contract, n = w.logical_shape
            if x.ndim != 3 or x.shape[0] != e or x.shape[-1] != contract:
                raise ValueError(f"x {tuple(x.shape)} is not (E, C, K) for "
                                 f"the bank {w.logical_shape}")
            return kops.packed_matmul_batched(x, w.data, w.bits, n).to(
                x.dtype)
        _record_unfused("expert_linear", spec, w, x)
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
    decodes only those."""
    if is_packed(table):
        if len(table.logical_shape) == 2:
            return table.take(tokens)
        _record_unfused("embed", "", table, tokens)
    return unpack_maybe(table)[tokens.long()]


def unembed(x: torch.Tensor, table_or_head, tied: bool) -> torch.Tensor:
    """Vocabulary projection: a tied (V, D) table packed along D takes
    the kernel's transpose orientation, an untied (D, V) head the
    normal one."""
    spec = "...d,vd->...v" if tied else "...d,dv->...v"
    if is_packed(table_or_head):
        if _fusable(table_or_head):
            return _packed_matmul(x, table_or_head, transpose=tied)
        _record_unfused("unembed", spec, table_or_head, x)
    return torch.einsum(spec, x, unpack_maybe(table_or_head, x.dtype))


def init_dense(gen: torch.Generator, shape, scale=None,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(fan_in), drawn on the generator's
    device in float32 and cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(s).to(dtype)
