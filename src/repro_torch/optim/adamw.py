"""AdamW with statically compressed optimizer state, and the
packed-master re-encode.

Port of ``repro.optim.adamw``. The moments of every leaf of rank >= 2
rest packed along the last axis at ``m_bits`` / ``v_bits`` (AF16 by
default; the second moment as sqrt(v), whose exponent range AF16
holds), decoded at the top of the update through ``kernels.ops.unpack``
and re-encoded through ``kernels.ops.pack``: the CUDA kernels on the
card, their plain versions on the CPU. Vectors and scalars keep f32
moments. The masters re-encode to codes through ``pack_tensor``
(``ops.pack`` again), and ``packed_staleness`` decodes codes through
``ops.unpack``.

Unlike the reference, which returns new trees, ``adamw_update`` updates
the parameters and moments in place, leaf by leaf under
``torch.no_grad()``, and a leaf of more than ``REPACK_CHUNK`` values
goes through in row chunks (``row_chunks``), so its f32 temporaries
never exist whole (an 8B model's 622M-value embedding table would
otherwise take ~2.5 GB for each). The arithmetic is the reference's,
element by element, in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tensor_store import (REPACK_CHUNK, is_packed,
                                           pack_tensor, tree_leaves,
                                           tree_map_with_path)
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    m_bits: Optional[int] = None       # Table 3 width for the 1st moment
    v_bits: Optional[int] = None       # ... 2nd moment


def cosine_schedule(step: int, base_lr: float, warmup: int,
                    total: int) -> float:
    """Linear warm-up then cosine decay, in float32 as the reference's
    jnp computes it; returned as a Python float (exactly that f32)."""
    f32 = np.float32
    if step < warmup:
        return float(f32(base_lr) * f32(step + 1) / f32(max(warmup, 1)))
    t = np.clip(f32(step - warmup) / f32(max(total - warmup, 1)),
                f32(0.0), f32(1.0))
    return float(f32(base_lr * 0.5) * (f32(1.0) + np.cos(f32(np.pi) * t)))


def _packs(bits: Optional[int], shape) -> bool:
    return bool(bits) and bits < 32 and len(shape) >= 2


def row_chunks(shape: Tuple[int, ...]) -> List[slice]:
    """Row ranges of a leaf viewed as (rows, last axis) that the update,
    the staleness probe and the error feedback take at a time: one range
    for a leaf of at most ``REPACK_CHUNK`` values, else ranges of about
    that many. Every packed-moment leaf costs one ``unpack`` and one
    ``pack`` launch per range and moment."""
    n = shape[-1] if shape else 1
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    if rows * n <= REPACK_CHUNK:
        return [slice(0, rows)]
    step = max(1, REPACK_CHUNK // n)
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as (rows, last axis), a view (the update writes through it)."""
    return t.view(-1, t.shape[-1]) if t.ndim else t.view(1, 1)


def _zeros_moment(p: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return kops.pack(z, bits) if _packs(bits, p.shape) else z


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments (packed where ``_packs``; ``v`` holds sqrt(v) when
    packed) and a zero step count."""
    return {
        "m": tree_map_with_path(lambda _, p: _zeros_moment(p, cfg.m_bits),
                                params),
        "v": tree_map_with_path(lambda _, p: _zeros_moment(p, cfg.v_bits),
                                params),
        "count": torch.zeros((), dtype=torch.int32),
    }


def _decode(pk: torch.Tensor, bits: Optional[int], shape, n: int):
    return kops.unpack(pk, bits, n) if _packs(bits, shape) else pk


def _encode(x: torch.Tensor, bits: Optional[int], shape):
    return kops.pack(x, bits) if _packs(bits, shape) else x


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 cfg: AdamWConfig, lr: Optional[float] = None
                 ) -> Tuple[Any, Dict[str, Any]]:
    """Global-norm clip + AdamW, in place: ``params`` and the moments of
    ``opt_state`` are updated and returned. ``grads`` mirrors
    ``params`` (a None leaf counts as zeros)."""
    count = int(opt_state["count"]) + 1
    lr = cfg.lr if lr is None else lr
    flat_p = list(tree_leaves(params))
    flat_g = list(tree_leaves(grads))
    flat_m = list(tree_leaves(opt_state["m"]))
    flat_v = list(tree_leaves(opt_state["v"]))
    assert len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v)
    sq = [g.float().square().sum() for g in flat_g if g is not None]
    gnorm = torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0).float()
    f32 = np.float32
    b1c = float(f32(1.0) - f32(cfg.b1) ** f32(count))
    b2c = float(f32(1.0) - f32(cfg.b2) ** f32(count))
    v_sqrt = bool(cfg.v_bits) and cfg.v_bits < 32

    for p, g, m_pk, v_pk in zip(flat_p, flat_g, flat_m, flat_v):
        shape, n = tuple(p.shape), (p.shape[-1] if p.ndim else 1)
        s = scale.to(p.device)
        p2, m2, v2 = _rows(p), _rows(m_pk), _rows(v_pk)
        g2 = _rows(g) if g is not None else None
        for rs in row_chunks(shape):
            gf = (g2[rs].float() * s if g2 is not None
                  else torch.zeros(p2[rs].shape, device=p.device))
            m = _decode(m2[rs], cfg.m_bits, shape, n)
            v = _decode(v2[rs], cfg.v_bits, shape, n)
            if v_sqrt:
                v = v * v                       # stored as sqrt(v)
            m = cfg.b1 * m + (1.0 - cfg.b1) * gf
            v = cfg.b2 * v + (1.0 - cfg.b2) * gf * gf
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            pf = p2[rs].float()
            pf = pf - lr * (step + cfg.weight_decay * pf)
            p2[rs] = pf.to(p.dtype)
            m2[rs] = _encode(m, cfg.m_bits, shape)
            v2[rs] = _encode(torch.sqrt(v) if v_sqrt else v, cfg.v_bits,
                             shape)
    opt_state["count"] = torch.tensor(count, dtype=torch.int32)
    return params, opt_state


# ---------------------------------------------------------------------------
# Packed-master training: the codes <-> masters re-encode step
# ---------------------------------------------------------------------------

@torch.no_grad()
def repack_params(packed: Any, masters: Any) -> Any:
    """Re-encode every planned leaf of ``packed`` from its master at the
    leaf's width (``pack_tensor``, through ``kernels.ops.pack``); the
    unplanned leaves mirror the masters as copies. Returns a new tree."""
    def one(_, pk, m):
        if is_packed(pk):
            return pack_tensor(m.detach(), pk.bits, kind=pk.kind,
                               signed=pk.signed, out_dtype=pk.out_dtype)
        return m.detach().clone()

    return tree_map_with_path(one, packed, masters)


@torch.no_grad()
def packed_staleness(packed: Any, masters: Any) -> float:
    """Max |decode(stored codes) - decode(encode(master))| over the
    planned float leaves, in f32: 0.0 right after a repack, growing
    between repacks. The codes decode through ``kernels.ops.unpack``,
    the fresh encode through ``kernels.ops.pack``, in ``row_chunks``."""
    worst = []

    def one(_, pk, m):
        if not is_packed(pk) or pk.kind != "float":
            return
        m, cur, n = _rows(m.detach()), _rows(pk.data), pk.logical_shape[-1]
        for rs in row_chunks(tuple(pk.logical_shape)):
            fresh = kops.unpack(kops.pack(m[rs].float(), pk.bits), pk.bits,
                                n, pk.out_dtype)
            now = kops.unpack(cur[rs], pk.bits, n, pk.out_dtype)
            worst.append((now.float() - fresh.float()).abs().max())

    tree_map_with_path(one, packed, masters)
    return float(torch.stack(worst).max()) if worst else 0.0
