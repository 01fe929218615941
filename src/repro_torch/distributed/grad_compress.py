"""Error-feedback gradient compression: the per-leaf half.

Port of ``apply_error_feedback`` and ``init_error_feedback`` from
``repro.distributed.grad_compress``: each gradient leaf plus its f32
residual is quantized to the Table 3 width (an encode then a decode,
through ``kernels.ops.pack`` and ``kernels.ops.unpack``: the kernels on
the card, their plain versions on the CPU, bit for bit the reference's
``decode_float(encode_float(.))``), and what quantization dropped
becomes the next residual. The ring reduce that would carry the codes
between replicas is ROADMAP A15.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.tensor_store import tree_map_with_path
from repro_torch.kernels import ops as kops


def _qdq(x: torch.Tensor, bits: int) -> torch.Tensor:
    """f32 ``x`` rounded to ``bits`` and back (any shape), f32."""
    flat = x.reshape(-1, x.shape[-1]) if x.ndim else x.reshape(1, 1)
    out = kops.unpack(kops.pack(flat, bits), bits, flat.shape[-1])
    return out.reshape(x.shape)


def apply_error_feedback(grads: Any, residual: Any, bits: Optional[int]
                         ) -> Tuple[Any, Any]:
    """g' = g + residual; residual' = g' - qdq(g'), per leaf in f32; the
    quantized gradient comes back in g's dtype. No-op without ``bits``
    (or at 32)."""
    if not bits or bits >= 32:
        return grads, residual
    new_residual = {}

    def leaf(path, g, r):
        gf = g.float() + r
        q = _qdq(gf, bits)
        new_residual[path] = gf - q
        return q.to(g.dtype)

    out = tree_map_with_path(leaf, grads, residual)
    return out, tree_map_with_path(lambda path, _: new_residual[path], grads)


def init_error_feedback(params: Any) -> Any:
    """A zero f32 residual per leaf."""
    return tree_map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params)
