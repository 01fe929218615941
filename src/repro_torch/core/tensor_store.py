"""PackedTensor: a tensor stored as narrow codes in group-of-32 words.

Port of ``repro.core.tensor_store``. A ``PackedTensor`` holds a logical
float or integer tensor packed along its last axis at a fixed width, its
words in an int32 tensor. Parameter trees are nested dicts (and lists or
tuples) whose leaves are tensors or ``PackedTensor``s; the small tree
helpers here take the place of JAX's pytree utilities.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import bitpack
from repro_torch.core.formats import FLOAT_FORMATS, decode_float, decode_int, encode_int


@dataclasses.dataclass
class PackedTensor:
    """A tensor packed along its last axis at ``bits`` per element."""

    data: torch.Tensor               # int32 (..., groups*bits)
    bits: int                        # total bits per element (mult of 4)
    kind: str                        # "float" | "int"
    signed: bool                     # int decode extension mode
    logical_shape: Tuple[int, ...]   # unpacked shape (pack axis last)
    out_dtype: torch.dtype           # dtype returned by unpack()

    def unpack(self) -> torch.Tensor:
        """The materialized decode (Value Extractor + Converter)."""
        codes = bitpack.unpack_groups(self.data, self.bits,
                                      self.logical_shape[-1])
        if self.kind == "float":
            out = decode_float(codes, FLOAT_FORMATS[self.bits])
        else:
            out = decode_int(codes, self.bits, self.signed)
        return out.to(self.out_dtype).reshape(self.logical_shape)

    def take(self, indices: torch.Tensor) -> torch.Tensor:
        """Gather logical rows (axis 0) and decode only those rows — the
        packed ``embed`` path, through ``kernels.ops.take_rows``."""
        if len(self.logical_shape) < 2:
            raise ValueError(
                f"take() needs a leading row axis; shape {self.logical_shape}")
        from repro_torch.kernels import ops as kops

        idx_shape = tuple(indices.shape)
        out = kops.take_rows(self.data, indices.reshape(-1), self.bits,
                             self.logical_shape[-1], kind=self.kind,
                             signed=self.signed, out_dtype=self.out_dtype)
        return out.reshape(idx_shape + tuple(self.logical_shape[1:]))

    def layer(self, i: int) -> "PackedTensor":
        """Slice ``i`` of the leading axis (a stacked (L, ...) leaf's
        layer); the payload slice of a contiguous stack is contiguous."""
        return PackedTensor(self.data[i], self.bits, self.kind, self.signed,
                            tuple(self.logical_shape[1:]), self.out_dtype)

    def to(self, device) -> "PackedTensor":
        return dataclasses.replace(self, data=self.data.to(device))

    @property
    def nbytes_packed(self) -> int:
        return self.data.numel() * 4

    @property
    def nbytes_logical_f32(self) -> int:
        n = 1
        for s in self.logical_shape:
            n *= s
        return n * 4


def is_packed(x) -> bool:
    return isinstance(x, PackedTensor)


# -- the Value Truncator path -------------------------------------------------
def pack_tensor(x: torch.Tensor, bits: int, kind: Optional[str] = None,
                signed: bool = True,
                out_dtype: Optional[torch.dtype] = None) -> PackedTensor:
    """Pack ``x`` along its last axis. Float tensors go through
    ``kernels.ops.pack``: the CUDA kernel for a tensor on the card, the
    plain version on the CPU."""
    from repro_torch.kernels import ops as kops

    if kind is None:
        kind = "float" if x.is_floating_point() else "int"
    out_dtype = out_dtype or x.dtype
    if kind == "float":
        data = kops.pack(x, bits)
    else:
        data = bitpack.pack_groups(encode_int(x, bits, signed), bits)
    return PackedTensor(data=data, bits=bits, kind=kind, signed=signed,
                        logical_shape=tuple(x.shape), out_dtype=out_dtype)


def repack_tensor(pt: PackedTensor, bits: int) -> PackedTensor:
    """Re-encode at another width (decode, then encode); the same object
    when the width is unchanged."""
    if bits == pt.bits:
        return pt
    return pack_tensor(pt.unpack(), bits, kind=pt.kind, signed=pt.signed,
                       out_dtype=pt.out_dtype)


# ---------------------------------------------------------------------------
# Parameter trees: nested dicts / lists / tuples of tensors and PackedTensors
# ---------------------------------------------------------------------------

def tree_map_with_path(fn: Callable[[Tuple[Any, ...], Any], Any], tree: Any,
                       path: Tuple[Any, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_to(tree: Any, device) -> Any:
    """Every tensor and PackedTensor leaf moved to ``device``."""
    return tree_map_with_path(
        lambda _, leaf: leaf.to(device) if hasattr(leaf, "to") else leaf,
        tree)


def _dense_bytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def tree_bytes(tree: Any) -> Tuple[int, int]:
    """(packed_bytes, logical_f32_bytes) over a (partially) packed tree."""
    packed = logical = 0
    for leaf in tree_leaves(tree):
        if is_packed(leaf):
            packed += leaf.nbytes_packed
            logical += leaf.nbytes_logical_f32
        elif isinstance(leaf, torch.Tensor):
            packed += _dense_bytes(leaf)
            logical += leaf.numel() * 4
    return packed, logical


def weight_pass_bytes(tree: Any) -> Dict[str, int]:
    """Bytes of streaming every weight once: ``fused`` (packed leaves as
    stored), ``fused_f32`` (those leaves dense f32), ``analytic`` (the
    bits/32 model per leaf, no group padding) and ``dense`` (plain
    leaves)."""
    fused = fused_f32 = analytic = dense = 0
    for leaf in tree_leaves(tree):
        if is_packed(leaf):
            fused += leaf.nbytes_packed
            fused_f32 += leaf.nbytes_logical_f32
            analytic += leaf.nbytes_logical_f32 * leaf.bits // 32
        elif isinstance(leaf, torch.Tensor):
            dense += _dense_bytes(leaf)
    return {"fused": fused, "fused_f32": fused_f32,
            "analytic": analytic, "dense": dense}
