"""PackedTensor: a tensor stored as narrow codes in group-of-32 words.

Port of ``repro.core.tensor_store``. A ``PackedTensor`` holds a logical
float or integer tensor packed along its last axis at a fixed width, its
words in an int32 tensor. An ``STWeight`` pairs one with its dense
master for packed-master training; a ``Draw`` is a random leaf not
drawn yet. Parameter trees are nested dicts (and lists or tuples) whose
leaves are tensors, ``PackedTensor``s, ``STWeight``s or ``Draw``s; the
small tree helpers here take the place of JAX's pytree utilities and
treat each of those as one leaf.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import bitpack
from repro_torch.core.formats import decode_int, encode_int


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
        n = self.logical_shape[-1]
        if self.kind == "float":
            out = bitpack.unpack_floats(self.data, self.bits, n)
        else:
            out = decode_int(bitpack.unpack_groups(self.data, self.bits, n),
                             self.bits, self.signed)
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


@dataclasses.dataclass
class STWeight:
    """A straight-through training weight: packed codes + dense master.

    The forward computes from ``packed`` (the deployed codes, what
    serving streams); gradients flow to ``master``, the dense copy the
    optimizer owns. ``models.layers`` dispatches it wherever a weight
    can appear: the kernel paths through ``torch.autograd.Function``s
    whose dW comes from residuals alone, the materialized paths (norms,
    the conv and the recurrent diagonals) through the straight-through
    decode ``unpack(packed) + (master - master.detach())``."""

    packed: PackedTensor
    master: torch.Tensor

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return self.packed.logical_shape

    def layer(self, i: int) -> "STWeight":
        """Slice ``i`` of the leading axis; the master's slice is a
        differentiable view, so a layer's gradient reaches the stack."""
        return STWeight(self.packed.layer(i), self.master[i])

    def to(self, device) -> "STWeight":
        return STWeight(self.packed.to(device), self.master.to(device))


def is_st(x) -> bool:
    return isinstance(x, STWeight)


def st_tree(packed_tree: Any, master_tree: Any) -> Any:
    """Zip a (partially) packed tree with its dense masters: every
    ``PackedTensor`` leaf pairs into an ``STWeight``; unplanned leaves
    come from the master tree (the packed tree's dense mirrors are
    carried only so the two trees stay congruent)."""
    return tree_map_with_path(
        lambda _, pk, m: STWeight(pk, m) if is_packed(pk) else m,
        packed_tree, master_tree)


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


@dataclasses.dataclass(frozen=True)
class Draw:
    """A normal leaf not drawn yet (``models.layers.init_dense``):
    N(0, scale^2) values of ``shape`` from ``gen``, drawn in float32 and
    cast to ``dtype``. ``draw`` makes it whole (``LM.init``);
    ``draw_packed`` makes it one slice of its last two axes at a time (a
    stacked leaf's layer, a bank's expert of a layer), each packed
    straight into the leaf's words, so the dense leaf never exists
    (``core.compress.repack`` of ``LM.init_lazy``'s tree). The two
    consume the generator differently: the same distribution, not the
    same numbers."""

    gen: torch.Generator
    shape: Tuple[int, ...]
    scale: float
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def draw(self) -> torch.Tensor:
        w = torch.randn(self.shape, generator=self.gen,
                        device=self.gen.device, dtype=torch.float32)
        return w.mul_(self.scale).to(self.dtype)

    def draw_packed(self, bits: int) -> PackedTensor:
        if self.ndim < 3:
            return pack_tensor(self.draw(), bits)
        part = dataclasses.replace(self, shape=self.shape[-2:])
        words = torch.empty(
            self.shape[:-1] + (bitpack.packed_group_words(self.shape[-1],
                                                          bits),),
            dtype=torch.int32, device=self.gen.device)
        for idx in itertools.product(*map(range, self.shape[:-2])):
            words[idx] = pack_tensor(part.draw(), bits).data
        return PackedTensor(words, bits, "float", True, tuple(self.shape),
                            self.dtype)


def is_draw(x) -> bool:
    return isinstance(x, Draw)


REPACK_CHUNK = 1 << 24   # codes decoded at a time by ``repack_tensor``


def repack_tensor(pt: PackedTensor, bits: int) -> PackedTensor:
    """Re-encode at another width (decode, then encode); the same object
    when the width is unchanged. Rows re-encode a chunk of about
    ``REPACK_CHUNK`` codes at a time, so the decoded f32 copy of a large
    leaf (an 8B model's 7 GB stacked MLP weight) never exists whole."""
    if bits == pt.bits:
        return pt
    n = pt.logical_shape[-1]
    if len(pt.logical_shape) < 2:
        return pack_tensor(pt.unpack(), bits, kind=pt.kind, signed=pt.signed,
                           out_dtype=pt.out_dtype)
    rows = pt.data.reshape(-1, pt.data.shape[-1])
    out = torch.empty((rows.shape[0], bitpack.packed_group_words(n, bits)),
                      dtype=torch.int32, device=rows.device)
    step = max(1, REPACK_CHUNK // n)
    for r0 in range(0, rows.shape[0], step):
        part = PackedTensor(rows[r0:r0 + step], pt.bits, pt.kind, pt.signed,
                            (min(step, rows.shape[0] - r0), n), pt.out_dtype)
        out[r0:r0 + step] = pack_tensor(part.unpack(), bits, kind=pt.kind,
                                        signed=pt.signed).data
    return PackedTensor(out.reshape(pt.data.shape[:-1] + (out.shape[-1],)),
                        bits, pt.kind, pt.signed, tuple(pt.logical_shape),
                        pt.out_dtype)


# ---------------------------------------------------------------------------
# Parameter trees: nested dicts / lists / tuples of tensors and PackedTensors
# ---------------------------------------------------------------------------

def tree_map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                       path: Tuple[Any, ...] = ()) -> Any:
    """``fn(path, leaf, *leaves of rest)`` over ``tree``'s leaves; the
    trees of ``rest`` have ``tree``'s structure (they may hold more
    keys)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


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
    """Every tensor, PackedTensor and STWeight leaf moved to
    ``device``."""
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
