"""Compression plans at tensor granularity.

Port of the deployment half of ``repro.core.compress``: the
``CompressionPlan`` (per-leaf widths, versioned JSON codec),
``uniform_plan`` (one Table 3 width for every float leaf of rank >= 2)
and ``repack`` (re-encode a parameter tree at a plan's widths). The
kernel-granularity flow (range analysis, precision tuning, slice
allocation) stays in the reference for now (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.formats import round_bits_to_slice
from repro_torch.core.tensor_store import (is_packed, pack_tensor,
                                           repack_tensor, tree_map_with_path)


@dataclasses.dataclass
class CompressionPlan:
    """Per-tensor widths consumed by the packed store.

    ``float_bits``: leaf-path string -> Table 3 width.
    ``int_bits``:   leaf-path string -> (bits, signed).
    ``kv_bits``:    ``"kv/layer_{i}"`` -> KV-cache width for that layer.
    """

    float_bits: Dict[str, int]
    int_bits: Dict[str, Tuple[int, bool]]
    tune_evals: int = 0
    kv_bits: Dict[str, int] = dataclasses.field(default_factory=dict)

    def bits_of(self, path: Tuple[Any, ...], leaf):
        """A bare width for floats, ``(width, signed)`` for ints, or
        ``None`` to leave the leaf unpacked."""
        key = path_str(path)
        if key in self.float_bits:
            return self.float_bits[key]
        if key in self.int_bits:
            bits, signed = self.int_bits[key]
            return round_bits_to_slice(bits), signed
        return None

    # -- JSON codec (schema v1, the reference's file format) --------------
    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "float_bits": {k: int(v) for k, v in
                           sorted(self.float_bits.items())},
            "int_bits": {k: [int(b), bool(s)] for k, (b, s) in
                         sorted(self.int_bits.items())},
            "tune_evals": int(self.tune_evals),
            "kv_bits": {k: int(v) for k, v in sorted(self.kv_bits.items())},
        }

    @classmethod
    def from_jsonable(cls, obj: Dict[str, Any]) -> "CompressionPlan":
        version = obj.get("version", 1)
        if version != 1:
            raise ValueError(f"unknown CompressionPlan schema v{version}")
        return cls(
            float_bits={k: int(v) for k, v in
                        obj.get("float_bits", {}).items()},
            int_bits={k: (int(v[0]), bool(v[1])) for k, v in
                      obj.get("int_bits", {}).items()},
            tune_evals=int(obj.get("tune_evals", 0)),
            kv_bits={k: int(v) for k, v in obj.get("kv_bits", {}).items()},
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_jsonable(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CompressionPlan":
        with open(path) as f:
            return cls.from_jsonable(json.load(f))


def path_str(path: Tuple[Any, ...]) -> str:
    return "/".join(str(p) for p in path)


def uniform_plan(tree: Any, bits: int, min_ndim: int = 2) -> CompressionPlan:
    """One Table 3 width for every float leaf with ``ndim >= min_ndim``
    (matmul weights, embedding tables and the layer-stacked (L, d) norm
    scales, which decode on the materialized path); 1-D leaves stay at
    the compute dtype."""
    float_bits: Dict[str, int] = {}
    if bits is None or bits >= 32:
        return CompressionPlan(float_bits={}, int_bits={})

    def visit(path, leaf):
        if is_packed(leaf):
            if leaf.kind == "float":
                float_bits[path_str(path)] = bits
        elif (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
              and leaf.ndim >= min_ndim):
            float_bits[path_str(path)] = bits
        return leaf

    tree_map_with_path(visit, tree)
    return CompressionPlan(float_bits=float_bits, int_bits={})


def repack(tree: Any, plan: CompressionPlan) -> Any:
    """Re-encode a (partially packed) tree at ``plan``'s widths: packed
    leaves re-encode value by value (the same object at an unchanged
    width), plain leaves the plan names are packed, the rest pass
    through."""

    def one(path, leaf):
        spec = plan.bits_of(path, leaf)
        if spec is None:
            return leaf
        bits, signed = spec if isinstance(spec, tuple) else (spec, True)
        if is_packed(leaf):
            return repack_tensor(leaf, bits)
        if bits is None or bits >= 32:
            return leaf
        return pack_tensor(leaf, bits, signed=signed)

    return tree_map_with_path(one, tree)
