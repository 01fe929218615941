"""How the reference's values reach the port: parameters from numpy, and
the kernel flow's records from plain fields.

``params_from_numpy(tree)`` takes a nested dict whose leaves are numpy
arrays, or per-leaf dicts ``{data, bits, kind, signed, logical_shape,
out_dtype}`` for packed leaves, and builds the port's parameters. uint32
words are reinterpreted as int32 bit for bit; bfloat16 arrays (numpy's
``bfloat16`` extension dtype) keep their bits. The caller walks the
reference's tree into this form, so the port never sees a JAX type.

``operand_from_fields``, ``entry_from_fields``, ``allocation_from_fields``
and ``kernel_compression_from_fields`` build the port's ``Operand``,
``IndirectionEntry``, ``Allocation`` and ``KernelCompression`` from the
reference's as plain Python values (``dataclasses.asdict`` of them), so
that a comparison is field by field.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core.allocator import Allocation, IndirectionEntry, Operand
from repro_torch.core.compress import KernelCompression
from repro_torch.core.tensor_store import PackedTensor
from repro_torch.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32}

PACKED_KEYS = frozenset({"data", "bits", "kind", "signed", "logical_shape",
                         "out_dtype"})


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree: Any,
                      device: Optional[Union[str, torch.device]] = None) -> Any:
    dev = resolve_device(device)
    if isinstance(tree, dict) and set(tree) == PACKED_KEYS:
        return PackedTensor(
            data=tensor_from_numpy(np.asarray(tree["data"]), dev),
            bits=int(tree["bits"]), kind=str(tree["kind"]),
            signed=bool(tree["signed"]),
            logical_shape=tuple(int(s) for s in tree["logical_shape"]),
            out_dtype=_DTYPES[str(tree["out_dtype"])])
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), dev)


def operand_from_fields(f: Mapping[str, Any]) -> Operand:
    return Operand(name=str(f["name"]), bits=int(f["bits"]),
                   is_float=bool(f["is_float"]), signed=bool(f["signed"]),
                   start=int(f["start"]), end=int(f["end"]))


def entry_from_fields(f: Mapping[str, Any]) -> IndirectionEntry:
    return IndirectionEntry(
        name=str(f["name"]), reg0=int(f["reg0"]), mask0=int(f["mask0"]),
        reg1=int(f["reg1"]), mask1=int(f["mask1"]),
        is_float=bool(f["is_float"]), signed=bool(f["signed"]),
        bits=int(f["bits"]))


def allocation_from_fields(f: Mapping[str, Any]) -> Allocation:
    """The entries keep the order of ``f["entries"]`` (the table's)."""
    return Allocation(
        entries={str(k): entry_from_fields(v)
                 for k, v in f["entries"].items()},
        **{k: int(f[k]) for k in ("register_pressure", "registers_used",
                                  "total_slices", "baseline_pressure",
                                  "split_count")})


def kernel_compression_from_fields(f: Mapping[str, Any]) -> KernelCompression:
    return KernelCompression(
        name=str(f["name"]),
        allocation=allocation_from_fields(f["allocation"]),
        baseline_pressure=int(f["baseline_pressure"]),
        packed_pressure=int(f["packed_pressure"]),
        float_formats={int(k): int(v) for k, v in f["float_formats"].items()},
        int_bits={str(k): (int(b), bool(s))
                  for k, (b, s) in f["int_bits"].items()},
        tune_evals=int(f["tune_evals"]),
        operands=[operand_from_fields(o) for o in f["operands"]])
