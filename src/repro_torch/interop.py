"""Parameters from numpy: how the reference's weights reach the port.

``params_from_numpy(tree)`` takes a nested dict whose leaves are numpy
arrays, or per-leaf dicts ``{data, bits, kind, signed, logical_shape,
out_dtype}`` for packed leaves, and builds the port's parameters. uint32
words are reinterpreted as int32 bit for bit; bfloat16 arrays (numpy's
``bfloat16`` extension dtype) keep their bits. The caller walks the
reference's tree into this form, so the port never sees a JAX type.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

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
