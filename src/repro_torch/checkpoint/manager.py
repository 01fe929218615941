"""Atomic, asynchronous checkpoints in the reference's layout.

Port of ``repro.checkpoint.manager``. One directory per step:

    ckpt_dir/step_000123.tmp-<nonce>/   # written first
        manifest.json                   # tree skeleton, per-leaf metadata, plan
        arrays.npz                      # one entry per leaf (host arrays)
    ckpt_dir/step_000123/               # os.replace'd into place when complete

  * **Atomic**: a checkpoint is visible once its directory is
    ``os.replace``'d into place; a crash mid-write leaves a ``.tmp-``
    directory, which the next manager removes. ``keep`` bounds the
    steps kept.
  * **Async**: ``save(blocking=False)`` copies every leaf to the host
    before it returns (the trainer updates its tensors in place right
    after) and writes in a background thread; ``wait()`` joins it.
  * **Packed state passes through**: a ``PackedTensor``'s words are one
    entry (uint32, as the reference stores them) and its width, kind,
    signedness, logical shape and output dtype ride in the manifest.
  * **The plan rides in the manifest** (``restore(with_plan=True)``).

The manifest's keys and layout are the reference's (leaves in JAX's
flattening order, dict keys sorted; ``treedef_json`` the skeleton), so
the port reads a directory the reference wrote. A bf16 leaf, which
numpy cannot hold without an extension dtype, is stored as its uint16
bits with ``"dtype": "bfloat16"`` in its manifest entry.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compress import CompressionPlan
from repro_torch.core.tensor_store import PackedTensor, is_packed
from repro_torch.interop import _DTYPES, tensor_from_numpy

_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) in JAX's order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _skeleton(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _rebuild(skel: Any, leaves: Dict[str, Any], path: Tuple[str, ...] = ()):
    if isinstance(skel, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_rebuild(v, leaves, path + (str(i),))
                for i, v in enumerate(skel)]
    return leaves["/".join(path)]


def _host(leaf: Any) -> Any:
    """A host copy that later in-place updates of ``leaf`` do not touch."""
    if is_packed(leaf):
        return dataclasses.replace(leaf, data=_host(leaf.data))
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _to_numpy(t: Any) -> Tuple[np.ndarray, Optional[str]]:
    """(array, dtype name to record) of a host leaf."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t), None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()
        self._thread: Optional[threading.Thread] = None

    # -- public -------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             plan: Optional[CompressionPlan] = None) -> str:
        """Copy ``tree`` to the host now; write it (in a background thread
        unless ``blocking``); return the final directory. ``plan`` rides
        in the manifest."""
        host = [(key, _host(leaf)) for key, leaf in _flatten(tree)]
        skel = _skeleton(tree)
        final = self._step_dir(step)
        if blocking:
            self._write(step, host, skel, final, plan)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, skel, final, plan),
                daemon=True)
            self._thread.start()
        return final

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: Optional[int] = None,
                with_plan: bool = False) -> Tuple:
        """(step, tree of CPU tensors and PackedTensors), or (step, tree,
        plan) with ``with_plan`` (plan None for a run that packed
        nothing). Reads the reference's checkpoints too: its uint32
        words come back as int32 bit for bit."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            for entry in manifest["leaves"]:
                arr = arrays[entry["key"]]
                if entry.get("dtype") == "bfloat16":
                    arr = arr.view(np.int16)
                    t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
                else:
                    t = tensor_from_numpy(arr, torch.device("cpu"))
                if entry.get("packed"):
                    t = PackedTensor(
                        data=t, bits=int(entry["bits"]), kind=entry["kind"],
                        signed=bool(entry["signed"]),
                        logical_shape=tuple(entry["logical_shape"]),
                        out_dtype=_DTYPES[entry["out_dtype"]])
                leaves[entry["key"]] = t
        tree = _rebuild(json.loads(manifest["treedef_json"]), leaves)
        if with_plan:
            plan = manifest.get("plan")
            return step, tree, (None if plan is None
                                else CompressionPlan.from_jsonable(plan))
        return step, tree

    # -- internals ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:06d}")

    def _write(self, step: int, host: List[Tuple[str, Any]], skel: Any,
               final: str, plan: Optional[CompressionPlan]) -> None:
        tmp = tempfile.mkdtemp(prefix=f"step_{step:06d}.tmp-",
                               dir=self.directory)
        leaves_meta, payload = [], {}
        for key, leaf in host:
            meta: Dict[str, Any] = {"key": key, "packed": is_packed(leaf)}
            if is_packed(leaf):
                arr, _ = _to_numpy(leaf.data)
                arr = arr.view(np.uint32)
                meta.update(bits=leaf.bits, kind=leaf.kind,
                            signed=leaf.signed,
                            logical_shape=list(leaf.logical_shape),
                            out_dtype=_DTYPE_NAMES[leaf.out_dtype])
            else:
                arr, dtype = _to_numpy(leaf)
                if dtype:
                    meta["dtype"] = dtype
            payload[key] = arr
            leaves_meta.append(meta)
        manifest = {
            "step": step,
            "leaves": leaves_meta,
            "treedef_json": json.dumps(skel),
            "plan": None if plan is None else plan.to_jsonable(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        np.savez(os.path.join(tmp, "arrays.npz"), **payload)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc_old()

    def _gc_old(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
