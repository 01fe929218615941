"""Sharding rules: parameter paths and logical axis names -> mesh specs.

The rules half of ``repro.distributed.sharding``: ``TP_RULES``,
``DATA_AXES``, ``resolve_axes``, ``drop_indivisible``, ``spec_for``,
``_spec_shards`` and ``spec_for_packed``. A spec is a plain tuple with
one entry per dimension: ``None`` (replicated), an axis name, or a tuple
of axis names (a one-name tuple is written as the name, as JAX's
``PartitionSpec`` writes it).

The port has no mesh context yet (distribution is ROADMAP A15), so the
mesh is an explicit argument: ``mesh`` maps each axis name to its size,
in the mesh's order, and ``None`` means no mesh. Outside a mesh every
axis name resolves to ``None``, as the reference's ``resolve_axes``
drops the names the current mesh lacks: every spec is then replicated.

The production mesh axes are ("data", "model") single-pod and ("pod",
"data", "model") multi-pod; data-parallel state shards over ("pod",
"data") jointly. The rules serve TP (replicated weights across DP) and
ZeRO (weights also sharded over DP).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core import bitpack

Spec = Tuple[Any, ...]

DATA_AXES = ("pod", "data")        # DP shards over both when present


def _present(names: Sequence[str], mesh: Mapping[str, int]):
    got = tuple(a for a in names if a in mesh)
    if not got:
        return None
    return got[0] if len(got) == 1 else got


def resolve_axes(axes: Sequence[Any],
                 mesh: Optional[Mapping[str, int]] = None) -> Spec:
    """Translate logical axis entries to a spec valid for ``mesh``:
    "data" expands to ("pod", "data") on multi-pod meshes; axis names
    absent from the mesh drop to None (replicated)."""
    mesh = mesh or {}
    out = []
    for ax in axes:
        if ax is None:
            out.append(None)
        elif ax == "data":
            out.append(_present(DATA_AXES, mesh))
        elif isinstance(ax, (tuple, list)):
            out.append(_present(ax, mesh))
        else:
            out.append(ax if ax in mesh else None)
    return tuple(out)


def _spec_shards(entry, sizes: Mapping[str, int]) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    shards = 1
    for n in names:
        shards *= sizes.get(n, 1)
    return shards


def drop_indivisible(spec: Spec, shape: Tuple[int, ...],
                     axis_sizes: Optional[Mapping[str, int]] = None) -> Spec:
    """Replicate any dimension whose size does not divide its shard
    count; the spec is padded with None to the shape's rank.
    ``axis_sizes`` are the mesh's sizes (none: every count is 1)."""
    sizes = axis_sizes or {}
    out = []
    for dim, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        out.append(ax if shape[dim] % _spec_shards(ax, sizes) == 0 else None)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------
# Pattern -> logical axes per dimension, aligned to the *trailing*
# dimensions of the parameter (so stacked (L, ...) params reuse the rules
# of their unstacked forms; leading unmatched dims are replicated, or
# sharded over DP in zero mode). Packed payloads have the same rank with
# the last axis scaled by bits/32: ``spec_for_packed`` keeps the packed
# axis whole unless the split falls on group boundaries.

TP_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    # attention projections: shard heads/ff over model
    (r"\bwq\b", (None, "model")),          # (d, H*hd)
    (r"\bwk\b", (None, "model")),
    (r"\bwv\b", (None, "model")),
    (r"\bwo\b", ("model", None)),          # (H*hd, d)
    # MLPs: column- then row-parallel
    (r"\bw_in\b|\bw_gate\b", (None, "model")),
    (r"\bw_out\b", ("model", None)),
    # MoE experts: expert-parallel over model
    (r"\bexperts\b.*\b(w_in|w_gate)\b", ("model", None, None)),
    (r"\bexperts\b.*\bw_out\b", ("model", None, None)),
    (r"\brouter\b", (None, None)),
    # embeddings: vocab over model
    (r"\bembed\b", ("model", None)),
    (r"\blm_head\b", (None, "model")),
    # mamba / rglru projections
    (r"\bin_proj\b", (None, "model")),
    (r"\bout_proj\b", ("model", None)),
    (r"\bconv_w\b", ("model", None)),
    (r"\bx_proj\b", ("model", None)),
    (r"\bdt_proj\b", (None, "model")),
    (r"\ba_param\b", ("model", None)),
    (r"\b(dt_bias|conv_b|d_param)\b", ("model",)),
    (r"\brg_(a|wr|wi)\b", ("model",)),
    (r"\brg_(gate_w|in_w)\b", (None, "model")),
    (r"\brg_out\b", ("model", None)),
    # norms / small vectors: replicated
    (r"\b(norm|scale|bias|ln)\w*\b", (None,)),
)


def spec_for(path: str, shape: Tuple[int, ...], mode: str = "tp",
             mesh: Optional[Mapping[str, int]] = None) -> Spec:
    """The spec of a parameter path under ``mode`` ("tp" or "zero") on
    ``mesh``."""
    axes: Optional[Tuple[Any, ...]] = None
    for pat, a in TP_RULES:
        if re.search(pat, path):
            axes = a
            break
    rank = len(shape)
    if axes is None:
        spec = [None] * rank
    else:
        spec = [None] * (rank - len(axes)) + list(axes)[:rank]
    sizes: Dict[str, int] = dict(mesh or {})
    if mode == "zero":
        # ZeRO: additionally shard a free dim over DP, the first dim the
        # DP degree divides (the layer stack when L divides, else e.g.
        # the expert dim: arctic's L=35 doesn't divide 16 but E=128 does)
        dp = 1
        for a in DATA_AXES:
            dp *= sizes.get(a, 1)
        for d in range(rank):
            if spec[d] is None and dp > 1 and shape[d] % dp == 0 \
                    and shape[d] >= dp:
                spec[d] = "data"
                break
    return drop_indivisible(resolve_axes(spec, mesh), shape, sizes)


def spec_for_packed(path: str, logical_shape: Tuple[int, ...],
                    mode: str = "tp",
                    axis_sizes: Optional[Mapping[str, int]] = None,
                    mesh: Optional[Mapping[str, int]] = None) -> Spec:
    """The spec of a packed word array, consistent with the *logical*
    tensor's spec.

    The payload has the logical rank with the last axis rescaled to
    group-of-32 words, so leading dims take the logical rules verbatim.
    The packed (last) axis may shard only when the *logical* axis is a
    multiple of 32 x shard count: an even word split that lands mid-group
    would hand two devices halves of one group's shift/or network (96
    codes at AF16 = 48 words split 2 ways is 24 words each but 1.5
    groups), and a split on a group boundary is still wrong when the last
    group carries padding (48 codes = 2 groups: device 1 would get codes
    32-47 plus the pad, not the 24/24 logical split). Otherwise the axis
    drops to replicated.

    ``axis_sizes`` overrides the mesh's sizes for the group check (the
    lint checks several TP degrees without a mesh)."""
    spec = spec_for(path, logical_shape, mode, mesh)
    rank = len(logical_shape)
    entries = list(spec) + [None] * (rank - len(spec))
    if rank and entries[-1] is not None:
        sizes = axis_sizes if axis_sizes is not None else dict(mesh or {})
        shards = _spec_shards(entries[-1], sizes)
        if shards > 1 and logical_shape[-1] % (bitpack.GROUP * shards):
            entries[-1] = None
    return tuple(entries)
