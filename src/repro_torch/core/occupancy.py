"""Serving residency: how many sequences' KV state fits beside the weights.

Port of the chip half of ``repro.core.occupancy`` (``decode_residency``),
with an H100 record that is the serving engine's default. ``TPU_V5E`` is
kept so the planner can be held to the reference's numbers.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    """Device memory and peak rates of one accelerator."""

    hbm_bytes: int
    peak_flops_bf16: float
    hbm_bw: float
    ici_bw_per_link: float


# NVIDIA H100 SXM data sheet: 80 GB at 3.35 TB/s, 989 TFLOP/s dense bf16,
# NVLink 450 GB/s each way
H100 = ChipConfig(hbm_bytes=80 * 1024**3, peak_flops_bf16=989e12,
                  hbm_bw=3.35e12, ici_bw_per_link=450e9)
# the reference's planner record
TPU_V5E = ChipConfig(hbm_bytes=16 * 1024**3, peak_flops_bf16=197e12,
                     hbm_bw=819e9, ici_bw_per_link=50e9)


@dataclasses.dataclass(frozen=True)
class ResidencyResult:
    max_sequences: int
    kv_bytes_per_seq: int
    weight_bytes: int
    occupancy: float                    # vs. a reference capacity
    arithmetic_intensity: float         # decode flops / byte moved


def decode_residency(weight_bytes: int, kv_bytes_per_token: int,
                     seq_len: int, chip: ChipConfig = H100,
                     reserve_fraction: float = 0.10,
                     reference_sequences=None,
                     flops_per_token=None) -> ResidencyResult:
    """Sequences that fit in device memory beside the weights, and the
    decode arithmetic intensity at that batch."""
    usable = int(chip.hbm_bytes * (1 - reserve_fraction)) - weight_bytes
    kv_per_seq = kv_bytes_per_token * seq_len
    max_seqs = max(usable // max(kv_per_seq, 1), 0)
    ref = reference_sequences or max_seqs or 1
    fpt = flops_per_token if flops_per_token is not None else 2.0 * weight_bytes
    bytes_per_step = weight_bytes + max_seqs * kv_per_seq
    return ResidencyResult(
        max_sequences=max_seqs,
        kv_bytes_per_seq=kv_per_seq,
        weight_bytes=weight_bytes,
        occupancy=max_seqs / ref,
        arithmetic_intensity=max_seqs * fpt / max(bytes_per_step, 1),
    )
