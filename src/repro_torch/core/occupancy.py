"""Occupancy: the paper's Fermi arithmetic, and serving residency.

Port of ``repro.core.occupancy``, both halves:

* **The paper's SM** (Tables 1 and 2, Sections 2 and 6.1): resident
  blocks and warps of a kernel on one Fermi SM from its registers per
  thread, warps per block and shared memory. It reproduces the paper's
  numbers exactly: IMGVF at 52 registers x 32 threads x 10 warps =
  16,640 registers a block -> 1 block -> 10/48 = 20.8% occupancy;
  packed to 29 registers -> 3 blocks -> 62.5%. A model of the paper's
  GPU, not of the card the port runs on.
* **Serving residency** (``decode_residency``): how many sequences' KV
  state fits beside the weights, with an H100 record that is the serving
  engine's default. ``TPU_V5E`` is kept so the planner can be held to
  the reference's numbers.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GPUCoreConfig:
    """Per-SM limits (Table 2, Fermi GTX 480)."""

    registers_per_sm: int = 32768
    max_warps: int = 48
    threads_per_warp: int = 32
    shared_mem_per_sm: int = 48 * 1024
    max_blocks: int = 8                 # Fermi CC 2.0 resident-block limit


FERMI = GPUCoreConfig()


@dataclasses.dataclass(frozen=True)
class OccupancyResult:
    blocks: int
    warps: int
    occupancy: float
    limiter: str                # "registers" | "shared" | "blocks" | "warps"


def occupancy(regs_per_thread: int, warps_per_block: int,
              shared_bytes_per_block: int = 0,
              core: GPUCoreConfig = FERMI) -> OccupancyResult:
    """Resident blocks and warps of a kernel on one SM (CUDA occupancy
    arithmetic)."""
    regs_per_block = regs_per_thread * core.threads_per_warp * warps_per_block
    by_regs = (core.registers_per_sm // regs_per_block if regs_per_block
               else 10**9)
    by_smem = (core.shared_mem_per_sm // shared_bytes_per_block
               if shared_bytes_per_block else 10**9)
    by_warps = core.max_warps // warps_per_block
    blocks = min(by_regs, by_smem, by_warps, core.max_blocks)
    # on a tie the last key written names the limiter, as in the reference
    limiter = {by_regs: "registers", by_smem: "shared", by_warps: "warps",
               core.max_blocks: "blocks"}[blocks]
    warps = blocks * warps_per_block
    return OccupancyResult(blocks=blocks, warps=warps,
                           occupancy=warps / core.max_warps, limiter=limiter)


def ipc_uplift_table1(core: GPUCoreConfig = FERMI) -> dict:
    """Table 1's occupancy rows for IMGVF (52 -> 29 registers)."""
    orig = occupancy(52, 10, core=core)
    packed = occupancy(29, 10, core=core)
    return {
        "original": {"pressure": 52, "occupancy": orig.occupancy,
                     "blocks": orig.blocks},
        "packed": {"pressure": 29, "occupancy": packed.occupancy,
                   "blocks": packed.blocks},
    }


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
