"""A cycle-level streaming-multiprocessor model (the GPGPU-Sim analogue).

Port of ``repro.core.smsim``, host numpy: the same ``KernelProfile``
gives the same trace and the same ``SimResult``. The paper evaluates its
register file inside GPGPU-Sim (Section 5.1); this model stands in for
it in the Table 1 / Fig. 11 / Fig. 12 arithmetic. Its IPC is a model of
the paper's Fermi SM, not a measurement of the card the port runs on. It
models the structures the paper's results hinge on:

  * in-order warps with a **scoreboard** (no forwarding: the stated cause
    of the Fig. 12 writeback sensitivity),
  * two GTO (greedy-then-oldest) warp schedulers issuing to 2 SPUs,
    1 SFU and 1 LD/ST unit (Section 3.1),
  * an operand-collector read path whose latency grows by two stages with
    the proposed design (indirection lookup + value conversion, Fig. 6),
  * a configurable **writeback delay** added to every instruction's
    completion (Section 6.3 models 3 cycles pessimistically; the
    sensitivity sweep uses 0/2/4/8).

Kernels are synthetic instruction traces drawn from a per-kernel mix
(fractions of memory/SFU instructions, dependency distance) so occupancy
effects — more warps hide more latency — emerge from the model rather
than being asserted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# Fermi-ish latencies (cycles). Arithmetic pipeline depth ~18 on Fermi;
# L1 hit ~30, memory several hundred (Volkov 2016).
LATENCY = {"alu": 18, "sfu": 32, "mem": 440}
UNITS = {"alu": 2, "sfu": 1, "mem": 1}          # issue ports per class
NUM_SCHEDULERS = 2
NUM_ARCH_REGS = 64


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """Synthetic trace parameters for one kernel."""

    name: str
    n_instructions: int = 2000
    frac_mem: float = 0.12
    frac_sfu: float = 0.05
    dep_distance: int = 3            # mean distance to producing instr
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Trace:
    op_class: np.ndarray             # int8: 0=alu 1=sfu 2=mem
    srcs: np.ndarray                 # (n, 2) producing instruction index or -1
    n: int


def build_trace(p: KernelProfile) -> Trace:
    rng = np.random.default_rng(p.seed)
    r = rng.random(p.n_instructions)
    op = np.zeros(p.n_instructions, np.int8)
    op[r < p.frac_sfu] = 1
    op[(r >= p.frac_sfu) & (r < p.frac_sfu + p.frac_mem)] = 2
    # Each instruction depends on up to two earlier ones, geometrically
    # distributed distance (short distances = tight dependency chains).
    dist = rng.geometric(1.0 / max(p.dep_distance, 1), (p.n_instructions, 2))
    idx = np.arange(p.n_instructions)[:, None] - dist
    idx[idx < 0] = -1
    return Trace(op_class=op, srcs=idx, n=p.n_instructions)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Read/write path timing knobs (baseline vs. proposed RF)."""

    name: str = "baseline"
    collect_extra: int = 0           # extra operand-collect stages (Fig. 6)
    writeback_delay: int = 0         # extra completion cycles (Section 6.3)


BASELINE_PIPE = PipelineConfig("baseline", 0, 0)
# Proposed: +2 read stages (indirection lookup, value convert) and the
# pessimistic 3-cycle writeback of Section 6.3.
PROPOSED_PIPE = PipelineConfig("proposed", 2, 3)


@dataclasses.dataclass
class SimResult:
    ipc: float
    cycles: int
    instructions: int
    issue_stall_frac: float


def simulate(
    trace: Trace,
    num_warps: int,
    pipe: PipelineConfig = BASELINE_PIPE,
    max_cycles: int = 2_000_000,
) -> SimResult:
    """Run ``num_warps`` copies of ``trace`` on one SM; return IPC."""
    n = trace.n
    pc = np.zeros(num_warps, np.int64)
    # completion cycle of every instruction in every warp (scoreboard)
    done = np.full((num_warps, n + 1), -1, np.int64)  # [-1] = no dep
    last_issued = 0                   # GTO: sticky warp per scheduler
    greedy = np.zeros(NUM_SCHEDULERS, np.int64)

    cycle = 0
    issued_total = 0
    stall_cycles = 0
    lat = np.array([LATENCY["alu"], LATENCY["sfu"], LATENCY["mem"]])

    while np.any(pc < n) and cycle < max_cycles:
        ports = {"alu": UNITS["alu"], "sfu": UNITS["sfu"], "mem": UNITS["mem"]}
        port_of = {0: "alu", 1: "sfu", 2: "mem"}
        issued_this_cycle = 0
        used_warps: set = set()

        # Which warps have their next instruction's dependencies satisfied?
        cur = np.minimum(pc, n - 1)
        s0 = trace.srcs[cur, 0]
        s1 = trace.srcs[cur, 1]
        w_idx = np.arange(num_warps)
        dep0 = np.where(s0 >= 0, done[w_idx, s0], -1)
        dep1 = np.where(s1 >= 0, done[w_idx, s1], -1)
        ready = (pc < n) & (dep0 <= cycle) & (dep1 <= cycle)
        # the operand-collect stage occupies the instruction until deps +
        # collect latency have elapsed; fold collect_extra into readiness.
        if pipe.collect_extra:
            ready &= (np.maximum(dep0, dep1) + pipe.collect_extra) <= cycle

        for sched in range(NUM_SCHEDULERS):
            # Greedy-then-oldest: stay on the last warp while it issues.
            order: List[int] = []
            g = int(greedy[sched])
            if g < num_warps:
                order.append(g)
            order += [w for w in range(num_warps) if w != g]
            for w in order:
                if w in used_warps or not ready[w]:
                    continue
                op = int(trace.op_class[int(pc[w])])
                port = port_of[op]
                if ports[port] == 0:
                    continue
                ports[port] -= 1
                used_warps.add(w)
                greedy[sched] = w
                finish = (
                    cycle
                    + pipe.collect_extra
                    + int(lat[op])
                    + pipe.writeback_delay
                )
                done[w, int(pc[w])] = finish
                pc[w] += 1
                issued_total += 1
                issued_this_cycle += 1
                break                 # one issue per scheduler per cycle

        if issued_this_cycle == 0:
            stall_cycles += 1
            # fast-forward to the next completion to keep sim cheap
            pending = done[done > cycle]
            if pending.size:
                skip = int(pending.min()) - cycle - 1
                if skip > 0:
                    cycle += skip
                    stall_cycles += skip
        cycle += 1

    ipc_scale = 32                    # warp instruction = 32 thread instrs
    return SimResult(
        ipc=issued_total * ipc_scale / max(cycle, 1),
        cycles=cycle,
        instructions=issued_total,
        issue_stall_frac=stall_cycles / max(cycle, 1),
    )


def ipc_vs_occupancy(
    profile: KernelProfile,
    warp_counts: List[int],
    pipe: PipelineConfig = BASELINE_PIPE,
) -> Dict[int, float]:
    trace = build_trace(profile)
    return {w: simulate(trace, w, pipe).ipc for w in warp_counts}


def writeback_sensitivity(
    profile: KernelProfile,
    num_warps: int,
    delays: Tuple[int, ...] = (0, 2, 4, 8),
) -> Dict[int, float]:
    """Fig. 12: IPC vs. writeback delay at fixed occupancy."""
    trace = build_trace(profile)
    out = {}
    for d in delays:
        pipe = PipelineConfig(f"wb{d}", collect_extra=2, writeback_delay=d)
        out[d] = simulate(trace, num_warps, pipe).ipc
    return out
