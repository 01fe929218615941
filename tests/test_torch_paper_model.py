"""The paper's models in the port against the reference's, exactly.

Occupancy on the Fermi SM (Table 1's chain and a grid of register,
warp and shared-memory counts), the area model and its Volta scaling
(exact integers), and the cycle-level SM model: the same profile must
give the same trace, the same ``SimResult`` and the same IPC sweeps.
These are models of the paper's GPU, host arithmetic in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch.core import area_model, smsim
from repro_torch.core.occupancy import (FERMI, GPUCoreConfig, occupancy,
                                        ipc_uplift_table1)


@pytest.fixture(scope="module")
def mref():
    pytest.importorskip("jax")
    from repro.core import area_model as ref_area
    from repro.core import occupancy as ref_occ
    from repro.core import smsim as ref_smsim
    return {"occupancy": ref_occ, "area": ref_area, "smsim": ref_smsim}


def test_table1_occupancy_chain(mref):
    assert ipc_uplift_table1() == mref["occupancy"].ipc_uplift_table1()
    t = ipc_uplift_table1()
    assert t["original"]["blocks"] == 1 and t["packed"]["blocks"] == 3
    assert t["original"]["occupancy"] == pytest.approx(10 / 48)
    assert t["packed"]["occupancy"] == pytest.approx(30 / 48)


@pytest.mark.parametrize("shared", [0, 2048, 14560, 49152])
def test_occupancy_grid(mref, shared):
    ro = mref["occupancy"]
    for regs in (1, 16, 21, 24, 29, 31, 52, 63):
        for warps in (1, 2, 6, 8, 10, 16, 48):
            got = occupancy(regs, warps, shared)
            want = ro.occupancy(regs, warps, shared)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    core = GPUCoreConfig(registers_per_sm=65536, max_warps=64,
                         max_blocks=32)
    want = ro.occupancy(32, 4, shared, ro.GPUCoreConfig(
        **dataclasses.asdict(core)))
    assert dataclasses.asdict(occupancy(32, 4, shared, core)) == \
        dataclasses.asdict(want)
    assert dataclasses.asdict(FERMI) == dataclasses.asdict(ro.FERMI)


def test_area_model_and_volta(mref):
    ra = mref["area"]
    assert area_model.tve_transistors() == ra.tve_transistors() == 1560
    assert dataclasses.asdict(area_model.fermi_area()) == \
        dataclasses.asdict(ra.fermi_area())
    assert area_model.fermi_area().total_per_sm == \
        ra.fermi_area().total_per_sm
    for sms in (1, 15, 16):
        assert area_model.fermi_total(sms) == ra.fermi_total(sms)
        assert area_model.fermi_fraction(num_sms=sms) == \
            ra.fermi_fraction(num_sms=sms)
    assert area_model.fermi_area(8, 16, 8, 1000) == \
        area_model.AreaBreakdown(
            **dataclasses.asdict(ra.fermi_area(8, 16, 8, 1000)))
    assert area_model.volta_area() == ra.volta_area()


_PROFILES = [dict(name="imgvf", n_instructions=400, frac_mem=0.10,
                  frac_sfu=0.03, dep_distance=4, seed=1),
             dict(name="mem-heavy", n_instructions=200, frac_mem=0.3,
                  frac_sfu=0.1, dep_distance=1, seed=7),
             dict(name="alu", n_instructions=300, frac_mem=0.0,
                  frac_sfu=0.0, dep_distance=8, seed=3)]


@pytest.mark.parametrize("prof", _PROFILES, ids=lambda p: p["name"])
def test_smsim_matches_reference(mref, prof):
    rs = mref["smsim"]
    p, rp = smsim.KernelProfile(**prof), rs.KernelProfile(**prof)
    trace, rtrace = smsim.build_trace(p), rs.build_trace(rp)
    assert trace.n == rtrace.n
    assert np.array_equal(trace.op_class, rtrace.op_class)
    assert np.array_equal(trace.srcs, rtrace.srcs)
    for warps in (3, 24):
        for pipe, rpipe in ((smsim.BASELINE_PIPE, rs.BASELINE_PIPE),
                            (smsim.PROPOSED_PIPE, rs.PROPOSED_PIPE)):
            assert dataclasses.asdict(smsim.simulate(trace, warps, pipe)) \
                == dataclasses.asdict(rs.simulate(rtrace, warps, rpipe))
    assert smsim.ipc_vs_occupancy(p, [4, 12]) == \
        rs.ipc_vs_occupancy(rp, [4, 12])
    assert smsim.writeback_sensitivity(p, 10) == \
        rs.writeback_sensitivity(rp, 10)
