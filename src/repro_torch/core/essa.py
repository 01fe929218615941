"""e-SSA range analysis on an explicit CFG (Section 4.2, Fig. 8).

Port of ``repro.core.essa``, host Python over the port's ``Interval``.
An exported ATen graph, like a jaxpr, does not relate branch predicates
to operand ranges, so the paper's branch-refinement step ("Extended
SSA": each conditional splits a variable into a true-copy and a
false-copy with tightened bounds) is reproduced here on a small CFG IR,
following Pereira et al. 2013: convert to e-SSA by inserting sigma nodes
at conditional edges, build range constraints, and solve with the
widen/future/narrow worklist discipline.

``figure8_program()`` builds the paper's running example — a branch on
``k < 50`` producing ``k_t`` ([..,49]) and ``k_f`` ([50,..]) — and the
test suite asserts the per-variable ranges and bitwidths of Fig. 8(c-d).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.range_analysis import (INF, NEG_INF, Interval, _arith2,
                                             _div)


# --- tiny SSA IR ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Const:
    value: int


@dataclasses.dataclass(frozen=True)
class Assign:
    """dst = op(a, b) with op in {const, add, sub, mul, div, phi, copy}."""

    dst: str
    op: str
    a: object = None                 # var name | Const
    b: object = None


@dataclasses.dataclass(frozen=True)
class Branch:
    """if (lhs cmp rhs) goto then_block else else_block; cmp in <,<=,>,>=."""

    lhs: str
    cmp: str
    rhs: object                      # var name | Const
    then_block: str
    else_block: str


@dataclasses.dataclass(frozen=True)
class Jump:
    target: str


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    instrs: Tuple[Assign, ...]
    terminator: object               # Branch | Jump | None (exit)


@dataclasses.dataclass(frozen=True)
class Program:
    blocks: Dict[str, Block]
    entry: str
    inputs: Dict[str, Interval]      # seed ranges (e.g. tid bounds)


# --- e-SSA conversion --------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sigma:
    """dst = sigma(src) constrained by the edge predicate."""

    dst: str
    src: str
    constraint: Interval             # intersect on this edge


def _pred_intervals(cmp: str, bound: Interval) -> Tuple[Interval, Interval]:
    """(true-edge, false-edge) constraint intervals for ``x cmp bound``."""
    if cmp == "<":
        return (Interval(NEG_INF, bound.hi - 1), Interval(bound.lo, INF))
    if cmp == "<=":
        return (Interval(NEG_INF, bound.hi), Interval(bound.lo + 1, INF))
    if cmp == ">":
        return (Interval(bound.lo + 1, INF), Interval(NEG_INF, bound.hi))
    if cmp == ">=":
        return (Interval(bound.lo, INF), Interval(NEG_INF, bound.hi - 1))
    raise ValueError(f"unsupported comparison {cmp!r}")


def to_essa(prog: Program) -> Tuple[Program, Dict[str, str]]:
    """Insert sigma copies on conditional edges (k -> k_t / k_f).

    Returns the transformed program plus a map essa_name -> original name
    used afterwards to merge ranges per Fig. 8(d).
    """
    blocks: Dict[str, Block] = dict(prog.blocks)
    origin: Dict[str, str] = {}
    counter = [0]

    def _fresh(base: str, suffix: str) -> str:
        counter[0] += 1
        name = f"{base}_{suffix}"
        while name in origin:
            name = f"{base}_{suffix}{counter[0]}"
        origin[name] = base.split("_")[0] if base in origin else base
        return name

    for bname in list(blocks):
        blk = blocks[bname]
        term = blk.terminator
        if not isinstance(term, Branch):
            continue
        # Constraint bound: constant, or the other var (a "future" — we
        # resolve it during the worklist solve by reading its range).
        for edge, suffix, target in (
            (0, "t", term.then_block),
            (1, "f", term.else_block),
        ):
            tgt = blocks[target]
            new_name = _fresh(term.lhs, suffix)
            sigma = Sigma(dst=new_name, src=term.lhs,
                          constraint=Interval.top())
            # store the predicate with the sigma via a parallel list
            instrs = (("sigma", sigma, term, edge),) + tuple(
                _rename_uses(i, term.lhs, new_name) for i in tgt.instrs
            )
            new_term = _rename_term(tgt.terminator, term.lhs, new_name)
            blocks[target] = Block(tgt.name, instrs, new_term)
    return Program(blocks, prog.entry, prog.inputs), origin


def _rename_atom(atom, old: str, new: str):
    return new if atom == old else atom


def _rename_uses(instr: Assign, old: str, new: str) -> Assign:
    return Assign(
        dst=instr.dst,
        op=instr.op,
        a=_rename_atom(instr.a, old, new),
        b=_rename_atom(instr.b, old, new),
    )


def _rename_term(term, old: str, new: str):
    if isinstance(term, Branch):
        return Branch(
            lhs=_rename_atom(term.lhs, old, new),
            cmp=term.cmp,
            rhs=_rename_atom(term.rhs, old, new),
            then_block=term.then_block,
            else_block=term.else_block,
        )
    return term


# --- range solving -----------------------------------------------------------
def _atom_range(atom, env: Dict[str, Interval]) -> Interval:
    if isinstance(atom, Const):
        return Interval.const(atom.value)
    return env.get(atom, Interval.top())


def solve_ranges(prog: Program, max_passes: int = 64) -> Dict[str, Interval]:
    """Worklist solve over the (e-SSA) program; widen then narrow."""
    essa_prog, _ = to_essa(prog)
    env: Dict[str, Interval] = dict(prog.inputs)

    def _eval_block(blk: Block) -> None:
        for item in blk.instrs:
            if isinstance(item, tuple) and item[0] == "sigma":
                _, sigma, term, edge = item
                bound = _atom_range(term.rhs, env)
                t_itv, f_itv = _pred_intervals(term.cmp, bound)
                cons = t_itv if edge == 0 else f_itv
                src = env.get(sigma.src, Interval.top())
                got = src.intersect(cons)
                env[sigma.dst] = got if got is not None else src
                continue
            ins = item
            a = _atom_range(ins.a, env)
            b = _atom_range(ins.b, env) if ins.b is not None else None
            if ins.op == "const":
                res = a
            elif ins.op == "copy":
                res = a
            elif ins.op == "phi":
                res = a.union(b)
            elif ins.op in ("add", "sub", "mul"):
                res = _arith2(a, b, ins.op)
            elif ins.op == "div":            # floored, as the reference's
                res = _div(a, b, math.floor)
            else:
                res = Interval.top()
            prev = env.get(ins.dst)
            env[ins.dst] = res if prev is None else prev.union(res)

    # A few monotone passes reach fixpoint for reducible CFGs of this size;
    # widening is unnecessary because sigma constraints bound the growth.
    last = None
    for _ in range(max_passes):
        for blk in essa_prog.blocks.values():
            _eval_block(blk)
        snap = {k: (v.lo, v.hi) for k, v in env.items()}
        if snap == last:
            break
        last = snap
    return env


def merged_ranges(prog: Program
                  ) -> Dict[str, Tuple[Interval, Optional[Tuple[int, bool]]]]:
    """Fig. 8(d): union all e-SSA copies of each original variable and
    report the range plus required bitwidth."""
    env = solve_ranges(prog)
    merged: Dict[str, Interval] = {}
    for name, itv in env.items():
        base = name.split("_")[0]
        merged[base] = merged[base].union(itv) if base in merged else itv
    return {
        name: (itv, itv.bits() if itv.bounded else None)
        for name, itv in merged.items()
    }


# --- the paper's example ---------------------------------------------------
def figure8_program() -> Program:
    """The running example of Fig. 8: a branch on ``k < 50`` splits ``k``
    into k_t (< 50) and k_f (>= 50); downstream arithmetic uses the
    refined copies, and the merged ranges give the final bitwidths.

        entry:  k = input in [0, 99]
                if k < 50 goto then else else
        then:   a = k * 2          # k_t in [0, 49]  -> a in [0, 98]
                goto join
        else:   b = k - 50         # k_f in [50, 99] -> b in [0, 49]
                goto join
        join:   i = phi(a, b)      # [0, 98]
                j = i + 1          # [1, 99] -> 7 bits
    """
    blocks = {
        "entry": Block("entry", (), Branch("k", "<", Const(50),
                                           "then", "else")),
        "then": Block("then", (Assign("a", "mul", "k", Const(2)),),
                      Jump("join")),
        "else": Block("else", (Assign("b", "sub", "k", Const(50)),),
                      Jump("join")),
        "join": Block("join", (
            Assign("i", "phi", "a", "b"),
            Assign("j", "add", "i", Const(1)),
        ), None),
    }
    return Program(blocks=blocks, entry="entry",
                   inputs={"k": Interval(0, 99)})
