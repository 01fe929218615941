"""Pass 4: sharding and donation lints.

Port of ``repro.analysis.sharding_lint``. Two whole-program invariants
that otherwise hold only by convention:

* **group-of-32 packed axis**: a packed payload may shard its last
  (word) axis only when the *logical* axis length is a multiple of
  ``32 x shard count``; anything else hands two devices halves of one
  group's shift/or network (``distributed.sharding.spec_for_packed``).
  The lint re-derives the rule per planned leaf at TP degrees 2, 4 and
  8 and reports any spec that keeps a misaligned shard (error), plus
  notes (info) where a leaf's packed axis must replicate at every
  degree. As in the reference, outside a mesh every axis name resolves
  to replicated, so every spec is replicated and the check holds
  trivially; the port has no mesh until ROADMAP A15.
* **donated-buffer read-after-overwrite**: serving hands ``decode_step``
  its decode state to update. The pass traces ``LM.decode_step`` into
  its functional ATen graph (``make_fx`` of ``torch.func.functionalize``,
  the functionalization ``torch.export``'s ``run_decompositions`` does,
  in one trace instead of two): the state's in-place writes become
  overwrite-shaped nodes (``index_put``, ``select_scatter``,
  ``slice_scatter``, ``scatter*``, ``copy``) whose destination is the
  state input, and a final ``copy_`` writes each mutated input back. A
  state input that such a node overwrites and a *later* node reads again
  reads a buffer that, aliased, already holds the new values: a stale
  read, reported as a warning (some double uses are stale by design,
  e.g. rollback paths). In eager PyTorch an in-place write is seen by
  every later read, so on the port's own in-place state writes the pass
  cannot fire; it catches an out-of-place overwrite whose old input is
  read again, as the reference's does on a donated jaxpr.

Like the reference's ``make_jaxpr``, the donation pass executes
nothing: it traces on the CPU through the plain versions, from the
config's shapes alone (fake tensors), so a full-width config costs no
memory, and it launches no kernel. The trace depends on the config and
the state's shape only, so it is kept per (config, batch, length) for
the process.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.report import Finding
from repro_torch.core import bitpack
from repro_torch.core.calibrate import _leaves_sorted
from repro_torch.core.compress import path_str, uniform_plan
from repro_torch.core.range_analysis import op_name
from repro_torch.core.tensor_store import is_packed
from repro_torch.distributed.sharding import (_spec_shards, spec_for,
                                              spec_for_packed)

_TP_DEGREES = (2, 4, 8)
_OVERWRITES = ("index_put", "select_scatter", "slice_scatter", "copy")


def _planned_leaves(params: Dict, plan) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, logical shape) of every leaf ``repack(params, plan)``
    would pack, in sorted path order, without packing anything."""
    out = []
    for path, leaf in _leaves_sorted(params):
        spec = plan.bits_of(path, leaf)
        if spec is None:
            continue
        bits = spec[0] if isinstance(spec, tuple) else spec
        if is_packed(leaf):
            out.append((path_str(path), tuple(leaf.logical_shape)))
        elif bits is not None and bits < 32:
            out.append((path_str(path), tuple(leaf.shape)))
    return sorted(out)


def lint_sharding(cfg, plan=None,
                  params: Optional[Dict] = None) -> List[Finding]:
    """Check the group-of-32 rule for every planned leaf at each TP
    degree, using the ``axis_sizes`` override (no mesh needed)."""
    findings: List[Finding] = []
    if params is None:
        from repro_torch.models.lm import LM
        params = LM(cfg).init()
    if plan is None or not plan.float_bits:
        plan = uniform_plan(params, cfg.resolved_weight_bits)
    leaves = _planned_leaves(params, plan)

    n_checked = 0
    for path, logical in leaves:
        base = spec_for(path, logical)
        base_last = base[-1] if len(base) == len(logical) and base else None
        dropped_at: List[int] = []
        for tp in _TP_DEGREES:
            sizes = {"model": tp, "data": 1}
            spec = spec_for_packed(path, logical, axis_sizes=sizes)
            n_checked += 1
            last = spec[-1] if spec else None
            if last is not None:
                shards = _spec_shards(last, sizes)
                if shards > 1 and logical[-1] % (bitpack.GROUP * shards):
                    findings.append(Finding(
                        check="sharding", severity="error", path=path,
                        message=(
                            f"group-of-32 violation: packed axis of "
                            f"{path} (logical last dim {logical[-1]}) "
                            f"sharded {shards}-way over {last!r} but "
                            f"{logical[-1]} % {bitpack.GROUP * shards} "
                            f"!= 0: a bit-group would straddle devices"),
                        detail={"logical_shape": list(logical),
                                "tp": tp, "entry": str(last)},
                    ))
            elif base_last is not None and _spec_shards(
                    base_last, sizes) > 1:
                dropped_at.append(tp)
        if dropped_at and len(dropped_at) == len(_TP_DEGREES):
            findings.append(Finding(
                check="sharding", severity="info", path=path,
                message=(
                    f"perf: packed axis of {path} (logical last dim "
                    f"{logical[-1]}) replicates at every TP degree "
                    f"{_TP_DEGREES}: the logical width is not a "
                    f"multiple of 32 x shards, so the packed leaf "
                    "cannot tensor-parallelize its hot axis"),
                detail={"logical_shape": list(logical),
                        "degrees": dropped_at},
            ))
    if all(f.severity == "info" for f in findings):
        findings.append(Finding(
            check="sharding", severity="info",
            message=(
                f"group-of-32 rule holds for {len(leaves)} packed "
                f"leaves x {len(_TP_DEGREES)} TP degrees "
                f"({n_checked} specs checked)"),
        ))
    return findings


def _overwritten(node: torch.fx.Node) -> Optional[torch.fx.Node]:
    """The input this node treats as an in-place destination (its first
    argument, for an overwrite-shaped op), else None."""
    name = op_name(node.target)
    if (name in _OVERWRITES or name.startswith("scatter")) and node.args \
            and isinstance(node.args[0], torch.fx.Node):
        return node.args[0]
    return None


def donation_hazards(graph: torch.fx.Graph, donated: Dict[Any, str]
                     ) -> Dict[str, Tuple[int, int, str]]:
    """Walk a graph's calls in order: for each donated input (a
    ``{node: name}`` map), record its first overwrite-shaped use, then
    flag any read by a *later* call. A ``copy`` replaces all of its
    destination, so it does not read it: the write-back of a mutated
    input is no read. Returns ``{name: (overwrite index, read index,
    reader op)}``, indices counting calls."""
    overwritten_at: Dict[Any, int] = {}
    hazards: Dict[str, Tuple[int, int, str]] = {}
    calls = (n for n in graph.nodes if n.op == "call_function")
    for idx, node in enumerate(calls):
        dst = _overwritten(node)
        copied = dst if op_name(node.target) == "copy" else None
        for v in node.all_input_nodes:
            if v in donated and v in overwritten_at and v is not copied \
                    and idx > overwritten_at[v]:
                hazards.setdefault(donated[v], (overwritten_at[v], idx,
                                                op_name(node.target)))
        if dst in donated and dst not in overwritten_at:
            overwritten_at[dst] = idx
    return hazards


def functional_graph(fn, args) -> torch.fx.GraphModule:
    """``fn`` over ``args`` (fake tensors, or real ones) traced into its
    functional ATen graph: placeholders in the order of ``args``'
    flattened leaves, in-place writes as overwrite-shaped nodes on fresh
    values, each mutated input written back by a final ``copy_``. Dead
    nodes go: functionalization leaves each view's first, stale reading
    of its base unused once it regenerates the view from the new value."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(torch.func.functionalize(fn, remove="mutations"),
                 tracing_mode="fake")(*args)
    gm.graph.eliminate_dead_code()
    return gm


def _key_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def decode_program(cfg, batch_size: int = 1, seq_len: int = 32):
    """``LM.decode_step``'s functional graph over fake tensors of the
    config's parameters and dense decode state (on the CPU, through the
    plain versions): ``(graph module, {state input: state path})``,
    kept per (config, batch, length) for the process."""
    return _decode_program(cfg, batch_size, seq_len)


@functools.lru_cache(maxsize=8)
def _decode_program(cfg, batch_size: int, seq_len: int):
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.lm import LM

    with FakeTensorMode():
        lm = LM(cfg, device="cpu")
        params = lm.init()
        state = lm.init_decode_state(batch_size, seq_len)
        tokens = torch.zeros((batch_size, 1), dtype=torch.int32)
    step = LM(cfg, device="cpu").decode_step
    # a plain function: make_fx counts a bound method's ``self`` as an
    # argument to trace
    gm = functional_graph(lambda p, s, t: step(p, s, t),
                          (params, state, tokens))
    n_params = len(pytree.tree_leaves(params))
    state_paths = [_key_str(p) for p, _ in
                   pytree.tree_flatten_with_path(state)[0]]
    inputs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    donated = dict(zip(inputs[n_params:n_params + len(state_paths)],
                       state_paths))
    return gm, donated


def lint_donation(cfg, batch_size: int = 1,
                  seq_len: int = 32) -> List[Finding]:
    """Walk ``decode_step``'s functional graph: every state input read
    by a call *after* its overwrite-shaped use is a read-after-overwrite
    hazard."""
    findings: List[Finding] = []
    try:
        gm, donated = decode_program(cfg, batch_size, seq_len)
    except Exception as e:                     # noqa: BLE001: the lint
        # keeps running; the failure is a (non-gating) warning
        findings.append(Finding(
            check="donation", severity="warning",
            message=f"tracing decode_step failed: "
                    f"{type(e).__name__}: {e}"))
        return findings

    hazards = donation_hazards(gm.graph, donated)
    for name, (w_idx, r_idx, op) in sorted(hazards.items()):
        findings.append(Finding(
            check="donation", severity="warning", path=name,
            message=(
                f"donated state leaf {name} is overwritten at node "
                f"{w_idx} and read again at node {r_idx} ({op}): "
                "aliased, this read can observe the overwritten buffer"),
            detail={"overwrite_eqn": w_idx, "read_eqn": r_idx,
                    "reader": op},
        ))
    if not findings:
        n_calls = sum(n.op == "call_function" for n in gm.graph.nodes)
        findings.append(Finding(
            check="donation", severity="info",
            message=(
                f"no donated-buffer read-after-overwrite in decode_step "
                f"({len(donated)} donated state leaves, {n_calls} "
                "graph calls)"),
        ))
    return findings
