"""Simulate a ``ShardedPlan`` on the DES engine (copy of
``repro/shard/sim.py``, pure Python; DESIGN.md §13).

Every chip is a full StreamDCIM accelerator: its resources are prefixed
(``c0.GEN``, ``c0.ATTN``, ``c0.BUS``, ``c0.NOC``, ``c0.HBM``, ``c0.VEC``)
so the existing mode schedulers lower each chip's sub-plan unchanged
through a resource-prefixing engine view.  Inter-chip collectives lower
through ``noc.lower_collective`` onto shared ``NOC_*`` link resources;
each chip's next op gates on *its own* arrival, so a pipelined multicast
tail overlaps downstream chips' compute the way ping-pong hides rewrites.

Byte-exactness (the multi-chip version of the ``simulate_serve``
discipline): after the run, this module RAISES unless

* every chip's per-op simulated HBM bytes equal that sub-plan op's
  ``hbm_bytes`` prediction, and
* summed ``NOC_*`` link bytes equal the sharded plan's predicted
  collective bytes.

The partitioner and the simulator computing the same number through
different code paths is the whole point of the assert.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import ExecutionMode
from repro_torch.sim.dataflow import Engine
from repro_torch.sim.pipeline import _SCHEDULERS
from repro_torch.sim.trace import Trace
from repro_torch.sim.workload import AttnOp, workload_from_plan
from repro_torch.shard import noc
from repro_torch.shard.partition import ShardedPlan


@dataclasses.dataclass(frozen=True)
class ShardSimResult:
    """One sharded run.  ``cycles`` is the mesh makespan; per-chip
    figures come from the trace's resource prefixes.  (A deliberate
    sibling of ``sim.pipeline.SimResult`` — that class reads the literal
    ``HBM`` resource, which no longer exists on a mesh.)"""

    plan: ShardedPlan
    hw: str
    cycles: int
    trace: Trace
    per_chip_cycles: Tuple[int, ...]
    per_chip_hbm_bytes: Tuple[int, ...]
    link_bytes: Dict[str, int]          # per NOC_* link
    hw_cfg: object = None

    @property
    def chips(self) -> int:
        return self.plan.chips

    @property
    def hbm_bytes(self) -> int:
        return sum(self.per_chip_hbm_bytes)

    @property
    def collective_bytes(self) -> int:
        return sum(self.link_bytes.values())


class _ShardEngine(Engine):
    """Engine applying per-resource calibration scales by the *base*
    resource name (``c3.ATTN`` scales by the fitted ``ATTN`` factor), so
    single-chip calibration fits (DESIGN.md §10) carry over to meshes."""

    def __init__(self, scale=None) -> None:
        super().__init__()
        self.scale = dict(scale or {})

    def task(self, kind, resource, cycles, deps=(), nbytes=0, tag=""):
        if cycles and self.scale:
            base = resource.split(".", 1)[-1]
            s = self.scale.get(base, 1.0)
            if s != 1.0:
                cycles = max(1, int(math.ceil(cycles * s)))
        return super().task(kind, resource, cycles, deps, nbytes, tag)


class _ChipView:
    """Engine proxy prefixing resources with ``c{i}.`` — the schedulers
    lower through it unchanged.  Barriers stay on the shared zero-cost
    SYNC pseudo-resource."""

    def __init__(self, eng: Engine, prefix: str) -> None:
        self._eng = eng
        self._prefix = prefix

    def task(self, kind, resource, cycles, deps=(), nbytes=0, tag=""):
        return self._eng.task(kind, self._prefix + resource, cycles, deps,
                              nbytes, tag)

    def barrier(self, deps, tag="sync"):
        return self._eng.barrier(deps, tag)


def chip_prefix(i: int) -> str:
    return f"c{i}."


def _lower_op(sched, view: _ChipView, op, start: int) -> int:
    if isinstance(op, AttnOp):
        return sched.build_attn(view, op, start)
    return sched.build_gemm(view, op, start)


def simulate_sharded_plan(splan: ShardedPlan, hw=None, *,
                          calibration=None) -> ShardSimResult:
    """Lower every chip's sub-plan + the collective wire plans onto one
    engine and run.  Raises ``RuntimeError`` on any byte disagreement
    between the partitioner's predictions and the simulated trace."""
    from repro_torch.sim.replay import resolve_calibration
    hw = hw or splan.base.hw_config()
    eng = _ShardEngine(resolve_calibration(calibration))
    scheds = {m: _SCHEDULERS[m](hw) for m in ExecutionMode}
    C = splan.chips
    mesh = splan.mesh

    views = [_ChipView(eng, chip_prefix(i)) for i in range(C)]
    chip_ops: List[List[object]] = []
    mode_of: Dict[str, ExecutionMode] = {}
    for i, cp in enumerate(splan.chip_plans):
        wl = workload_from_plan(cp, prefix=chip_prefix(i))
        chip_ops.append([op for layer in wl.layers for op in layer.ops])
        for p in tuple(cp.layers) + tuple(cp.gemms):
            mode_of[chip_prefix(i) + p.name] = p.mode

    # Collectives keyed by their producing op ("" = plan input); an op
    # owned by several chips (tensor/sequence) fires its collectives once
    # every owner has produced its share.
    colls_after: Dict[str, List[object]] = {}
    for coll in splan.collectives:
        colls_after.setdefault(coll.after, []).append(coll)
    owners: Dict[str, set] = {}
    for i, cp in enumerate(splan.chip_plans):
        for p in tuple(cp.layers) + tuple(cp.gemms):
            owners.setdefault(p.name, set()).add(i)

    start = eng.barrier([], tag="start")
    prev: Dict[int, int] = {i: start for i in range(C)}
    gates: Dict[int, List[int]] = {i: [] for i in range(C)}

    def fire(colls) -> None:
        for coll in colls:
            arrivals = noc.lower_collective(
                eng, mesh, coll, dep_of=lambda c: [prev[c]],
                tag=coll.name)
            for chip, t in arrivals.items():
                gates[chip].append(t)

    fire(colls_after.get("", ()))

    # Round order: tensor/sequence meshes run symmetric op streams in
    # lockstep; group meshes run their disjoint stages chip-by-chip (the
    # p2p arrivals chain them).
    if splan.axis == "group":
        rounds = [[(i, op)] for i in range(C) for op in chip_ops[i]]
    else:
        rounds = [list(enumerate(ops)) for ops in zip(*chip_ops)]

    produced: Dict[str, set] = {}
    for rnd in rounds:
        fired: List[str] = []
        for chip, op in rnd:
            dep = prev[chip]
            if gates[chip]:
                dep = eng.barrier([dep] + gates[chip],
                                  tag=f"c{chip}.gate")
                gates[chip] = []
            prev[chip] = _lower_op(scheds[mode_of[op.name]], views[chip],
                                   op, dep)
            base_name = op.name.split(".", 1)[-1]
            done = produced.setdefault(base_name, set())
            done.add(chip)
            if done == owners[base_name]:
                fired.append(base_name)
        for name in fired:
            fire(colls_after.get(name, ()))

    eng.barrier([prev[i] for i in range(C)], tag="mesh_done")
    trace = eng.run()
    return _check_and_pack(splan, hw, trace)


def _check_and_pack(splan: ShardedPlan, hw, trace: Trace) -> ShardSimResult:
    C = splan.chips
    # One pass: bucket HBM bytes by (chip, op), link bytes by link, and
    # per-chip busy horizons.
    hbm_by_op: Dict[str, int] = {}
    chip_hbm = [0] * C
    chip_end = [0] * C
    link_bytes: Dict[str, int] = {}
    for e in trace.events:
        r = e.resource
        if noc.is_link_resource(r):
            link_bytes[r] = link_bytes.get(r, 0) + e.bytes
            continue
        if not r.startswith("c") or "." not in r:
            continue
        chip_s, base = r.split(".", 1)
        chip = int(chip_s[1:])
        chip_end[chip] = max(chip_end[chip], e.end)
        if base == "HBM":
            chip_hbm[chip] += e.bytes
            op = e.tag.split(":", 1)[0]
            hbm_by_op[op] = hbm_by_op.get(op, 0) + e.bytes

    for i, cp in enumerate(splan.chip_plans):
        for lp in cp.layers:
            got = hbm_by_op.get(chip_prefix(i) + lp.name, 0)
            if got != lp.hbm_bytes:
                raise RuntimeError(
                    f"chip {i} op {lp.name}: simulated HBM bytes {got} != "
                    f"sharded-plan prediction {lp.hbm_bytes} (mode "
                    f"{lp.mode.value}, axis {splan.axis}, "
                    f"{splan.mesh.name}) — the partitioner and the "
                    f"simulator disagree on the sharded traffic model")

    got_link = sum(link_bytes.values())
    want_link = splan.total_collective_link_bytes
    if got_link != want_link:
        raise RuntimeError(
            f"simulated NoC link bytes {got_link} != sharded-plan "
            f"collective prediction {want_link} (axis {splan.axis}, "
            f"{splan.mesh.name}) — the partitioner and the NoC model "
            f"disagree on the collective wire plan")

    return ShardSimResult(
        plan=splan, hw=hw.name, cycles=trace.makespan, trace=trace,
        per_chip_cycles=tuple(chip_end),
        per_chip_hbm_bytes=tuple(chip_hbm),
        link_bytes=link_bytes, hw_cfg=hw)
