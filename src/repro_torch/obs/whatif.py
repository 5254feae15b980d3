"""What-if projection: rescale event durations, recompute the DAG
schedule (copy of ``repro/obs/whatif.py``, DESIGN.md §14).

Because ``Engine.run`` is an in-order-per-resource list scheduler and
every event's stamped ``deps`` include its resource-occupancy
predecessor, replaying the events in task-id order with

    start = max(projected end of deps, resource free)

reconstructs the original schedule *exactly* when durations are
unchanged (``project`` with ``k=1`` is identity to the cycle — a tier-1
test pins this).  Rescaling durations before the replay therefore
projects "resource R k× faster" / "link bandwidth k×" without
re-simulating the workload — validated against full re-simulation
(``simulate_plan(calibration=...)``) on registry models within a pinned
tolerance; the residual is per-task integer rounding only, since the
order of issuing tasks is fixed by construction in both.

``whatif_ping_pong`` toggles the §II-C shadow sub-array:

* **off** (a ping-pong trace): overlapped rewrites are remapped from the
  shadow ``BUS`` onto the compute array they shadow, re-serializing them
  — exact on the §I micro-workload (projects the ping-pong trace onto
  the serial makespan to the cycle).
* **on** (a serial trace): exposed rewrites are scaled to zero cost —
  the *perfect-overlap bound*.  It is a lower bound on the achievable
  makespan: a real shadow bus still serializes rewrites against its own
  bandwidth (the §I ping-pong trace is rewrite-bandwidth-bound at
  77824 > the 49152 bound).  DESIGN.md §14 states this envelope.

``headroom`` runs the k→∞ projection per base resource: the fractional
makespan reduction if that resource were free.  Stamped on every DSE
``SweepRow`` so frontiers explain *why* a design wins.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.obs.attribution import (COMPUTE_RESOURCES, ATTN_RESOURCE,
                                         INTERCONNECT, OVERLAP_RESOURCE,
                                         base_resource)


@dataclasses.dataclass(frozen=True)
class WhatIfProjection:
    """One projected scenario next to its baseline."""

    label: str
    baseline_makespan: int
    projected_makespan: float
    scales: Dict[str, float]

    @property
    def speedup(self) -> float:
        return (self.baseline_makespan / self.projected_makespan
                if self.projected_makespan else float("inf"))

    def to_dict(self) -> Dict[str, object]:
        return {"label": self.label,
                "baseline_makespan": self.baseline_makespan,
                "projected_makespan": self.projected_makespan,
                "speedup": self.speedup,
                "scales": dict(self.scales)}


def _replay(events, duration_of: Callable,
            resource_of: Optional[Callable] = None) -> float:
    """List-schedule replay over stamped-DAG events in task-id order.
    ``duration_of(event) -> float`` and optional ``resource_of(event)``
    let callers rescale and remap; returns the projected makespan."""
    free: Dict[str, float] = {}
    end: Dict[int, float] = {}
    makespan = 0.0
    for e in sorted(events, key=lambda e: e.task_id):
        res = resource_of(e) if resource_of is not None else e.resource
        start = max([end[d] for d in e.deps if d in end], default=0.0)
        start = max(start, free.get(res, 0.0))
        fin = start + duration_of(e)
        end[e.task_id] = fin
        free[res] = fin
        if fin > makespan:
            makespan = fin
    return makespan


def project(trace, scales: Mapping[str, float],
            label: str = "") -> WhatIfProjection:
    """Project the makespan with per-base-resource speed factors.

    ``scales`` maps base resource names (``ATTN``, ``HBM``,
    ``INTERCONNECT`` for all NoC links, ...) to a speed factor ``k``:
    every event on that resource takes ``cycles / k``.  ``k = math.inf``
    makes the resource free (used by ``headroom``).  Unlisted resources
    keep their durations; ``k=1`` everywhere is exactly identity.
    """
    for r, k in scales.items():
        if k <= 0:
            raise ValueError(f"scale for {r} must be > 0, got {k}")

    def duration(e):
        k = scales.get(base_resource(e.resource), 1.0)
        return 0.0 if math.isinf(k) else e.cycles / k

    projected = _replay(trace.events, duration)
    return WhatIfProjection(
        label=label or "+".join(f"{r}x{k:g}"
                                for r, k in sorted(scales.items())),
        baseline_makespan=trace.makespan,
        projected_makespan=projected,
        scales=dict(scales))


def whatif_resource(trace, resource: str, k: float) -> WhatIfProjection:
    """Project "resource R k× faster"."""
    return project(trace, {base_resource(resource): k},
                   label=f"{base_resource(resource)} {k:g}x faster")


def whatif_link_bandwidth(trace, k: float) -> WhatIfProjection:
    """Project "NoC link bandwidth k×" on a sharded trace (all
    ``NOC_*`` link events fold to ``INTERCONNECT``)."""
    return project(trace, {INTERCONNECT: k},
                   label=f"link bandwidth {k:g}x")


def whatif_ping_pong(trace) -> WhatIfProjection:
    """Toggle the ping-pong shadow sub-array, auto-detecting direction.

    A trace with overlapped rewrites (on ``BUS``) projects ping-pong
    *off*: rewrites remap onto the attention array (chip prefix
    preserved) and re-serialize against compute — exact on the §I
    micro-workload.  A trace with exposed rewrites projects ping-pong
    *on*: exposed rewrite durations go to zero — the perfect-overlap
    lower bound (see module docstring for the validity envelope).
    """
    overlapped = any(e.kind == "rewrite"
                     and base_resource(e.resource) == OVERLAP_RESOURCE
                     for e in trace.events)
    if overlapped:
        def remap(e):
            head, dot, rest = e.resource.rpartition(".")
            if (e.kind == "rewrite"
                    and base_resource(e.resource) == OVERLAP_RESOURCE):
                return f"{head}{dot}{ATTN_RESOURCE}" if dot else ATTN_RESOURCE
            return e.resource

        projected = _replay(trace.events, lambda e: float(e.cycles), remap)
        return WhatIfProjection(
            label="ping-pong off (rewrites re-serialized)",
            baseline_makespan=trace.makespan,
            projected_makespan=projected,
            scales={})

    def duration(e):
        if (e.kind == "rewrite"
                and base_resource(e.resource) in COMPUTE_RESOURCES):
            return 0.0
        return float(e.cycles)

    projected = _replay(trace.events, duration)
    return WhatIfProjection(
        label="ping-pong on (perfect-overlap bound)",
        baseline_makespan=trace.makespan,
        projected_makespan=projected,
        scales={})


def headroom(trace,
             resources: Optional[Tuple[str, ...]] = None) -> Dict[str, float]:
    """Per-resource causal headroom: fractional makespan reduction with
    that base resource free (k→∞).  A busy-but-off-path resource scores
    ~0; the true bottleneck scores highest.  Keys are the trace's base
    resources (or ``resources`` if given)."""
    base = trace.makespan
    if not base:
        return {}
    # One k→∞ projection per base resource is the DSE stamp's hot path
    # (it runs per swept point).  The generic ``project``/``_replay``
    # pair would re-sort the events and re-derive ``base_resource`` for
    # every resource; precompute the replay tuples once and inline the
    # list-schedule loop — arithmetic identical to ``_replay`` with
    # ``duration = 0.0 if freed else cycles / 1.0``.
    prep = [(e.task_id, e.deps, e.cycles / 1.0, e.resource,
             base_resource(e.resource))
            for e in sorted(trace.events, key=lambda e: e.task_id)]
    names = resources or tuple(sorted({p[4] for p in prep}))
    out: Dict[str, float] = {}
    for r in names:
        free: Dict[str, float] = {}
        end: Dict[int, float] = {}
        end_get = end.get
        free_get = free.get
        makespan = 0.0
        for tid, deps, cyc, res, bres in prep:
            start = 0.0
            for d in deps:
                t = end_get(d)
                if t is not None and t > start:
                    start = t
            f = free_get(res, 0.0)
            if f > start:
                start = f
            fin = start if bres == r else start + cyc
            end[tid] = fin
            free[res] = fin
            if fin > makespan:
                makespan = fin
        out[r] = 1.0 - makespan / base
    return out


def parse_whatif(spec: str) -> Tuple[str, float]:
    """Parse a CLI ``RESOURCE:K`` spec (``ATTN:2``, ``HBM:4``,
    ``INTERCONNECT:2``, ``ping_pong`` with no factor)."""
    name, sep, factor = spec.partition(":")
    name = name.strip()
    if not name:
        raise ValueError(f"empty what-if spec {spec!r}")
    if not sep:
        return name, 1.0
    try:
        k = float(factor)
    except ValueError:
        raise ValueError(f"bad what-if factor in {spec!r}") from None
    return name, k


def run_whatif(trace, spec: str) -> WhatIfProjection:
    """Dispatch one CLI spec against a trace."""
    name, k = parse_whatif(spec)
    if name.lower() in ("ping_pong", "pingpong", "pp"):
        return whatif_ping_pong(trace)
    if name.upper() == INTERCONNECT:
        return whatif_link_bandwidth(trace, k)
    return whatif_resource(trace, name, k)


def format_whatif(projections: List[WhatIfProjection],
                  *, title: str = "") -> str:
    lines: List[str] = []
    if title:
        lines.append(title)
    lines.append(f"{'scenario':<36} {'baseline':>12} {'projected':>12} "
                 f"{'speedup':>8}")
    for p in projections:
        lines.append(f"{p.label:<36} {p.baseline_makespan:>12} "
                     f"{p.projected_makespan:>12.0f} {p.speedup:>7.2f}x")
    return "\n".join(lines)
