"""Causal critical-path analysis over event-DAG traces (copy of
``repro/obs/critpath.py``, DESIGN.md §14).

``repro_torch.obs.attribution`` answers "where did the busy cycles go" — but
busy-share is not causality: a resource can be 90% busy yet entirely off
the chain that bounds the makespan.  Since every ``Event`` now carries
its predecessor task ids (data deps + the in-order resource-occupancy
predecessor, stamped by ``Engine.run``), any ``Trace`` is a scheduling
DAG with the invariant

    event.start == 0  or  event.start == max(end of its deps)

so the *critical path* — a chain of events tiling ``[0, makespan]`` with
no gaps — always exists and is found by a backward walk over "binding"
predecessors (a dep whose ``end`` equals the event's ``start``).

The report splits on-path cycles by base resource (``c3.ATTN`` folds to
``ATTN``, NoC links to ``INTERCONNECT`` — sharded traces work
unchanged), by op class, and by event kind, and separates *exposed*
rewrite cycles (rewrites occupying a compute resource — the §I stall)
from *overlapped* ones (rewrites riding the ping-pong shadow ``BUS``
that still end up rate-limiting, i.e. a rewrite-bandwidth-bound
pipeline).  On the §I micro-workload the serial trace puts exposed
rewrites on the path for exactly 4/7 of the makespan — the paper's 57%
— while the ping-pong trace has zero exposed rewrite cycles on path.

``slack`` is the classic CPM latitude: how many cycles an event could
slip, holding the DAG fixed, before it grows the makespan.  Critical
events have slack 0.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from repro_torch.obs.attribution import (COMPUTE_RESOURCES, INTERCONNECT,
                                         OVERLAP_RESOURCE, base_resource,
                                         op_class)

#: Slack histogram bin edges, as fractions of the makespan.
SLACK_BINS = (0.0, 0.01, 0.05, 0.25, 1.0)


@dataclasses.dataclass(frozen=True)
class CritPathReport:
    """The longest chain ending at the makespan, plus its attribution."""

    path: Tuple  # chronological Events tiling [0, makespan]
    makespan: int
    critical_by_resource: Dict[str, int]   # base resource -> on-path cycles
    critical_by_class: Dict[str, int]      # op class -> on-path cycles
    critical_by_kind: Dict[str, int]       # event kind -> on-path cycles
    exposed_rewrite_cycles: int            # on-path rewrites on compute res
    overlapped_rewrite_cycles: int         # on-path rewrites on shadow BUS
    slack: Dict[int, int]                  # task_id -> slack cycles
    slack_histogram: Tuple[Tuple[str, int], ...]

    @property
    def path_cycles(self) -> int:
        return sum(e.cycles for e in self.path)

    @property
    def exposed_rewrite_share(self) -> float:
        """Fraction of the makespan causally bound by exposed rewrites —
        the §I claim, stated on the critical path instead of busy
        cycles.  4/7 on the serial micro-workload; 0.0 under
        ping-pong."""
        return (self.exposed_rewrite_cycles / self.makespan
                if self.makespan else 0.0)

    def critical_share(self, resource: str) -> float:
        """Fraction of the makespan on-path on ``resource`` (base name)."""
        return (self.critical_by_resource.get(resource, 0) / self.makespan
                if self.makespan else 0.0)

    @property
    def interconnect_share(self) -> float:
        """On-path share of the NoC links — nonzero only when a sharded
        trace is genuinely interconnect-bound, unlike busy-share."""
        return self.critical_share(INTERCONNECT)

    def to_dict(self) -> Dict[str, object]:
        return {
            "makespan": self.makespan,
            "path_events": len(self.path),
            "critical_by_resource": dict(self.critical_by_resource),
            "critical_by_class": dict(self.critical_by_class),
            "critical_by_kind": dict(self.critical_by_kind),
            "exposed_rewrite_cycles": self.exposed_rewrite_cycles,
            "overlapped_rewrite_cycles": self.overlapped_rewrite_cycles,
            "exposed_rewrite_share": self.exposed_rewrite_share,
            "interconnect_share": self.interconnect_share,
            "slack_histogram": [list(b) for b in self.slack_histogram],
        }


def _binding_pred(event, by_id):
    """The dep this event actually waited on: ``end == event.start``.
    Deterministic tie-break toward the longest (then earliest-submitted)
    binding dep, so heavyweight chains surface over zero-cost ones."""
    best = None
    for d in event.deps:
        p = by_id.get(d)
        if p is None or p.end != event.start:
            continue
        if best is None or (p.cycles, -p.task_id) > (best.cycles,
                                                     -best.task_id):
            best = p
    return best


def critical_path(trace) -> CritPathReport:
    """Extract the critical path and its causal attribution.

    Backward walk from the event that realizes the makespan, repeatedly
    following a binding predecessor until an event starting at cycle 0.
    The DAG invariant guarantees the walk never strands: every event
    with ``start > 0`` has a binding dep, so the path intervals tile
    ``[0, makespan]`` contiguously and ``path_cycles == makespan``
    exactly (a tier-1 property test pins this for all three modes).
    """
    events = list(trace.events)
    if not events:
        return CritPathReport(
            path=(), makespan=0, critical_by_resource={},
            critical_by_class={}, critical_by_kind={},
            exposed_rewrite_cycles=0, overlapped_rewrite_cycles=0,
            slack={}, slack_histogram=_histogram({}, 0))
    by_id = {e.task_id: e for e in events}
    makespan = trace.makespan
    # Walk back from the (deterministically chosen) last-finishing event.
    cur = max(events, key=lambda e: (e.end, -e.task_id))
    path: List = [cur]
    while cur.start > 0:
        pred = _binding_pred(cur, by_id)
        if pred is None:   # defensive: externally constructed trace
            break
        path.append(pred)
        cur = pred
    path.reverse()

    by_res: Dict[str, int] = defaultdict(int)
    by_cls: Dict[str, int] = defaultdict(int)
    by_kind: Dict[str, int] = defaultdict(int)
    exposed = overlapped = 0
    for e in path:
        res = base_resource(e.resource)
        by_res[res] += e.cycles
        by_cls[op_class(e.op)] += e.cycles
        by_kind[e.kind] += e.cycles
        if e.kind == "rewrite":
            if res == OVERLAP_RESOURCE:
                overlapped += e.cycles
            elif res in COMPUTE_RESOURCES:
                exposed += e.cycles
            else:
                exposed += e.cycles   # rewrite on any non-shadow resource
    slack = compute_slack(events, makespan)
    return CritPathReport(
        path=tuple(path),
        makespan=makespan,
        critical_by_resource=dict(sorted(by_res.items())),
        critical_by_class=dict(sorted(by_cls.items())),
        critical_by_kind=dict(sorted(by_kind.items())),
        exposed_rewrite_cycles=exposed,
        overlapped_rewrite_cycles=overlapped,
        slack=slack,
        slack_histogram=_histogram(slack, makespan),
    )


def compute_slack(events: Sequence, makespan: int) -> Dict[int, int]:
    """Per-event slack: latest finish (CPM backward pass over the stamped
    DAG) minus actual finish.  Zero for every event on some critical
    chain."""
    succs: Dict[int, List] = defaultdict(list)
    for e in events:
        for d in e.deps:
            succs[d].append(e)
    latest: Dict[int, int] = {}
    # Task ids are topologically ordered (deps precede), so a reverse
    # sweep is a valid backward pass.
    for e in sorted(events, key=lambda e: -e.task_id):
        ss = succs.get(e.task_id)
        if not ss:
            latest[e.task_id] = makespan
        else:
            latest[e.task_id] = min(latest[s.task_id] - s.cycles
                                    for s in ss)
    return {e.task_id: latest[e.task_id] - e.end for e in events}


def _histogram(slack: Dict[int, int],
               makespan: int) -> Tuple[Tuple[str, int], ...]:
    """Bin slack values by fraction of makespan: a mostly-zero histogram
    means a tight chain (little latitude to reorder); a long tail means
    ample overlap headroom."""
    labels = ["=0"]
    for lo, hi in zip(SLACK_BINS[:-1], SLACK_BINS[1:]):
        labels.append(f"({lo:.0%},{hi:.0%}]")
    labels.append(f">{SLACK_BINS[-1]:.0%}")
    counts = [0] * len(labels)
    for s in slack.values():
        frac = s / makespan if makespan else 0.0
        if s == 0:
            counts[0] += 1
            continue
        for k, hi in enumerate(SLACK_BINS[1:], start=1):
            if frac <= hi:
                counts[k] += 1
                break
        else:
            counts[-1] += 1
    return tuple(zip(labels, counts))


def format_critpath(report: CritPathReport, *, title: str = "",
                    limit: int = 12) -> str:
    """Text rendering behind ``python -m repro_torch.obs --critpath``."""
    lines: List[str] = []
    if title:
        lines.append(title)
    lines.append(f"critical path: {len(report.path)} events tiling "
                 f"{report.makespan} cycles")
    lines.append(f"exposed rewrite on path: "
                 f"{report.exposed_rewrite_cycles} cycles "
                 f"({report.exposed_rewrite_share:.1%} of makespan), "
                 f"overlapped rewrite on path: "
                 f"{report.overlapped_rewrite_cycles}")
    lines.append("")
    lines.append(f"{'resource':<13} {'on-path':>12} {'share':>7}")
    for r, c in sorted(report.critical_by_resource.items(),
                       key=lambda kv: -kv[1]):
        lines.append(f"{r:<13} {c:>12} {report.critical_share(r):>6.1%}")
    lines.append("")
    lines.append(f"{'op class':<13} {'on-path':>12}")
    for k, c in sorted(report.critical_by_class.items(),
                       key=lambda kv: -kv[1]):
        lines.append(f"{k:<13} {c:>12}")
    lines.append("")
    lines.append("slack histogram (events by slack/makespan):")
    for label, count in report.slack_histogram:
        lines.append(f"  {label:<10} {count:>8}")
    lines.append("")
    lines.append(f"head of path (first {limit}):")
    lines.append(f"  {'cycle':>10}  {'res':<9} {'kind':<8} tag")
    for e in report.path[:limit]:
        lines.append(f"  {e.start:>10}  {e.resource:<9} {e.kind:<8} {e.tag}")
    if len(report.path) > limit:
        lines.append(f"  ... ({len(report.path) - limit} more on path)")
    return "\n".join(lines)
