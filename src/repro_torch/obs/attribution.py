"""Stall and busy-cycle attribution over simulator traces (copy of
``repro/obs/attribution.py``, DESIGN.md §12).

The paper's headline analysis (§I) is an attribution claim: under
layer-based streaming, 57% of the macro array's cycles go to CIM
rewriting instead of compute.  This module answers that question for
*any* trace, not just the hand-derived micro-workload:

* per-resource busy cycles / utilization and the **critical resource**
  (the busiest one — what a next design iteration should attack);
* per-**op-class** cycle breakdowns (attention / ffn / proj / decode),
  folding serve-step tag framing (``t3.pre.r1.<op>``) away so serving
  traces aggregate like plain prefill traces;
* **exposed vs overlapped rewrite cycles**: rewrites scheduled on a
  compute resource (NON/LAYER modes — no shadow sub-array) stall the
  array and are *exposed*; rewrites riding the ping-pong shadow bus
  (``BUS``, TILE mode) are *overlapped* and only their schedule residue
  can surface as idle time.

``bottleneck_of`` is the one-word reduction used to stamp every DSE
``SweepRow``; ``format_report`` renders the text report behind
``python -m repro_torch.obs``.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from collections import defaultdict
from typing import Dict, List

#: Resources whose events are macro-array compute (not data movement).
COMPUTE_RESOURCES = ("GEN", "ATTN", "VEC")

#: Attention-macro resource — the array rewrites contend with (§I).
ATTN_RESOURCE = "ATTN"

#: Shadow sub-array rewrite port: rewrites here overlap compute (§II-C).
OVERLAP_RESOURCE = "BUS"

#: Aggregate label for the inter-chip NoC links of a sharded trace.
INTERCONNECT = "INTERCONNECT"

#: Link resource prefix — mirrors ``repro_torch.shard.noc.LINK_PREFIX`` (obs
#: sits below shard in the layering, so the literal is pinned here and a
#: tier-1 test asserts the two stay equal).
NOC_LINK_PREFIX = "NOC_"

_FRAMING = re.compile(r"t\d+|r\d+|c\d+|pre|dec")

_CHIP = re.compile(r"c\d+")


@functools.lru_cache(maxsize=4096)
def base_resource(resource: str) -> str:
    """Fold a sharded-trace resource name to its single-chip base: the
    per-chip prefix strips (``c3.ATTN`` -> ``ATTN``) and NoC link
    instances aggregate (``NOC_L2`` -> ``INTERCONNECT``).  Identity on
    unprefixed single-chip names.  Memoized — the what-if replays call
    this once per event per projection, over a tiny name alphabet."""
    head, _, rest = resource.partition(".")
    if rest and _CHIP.fullmatch(head):
        resource = rest
    if resource.startswith(NOC_LINK_PREFIX):
        return INTERCONNECT
    return resource


def op_class(op: str) -> str:
    """Collapse an event's op name to its op class.

    Serve-step framing segments (``t{step}``, ``pre``/``dec``,
    ``r{rid}``) are stripped first, so ``t3.pre.r1.cox0_co`` classifies
    like ``cox0_co``.  Classes: ``decode`` (decode-plan ops carry a
    ``.decode`` suffix), ``ffn``, ``proj`` (output projections), ``sync``
    framing, and ``attention`` for everything else (including the §I
    ``it{n}`` micro-workload phases)."""
    parts = [p for p in op.split(".") if p]
    while parts and _FRAMING.fullmatch(parts[0]):
        parts.pop(0)
    base = ".".join(parts) or op
    if base == "sync" or base.endswith(":sync"):
        return "sync"
    if base == "decode" or base.endswith(".decode"):
        return "decode"
    if "ffn" in base:
        return "ffn"
    if base.endswith("_oproj") or "proj" in base:
        return "proj"
    return "attention"


@dataclasses.dataclass(frozen=True)
class OpClassBreakdown:
    """Cycle budget of one op class, split by event kind."""

    op_class: str
    compute: int = 0
    rewrite: int = 0
    dma: int = 0
    forward: int = 0
    attn_compute: int = 0        # compute cycles on the attention array
    rewrite_exposed: int = 0     # rewrites stalling a compute resource

    @property
    def total(self) -> int:
        return self.compute + self.rewrite + self.dma + self.forward

    @property
    def rewrite_stall_fraction(self) -> float:
        """§I metric per op class: exposed rewrite cycles over the
        attention array's (rewrite + compute) budget for this class."""
        denom = self.rewrite_exposed + self.attn_compute
        return self.rewrite_exposed / denom if denom else 0.0

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["total"] = self.total
        d["rewrite_stall_fraction"] = self.rewrite_stall_fraction
        return d


@dataclasses.dataclass(frozen=True)
class AttributionReport:
    """Where the cycles went, for one trace."""

    makespan: int
    busy: Dict[str, int]
    utilization: Dict[str, float]
    critical_resource: str
    critical_share: float
    rewrite_total: int
    rewrite_exposed: int
    rewrite_overlapped: int
    rewrite_stall_fraction: float
    by_op_class: Dict[str, OpClassBreakdown]

    @property
    def bottleneck(self) -> str:
        return self.critical_resource

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["by_op_class"] = {k: v.to_dict()
                            for k, v in self.by_op_class.items()}
        d["bottleneck"] = self.bottleneck
        return d


def attribute(trace) -> AttributionReport:
    """Reduce a ``sim.Trace`` to its attribution report.

    ``rewrite_stall_fraction`` follows ``Trace.rewrite_stall_fraction``
    (rewrite cycles over rewrite + ATTN compute — the §I number on a
    serial trace) but counts only *exposed* rewrites, so a ping-pong
    trace whose rewrites all ride the shadow bus attributes ~0 stall
    instead of reporting its overlap ratio as a stall."""
    busy: Dict[str, int] = defaultdict(int)
    per_class: Dict[str, Dict[str, int]] = defaultdict(
        lambda: defaultdict(int))
    rewrite_total = rewrite_exposed = 0
    for e in trace.events:
        cyc = e.cycles
        res = base_resource(e.resource)
        busy[res] += cyc
        c = per_class[op_class(e.op)]
        if e.kind in ("compute", "rewrite", "dma", "forward"):
            c[e.kind] += cyc
        if e.kind == "compute" and res == ATTN_RESOURCE:
            c["attn_compute"] += cyc
        if e.kind == "rewrite":
            rewrite_total += cyc
            if res != OVERLAP_RESOURCE:
                rewrite_exposed += cyc
                c["rewrite_exposed"] += cyc
    makespan = trace.makespan
    util = {r: (b / makespan if makespan else 0.0)
            for r, b in sorted(busy.items())}
    critical = bottleneck_of(trace)
    attn_comp = sum(c.get("attn_compute", 0) for c in per_class.values())
    denom = rewrite_exposed + attn_comp
    return AttributionReport(
        makespan=makespan,
        busy=dict(sorted(busy.items())),
        utilization=util,
        critical_resource=critical,
        critical_share=util.get(critical, 0.0),
        rewrite_total=rewrite_total,
        rewrite_exposed=rewrite_exposed,
        rewrite_overlapped=rewrite_total - rewrite_exposed,
        rewrite_stall_fraction=(rewrite_exposed / denom if denom else 0.0),
        by_op_class={k: OpClassBreakdown(op_class=k, **v)
                     for k, v in sorted(per_class.items())},
    )


def bottleneck_of(trace) -> str:
    """The critical resource: most busy cycles, ties broken toward the
    compute resources (a tied macro array beats a tied port — compute is
    what you'd rebalance first).  Sharded traces fold per-chip resources
    to their base names and the NoC links to ``INTERCONNECT``, so a
    mesh whose wire plan dominates reports interconnect-bound."""
    busy: Dict[str, int] = defaultdict(int)
    for r, b in trace.aggregates.busy.items():
        busy[base_resource(r)] += b
    if not busy:
        return ""
    order = {r: i for i, r in enumerate(
        COMPUTE_RESOURCES + (OVERLAP_RESOURCE, "NOC", "HBM",
                             INTERCONNECT))}
    return max(sorted(busy),
               key=lambda r: (busy[r], -order.get(r, len(order))))


def rewrite_stall_by_op(trace) -> Dict[str, float]:
    """Per-op-class §I stall fractions (0.0 for rewrite-free classes)."""
    return {k: v.rewrite_stall_fraction
            for k, v in attribute(trace).by_op_class.items()}


def format_report(report: AttributionReport, *, title: str = "") -> str:
    """Render the attribution as the ``python -m repro_torch.obs`` text
    view."""
    lines: List[str] = []
    if title:
        lines.append(title)
    lines.append(f"makespan: {report.makespan} cycles   "
                 f"critical: {report.critical_resource} "
                 f"({report.critical_share:.1%} busy)")
    lines.append(f"rewrite: {report.rewrite_total} cycles "
                 f"({report.rewrite_exposed} exposed / "
                 f"{report.rewrite_overlapped} overlapped), "
                 f"stall fraction {report.rewrite_stall_fraction:.1%}")
    lines.append("")
    lines.append(f"{'resource':<9} {'busy':>12} {'util':>7}")
    for r, b in report.busy.items():
        lines.append(f"{r:<9} {b:>12} {report.utilization[r]:>6.1%}")
    lines.append("")
    lines.append(f"{'op class':<10} {'compute':>11} {'rewrite':>10} "
                 f"{'dma':>10} {'forward':>10} {'rw stall':>9}")
    for k, c in report.by_op_class.items():
        lines.append(f"{k:<10} {c.compute:>11} {c.rewrite:>10} "
                     f"{c.dma:>10} {c.forward:>10} "
                     f"{c.rewrite_stall_fraction:>8.1%}")
    return "\n".join(lines)
