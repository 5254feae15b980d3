"""Per-tile event traces + utilization/latency summaries for ``repro.sim``.

Every scheduled task becomes one ``Event`` with its resource, cycle
interval, byte count (for DMA/NoC/rewrite events) and a free-form tag
(``layer:op:tile``).  ``Trace`` aggregates the events into the numbers the
benchmarks and tests consume: makespan, per-resource busy cycles and
utilization, DMA bytes (optionally filtered by op class), and the rewrite
stall fraction that reproduces the paper's §I analysis.

Reductions are served from a cached single-pass aggregate (rebuilt lazily,
invalidated by any mutation of the event list — ``add``, direct
``trace.events.append``, slice assignment, ``sort`` — via the
version-counting ``_EventList``): a DSE sweep (``repro.dse``) summarizes
thousands of simulated traces, so per-call O(events) scans would go
quadratic.  The energy fold (``repro.sim.energy``) reads the cached
makespan and does its own single event pass (per-op attribution needs
per-event costs).

Every event also carries ``deps`` — the task ids of the events whose
completion gated its start (data dependencies, with zero-cost SYNC
barriers resolved transitively, plus the in-order resource-occupancy
predecessor).  This makes any ``Trace`` a scheduling DAG: for every
event, ``start == 0`` or ``start == max(end of some dep)``, which is what
``repro.obs.critpath`` and ``repro.obs.whatif`` build on.

Copy of ``repro/sim/trace.py``, pure Python: the same code, its imports
pointed at the port's copies (``repro_torch``).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple


# ``slots=True``: a DSE sweep materializes millions of events; dropping
# the per-instance ``__dict__`` cuts event memory roughly in half and
# speeds attribute access in the scheduler/replay hot loops.
@dataclasses.dataclass(frozen=True, slots=True)
class Event:
    task_id: int
    kind: str          # "compute" | "rewrite" | "dma" | "forward"
    resource: str      # "GEN" | "ATTN" | "BUS" | "NOC" | "HBM" | ...
    start: int
    end: int
    bytes: int = 0
    tag: str = ""      # "cox0_co:xdma:q0k1" — op, kind, tile
    deps: Tuple[int, ...] = ()   # predecessor task ids (data + resource)

    @property
    def cycles(self) -> int:
        return self.end - self.start

    @property
    def op(self) -> str:
        """First tag segment: the op this event belongs to.  A tag with
        no ``:`` separators (including the empty tag) is returned raw —
        never an exception, never a silent index assumption."""
        return self.tag.split(":", 1)[0]

    @property
    def kind_tag(self) -> str:
        """Second tag segment — the schedule-step name the scheduler
        tagged this event with (``xdma``, ``rw``, ``qkpv``, ...).  Empty
        for tags with fewer than two segments."""
        parts = self.tag.split(":")
        return parts[1] if len(parts) > 1 else ""

    @property
    def tile(self) -> str:
        """Everything after the kind segment — the tile coordinate
        (``q0k1``, ``s2:kvdma:k0``'s trailing ``k0``-style indices stay
        joined verbatim).  Empty for tags with fewer than three
        segments."""
        parts = self.tag.split(":")
        return ":".join(parts[2:]) if len(parts) > 2 else ""


class _EventList(list):
    """A ``list`` that counts its mutations.

    ``Trace`` keys its cached aggregates on ``version`` so *any* mutation
    — ``append``/``extend`` (replay paths call ``trace.events.append``
    directly), but also same-length in-place replacement
    (``trace.events[i] = ...``), ``sort``, ``remove`` — invalidates the
    cache.  The previous length-only check missed every mutation that
    kept ``len()`` constant.
    """

    __slots__ = ("version",)

    def __init__(self, iterable=()):
        super().__init__(iterable)
        self.version = 0

    def _bump(self):
        self.version += 1

    def append(self, item):
        super().append(item)
        self._bump()

    def extend(self, iterable):
        super().extend(iterable)
        self._bump()

    def insert(self, index, item):
        super().insert(index, item)
        self._bump()

    def remove(self, item):
        super().remove(item)
        self._bump()

    def pop(self, index=-1):
        item = super().pop(index)
        self._bump()
        return item

    def clear(self):
        super().clear()
        self._bump()

    def sort(self, **kwargs):
        super().sort(**kwargs)
        self._bump()

    def reverse(self):
        super().reverse()
        self._bump()

    def __setitem__(self, index, value):
        super().__setitem__(index, value)
        self._bump()

    def __delitem__(self, index):
        super().__delitem__(index)
        self._bump()

    def __iadd__(self, other):
        result = super().__iadd__(other)
        self._bump()
        return result

    def __imul__(self, other):
        result = super().__imul__(other)
        self._bump()
        return result


@dataclasses.dataclass
class _Aggregates:
    """One-pass reduction over the event list (see ``Trace._agg``)."""

    makespan: int = 0
    busy: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes_by_resource: Dict[str, int] = dataclasses.field(default_factory=dict)
    rewrite_cycles: int = 0
    compute_cycles: Dict[str, int] = dataclasses.field(default_factory=dict)
    dma_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)


class Trace:
    """Event log with cached summary reductions."""

    def __init__(self) -> None:
        self._events = _EventList()
        self._agg: Optional[_Aggregates] = None
        self._agg_version = -1        # list version the cache was built at

    @property
    def events(self) -> "_EventList":
        return self._events

    @events.setter
    def events(self, value) -> None:
        # Wholesale replacement (tests / ad-hoc trace surgery): rewrap so
        # future in-place mutations keep invalidating the cache.
        self._events = _EventList(value)
        self._agg = None

    def add(self, ev: Event) -> None:
        self._events.append(ev)

    @property
    def aggregates(self) -> _Aggregates:
        # Rebuilt lazily; the version check catches every mutation of the
        # event list, including same-length in-place replacement that the
        # old length-only check missed.
        if self._agg is None or self._agg_version != self._events.version:
            self._agg = self._reduce()
            self._agg_version = self._events.version
        return self._agg

    def _reduce(self) -> _Aggregates:
        a = _Aggregates()
        busy = defaultdict(int)
        nbytes = defaultdict(int)
        comp = defaultdict(int)
        dma = defaultdict(int)
        for e in self.events:
            if e.end > a.makespan:
                a.makespan = e.end
            cyc = e.end - e.start
            busy[e.resource] += cyc
            nbytes[e.resource] += e.bytes
            if e.kind == "rewrite":
                a.rewrite_cycles += cyc
            elif e.kind == "compute":
                comp[e.resource] += cyc
            if e.resource == "HBM":
                dma[e.op] += e.bytes
        a.busy = dict(busy)
        a.bytes_by_resource = dict(nbytes)
        a.compute_cycles = dict(comp)
        a.dma_by_op = dict(dma)
        return a

    # ---------- reductions (cache-served) ----------

    @property
    def makespan(self) -> int:
        return self.aggregates.makespan

    def busy_cycles(self, resource: str) -> int:
        return self.aggregates.busy.get(resource, 0)

    def utilization(self, resource: str) -> float:
        span = self.makespan
        return self.busy_cycles(resource) / span if span else 0.0

    def bytes_moved(self, resource: str = "HBM",
                    pred: Optional[Callable[[Event], bool]] = None) -> int:
        if pred is None:
            return self.aggregates.bytes_by_resource.get(resource, 0)
        return sum(e.bytes for e in self.events
                   if e.resource == resource and pred(e))

    def dma_bytes_by_op(self) -> Dict[str, int]:
        """HBM bytes keyed by the op field (first tag segment)."""
        return dict(self.aggregates.dma_by_op)

    def rewrite_stall_fraction(self, compute_resource: str = "ATTN") -> float:
        """Paper §I metric: rewrite cycles / (rewrite + compute) cycles on
        the attention macro array.  Under serial scheduling this is the
        stall fraction; under ping-pong it is just the overlap ratio."""
        a = self.aggregates
        rw = a.rewrite_cycles
        comp = a.compute_cycles.get(compute_resource, 0)
        return rw / (rw + comp) if rw + comp else 0.0

    def utilizations(self) -> Dict[str, float]:
        """Per-resource utilization for every resource seen in the trace."""
        span = self.makespan
        return {r: (b / span if span else 0.0)
                for r, b in sorted(self.aggregates.busy.items())}

    def summary(self) -> Dict[str, float]:
        a = self.aggregates
        s: Dict[str, float] = {"makespan_cycles": float(a.makespan)}
        for r in sorted(a.busy):
            s[f"busy_{r}"] = float(a.busy[r])
            s[f"util_{r}"] = self.utilization(r)
        s["hbm_bytes"] = float(self.bytes_moved("HBM"))
        s["rewrite_stall_frac"] = self.rewrite_stall_fraction()
        return s

    # ---------- rendering ----------

    def format_events(self, limit: int = 40) -> str:
        lines = [f"{'cycle':>10}  {'res':<5} {'kind':<8} {'bytes':>9}  tag"]
        for e in sorted(self.events, key=lambda e: (e.start, e.resource))[:limit]:
            lines.append(f"{e.start:>10}  {e.resource:<5} {e.kind:<8} "
                         f"{e.bytes:>9}  {e.tag}")
        if len(self.events) > limit:
            lines.append(f"... ({len(self.events) - limit} more events)")
        return "\n".join(lines)
