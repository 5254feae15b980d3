"""Lightweight counter/gauge/histogram registry + per-request lifecycle
metrics (copy of ``repro/obs/metrics.py``, DESIGN.md §12).

Serving claims need SLO numbers, not aggregate scalars: TTFT (admit →
first token), TPOT (mean inter-token gap), queue delay (arrival →
admission) at p50/p95/p99.  This module provides the two halves:

* a tiny **metrics registry** — ``Counter`` / ``Gauge`` / ``Histogram``
  with *exact* quantile summaries (values are kept, not sketched: serving
  smokes record hundreds of samples, not millions) — used by
  ``serve.Engine`` and ``sim.simulate_serve``;
* **request lifecycle spans** — ``RequestSpan`` records one request's
  queue→admit→first-token→finish timeline in an arbitrary time unit
  (engine steps, simulated cycles, wall seconds), and
  ``spans_from_steps`` derives them from *executed* step records (the
  engine's ``step_log`` or the simulator's ``ServeSimResult.steps``, both
  of which expose ``step``/``admitted``/``decoded``), never from the
  planned schedule — so an execution bug cannot hide behind a correct
  plan.

Step-domain convention: step ``t`` spans the half-open interval
``[t, t+1)`` and a token lands at the *end* of the step that produces it.
TTFT in steps is therefore exactly 1 (prefill emits token #1 in its
admission step) — the step-domain summaries exist for the engine==sim
parity assertion (``assert_serve_parity``); the *interesting* TTFT/TPOT
distributions are the simulator's cycle-domain ones and the engine's
wall-clock ones, which share the same ``RequestSpan`` shape.

This module is dependency-light on purpose (no jax, no simulator): both
the engine and the simulator import it without dragging the other in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

#: Version stamp for serialized metric summaries (artifact tooling).
METRICS_SCHEMA_VERSION = 1

#: The quantiles every summary reports (exact, linear interpolation).
SUMMARY_QUANTILES = (0.50, 0.95, 0.99)


def percentile(values: Sequence[float], q: float) -> float:
    """Exact q-quantile (0 <= q <= 1) with linear interpolation between
    order statistics (numpy's default method, without numpy).  Returns
    0.0 for an empty sample — summaries of zero-request runs must be
    well-defined zeros, not NaNs."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q!r}")
    if not values:
        return 0.0
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return float(s[lo])
    frac = pos - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


def summarize(values: Sequence[float]) -> Dict[str, float]:
    """Exact-quantile summary: count/mean/p50/p95/p99/max (all-zero for
    an empty sample)."""
    out: Dict[str, float] = {"count": float(len(values))}
    out["mean"] = sum(values) / len(values) if values else 0.0
    for q in SUMMARY_QUANTILES:
        out[f"p{int(q * 100)}"] = percentile(values, q)
    out["max"] = float(max(values)) if values else 0.0
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotone event count."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only increase "
                             f"(inc {n})")
        self.value += n


class Gauge:
    """Last-write-wins scalar (queue depth, cache size, ...)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Exact-quantile sample (values retained; see module docstring)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.values: List[float] = []

    def observe(self, value: float) -> None:
        self.values.append(float(value))

    def percentile(self, q: float) -> float:
        return percentile(self.values, q)

    def summary(self) -> Dict[str, float]:
        return summarize(self.values)


class MetricsRegistry:
    """Get-or-create registry; one per engine run / simulated timeline."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram(name))

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema_version": METRICS_SCHEMA_VERSION,
            "counters": {n: c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self._histograms.items())},
        }


# ---------------------------------------------------------------------------
# Request lifecycle spans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RequestSpan:
    """One request's executed lifecycle in an arbitrary time unit.

    ``arrival``/``admit`` are the *starts* of the respective events;
    ``first_token``/``finish`` are token-emission instants (end of the
    step that produced the token).  ``tokens`` counts emitted tokens
    (prefill's token #1 included)."""

    rid: int
    arrival: float
    admit: float
    first_token: float
    finish: float
    tokens: int
    unit: str = "steps"

    def __post_init__(self):
        if not (self.arrival <= self.admit <= self.first_token
                <= self.finish):
            raise ValueError(
                f"request {self.rid}: lifecycle must be ordered "
                f"arrival <= admit <= first_token <= finish, got "
                f"({self.arrival}, {self.admit}, {self.first_token}, "
                f"{self.finish})")
        if self.tokens < 1:
            raise ValueError(f"request {self.rid}: tokens must be >= 1")

    @property
    def queue_delay(self) -> float:
        """Arrival → admission (time spent waiting for a slot)."""
        return self.admit - self.arrival

    @property
    def ttft(self) -> float:
        """Time to first token: admission → token #1 (DESIGN.md §12)."""
        return self.first_token - self.admit

    @property
    def tpot(self) -> float:
        """Time per output token: mean inter-token gap over the decode
        phase (0 for a single-token request — no gaps exist)."""
        if self.tokens < 2:
            return 0.0
        return (self.finish - self.first_token) / (self.tokens - 1)

    @property
    def e2e(self) -> float:
        """Arrival → last token."""
        return self.finish - self.arrival

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d.update(queue_delay=self.queue_delay, ttft=self.ttft,
                 tpot=self.tpot, e2e=self.e2e)
        return d


def spans_from_steps(steps: Iterable[object],
                     arrivals: Optional[Mapping[int, int]] = None,
                     ) -> List[RequestSpan]:
    """Derive step-domain ``RequestSpan``s from executed step records.

    ``steps`` is any iterable of records exposing ``step`` (int),
    ``admitted`` (rids prefilled) and ``decoded`` (rids advanced one
    token) — both the engine's ``StepRecord`` log and the simulator's
    ``ServeStepSim`` list qualify.  ``arrivals`` maps rid → arrival step
    (missing rids arrive at their admission step).  Finish is the last
    step a request appears in; tokens = 1 + its decode count."""
    arrivals = arrivals or {}
    admit: Dict[int, int] = {}
    last: Dict[int, int] = {}
    decodes: Dict[int, int] = {}
    for rec in steps:
        for rid in rec.admitted:
            admit[rid] = rec.step
            last[rid] = rec.step
            decodes.setdefault(rid, 0)
        for rid in rec.decoded:
            decodes[rid] = decodes.get(rid, 0) + 1
            last[rid] = rec.step
    return [RequestSpan(rid=rid,
                        arrival=float(arrivals.get(rid, admit[rid])),
                        admit=float(admit[rid]),
                        first_token=float(admit[rid] + 1),
                        finish=float(last[rid] + 1),
                        tokens=1 + decodes[rid],
                        unit="steps")
            for rid in sorted(admit)]


def spans_from_timeline(admit_step: Mapping[int, int],
                        finish_step: Mapping[int, int],
                        decode_steps: Mapping[int, int],
                        arrivals: Mapping[int, int],
                        bounds: Mapping[int, "Sequence[float]"],
                        first_token: Optional[Mapping[int, float]] = None,
                        unit: str = "cycles") -> List[RequestSpan]:
    """Map request lifecycles onto measured per-step time bounds.

    ``bounds`` maps each *executed* step to its ``(start, end)`` time in
    the target unit (simulated cycle bounds, wall-clock seconds, ...).
    A request's admission lands at its admit step's start; its arrival at
    the start of the first executed step at/after its arrival step (the
    scheduler jumps idle gaps, so the arrival step itself may never
    execute); its first token at ``first_token[rid]`` when the caller
    measured the prefill's actual completion, else at the admit step's
    end; its finish at its last step's end."""
    executed = sorted(bounds)
    first_token = first_token or {}
    spans: List[RequestSpan] = []
    for rid in sorted(admit_step):
        a = admit_step[rid]
        admit_t = float(bounds[a][0])
        arr_t = admit_t
        for s in executed:
            if s >= arrivals.get(rid, a):
                arr_t = min(float(bounds[s][0]), admit_t)
                break
        spans.append(RequestSpan(
            rid=rid, arrival=arr_t, admit=admit_t,
            first_token=float(first_token.get(rid, bounds[a][1])),
            finish=float(bounds[finish_step[rid]][1]),
            tokens=1 + decode_steps.get(rid, 0), unit=unit))
    return spans


#: The lifecycle metrics every serving summary reports.
SPAN_METRICS = ("queue_delay", "ttft", "tpot", "e2e")


def summarize_spans(spans: Sequence[RequestSpan],
                    unit: Optional[str] = None) -> Dict[str, object]:
    """Reduce spans to the serving SLO summary: requests + one
    exact-quantile summary per lifecycle metric.  Well-defined zeros for
    an empty span list (zero-request runs)."""
    out: Dict[str, object] = {
        "schema_version": METRICS_SCHEMA_VERSION,
        "requests": len(spans),
        "unit": unit or (spans[0].unit if spans else "steps"),
        "tokens": sum(s.tokens for s in spans),
    }
    for metric in SPAN_METRICS:
        out[metric] = summarize([getattr(s, metric) for s in spans])
    return out


def observe_spans(registry: "MetricsRegistry",
                  spans: Sequence[RequestSpan], prefix: str = "") -> None:
    """Fold lifecycle spans into a registry: ``requests``/``tokens``
    counters plus one histogram per lifecycle metric (the shared path by
    which ``serve.Engine`` and ``sim.simulate_serve`` record spans)."""
    registry.counter(prefix + "requests").inc(len(spans))
    registry.counter(prefix + "tokens").inc(sum(s.tokens for s in spans))
    for s in spans:
        for metric in SPAN_METRICS:
            registry.histogram(prefix + metric).observe(getattr(s, metric))


def assert_serve_parity(engine_stats: Mapping[str, object],
                        sim_metrics: Mapping[str, object]) -> None:
    """The engine==simulator SLO parity assertion (DESIGN.md §12): the
    step-domain lifecycle summaries both sides derived from their own
    *executed* records must agree exactly — requests, token counts, and
    every quantile of every metric.  Raises AssertionError naming the
    first divergence."""
    for key in ("requests", "tokens"):
        if engine_stats.get(key) != sim_metrics.get(key):
            raise AssertionError(
                f"engine/sim {key} diverge: engine "
                f"{engine_stats.get(key)!r} != sim {sim_metrics.get(key)!r}")
    for metric in SPAN_METRICS:
        e = engine_stats.get(metric)
        s = sim_metrics.get(metric)
        if e is None or s is None:
            raise AssertionError(
                f"missing step-domain summary {metric!r}: engine has "
                f"{sorted(engine_stats)} / sim has {sorted(sim_metrics)}")
        if dict(e) != dict(s):
            raise AssertionError(
                f"engine/sim {metric} percentiles diverge: "
                f"engine {dict(e)} != sim {dict(s)}")
