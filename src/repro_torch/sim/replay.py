"""Record kernel timings, attach them to ``ExecutionPlan`` layers, replay
them through ``simulate_plan``, and fit a calibration of the analytic
timing model (counterpart of ``repro/sim/replay.py``).

The loop has four steps, as in the JAX package:

1. **Record**: ``KernelRecorder`` instruments the port's kernel paths
   (``kernels.ops.attention_by_plan``, ``decode_attention_by_plan``,
   ``batched_decode_attention_by_plan``, and the ``tile_gemm`` and
   ``stream_attention`` wrappers): inside a ``recording()`` block each
   executed op emits a ``KernelTrace`` (grid, tiles, cycles, bytes moved,
   FLOPs).  ``record_plan`` drives a whole plan's op list through the
   kernels at the plan's own geometry.
2. **Attach**: ``ExecutionPlan.attach_traces`` matches records to plan ops
   by name; traces serialize with the plan.
3. **Replay**: ``simulate_plan`` lowers a traced op to its recorded timing
   in place of the analytic task graph.
4. **Calibrate**: ``fit_calibration`` compares recorded and analytic
   cycles per op class and fits a per-resource cycle scale.

What differs from the JAX copy is the timing source.  On CUDA tensors
``KernelRecorder.measure`` times the thunk with pairs of
``torch.cuda.Event(enable_timing=True)`` on the current stream, after its
warm-up calls, and records ``source="cuda_events"``; on CPU tensors it
takes ``time.perf_counter`` around each call (``source="wall_time"``), as
the JAX copy does.  Either way cycles are seconds x ``clock_hz``.  Where
JAX skips traced (jitted) operands, ``recorder_for`` skips a stream that
is capturing a CUDA graph and code that ``torch.compile`` is tracing.
``record_plan`` takes a ``device`` where JAX takes ``use_pallas``: CUDA
tensors run the kernels, CPU tensors their plain versions.

``cost_analysis_cycles`` takes its FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` over one call, where the JAX
copy reads XLA's compiled cost analysis (matrix products count the same;
XLA adds elementwise FLOPs, which the counter leaves out).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import torch

KERNEL_TRACE_VERSION = 1

#: Napkin CIM clock for seconds -> cycles (the simulator is unclocked;
#: ratios between records of one platform are what matter).
DEFAULT_CLOCK_HZ = 1e9

#: Op classes a ``KernelTrace`` can describe; the replay lowering charges
#: the recorded cycles to the class's primary macro-array resource.
TRACE_KINDS = ("attention", "gemm", "decode")
_KIND_RESOURCE = {"attention": "ATTN", "gemm": "GEN", "decode": "ATTN"}


# ---------------------------------------------------------------------------
# KernelTrace
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelTrace:
    """One recorded kernel execution (the unit the replay lowering eats).

    ``op`` names the plan op the record belongs to; kernel-level
    sub-records use ``parent/kernel`` labels and never attach to a plan.
    ``cycles`` is the recorded duration in CIM clock cycles (seconds x
    ``clock_hz``); ``hbm_bytes`` the bytes the executed tensors moved.
    ``grid``, ``block_q`` and ``block_kv`` are the launch geometry: on the
    card that of the CUDA route that ran, on the CPU the JAX package's
    Pallas grid for the same shapes.
    """

    op: str
    kind: str                  # "attention" | "gemm" | "decode"
    mode: str                  # ExecutionMode value ("" for bare kernels)
    grid: Tuple[int, ...]      # kernel grid actually launched
    block_q: int               # q-tile edge actually used (gemm: block_m)
    block_kv: int              # kv-tile edge actually used (gemm: block_n)
    cycles: int                # recorded duration, CIM clock cycles
    hbm_bytes: int             # bytes moved by the executed tensors
    wall_time_s: float = 0.0   # measured seconds
    flops: int = 0
    clock_hz: float = DEFAULT_CLOCK_HZ
    source: str = "wall_time"  # "wall_time" | "cuda_events" | "manual"

    def __post_init__(self):
        if self.kind not in TRACE_KINDS:
            raise ValueError(f"{self.op}: kind must be one of "
                             f"{TRACE_KINDS}, got {self.kind!r}")
        if self.cycles <= 0:
            raise ValueError(f"{self.op}: recorded cycles must be > 0, "
                             f"got {self.cycles!r}")
        if self.hbm_bytes < 0:
            raise ValueError(f"{self.op}: hbm_bytes must be >= 0, "
                             f"got {self.hbm_bytes!r}")

    @property
    def resource(self) -> str:
        """The macro-array resource replay charges the cycles to."""
        return _KIND_RESOURCE[self.kind]

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["version"] = KERNEL_TRACE_VERSION
        d["grid"] = list(self.grid)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "KernelTrace":
        d = dict(d)
        version = d.pop("version", KERNEL_TRACE_VERSION)
        if version != KERNEL_TRACE_VERSION:
            raise ValueError(f"unsupported KernelTrace version {version!r}")
        d["grid"] = tuple(int(g) for g in d.get("grid", ()))
        return cls(**d)


# ---------------------------------------------------------------------------
# Recorder + active-recorder registry (the kernel instrumentation hook)
# ---------------------------------------------------------------------------

Geometry = Tuple[Tuple[int, ...], int, int]     # (grid, block_q, block_kv)


class KernelRecorder:
    """Collects ``KernelTrace`` records from instrumented kernel paths.

    The instrumented entry points consult ``recorder_for``: inside a
    ``recording(rec)`` block every call appends a record.  ``measure``
    times a thunk with warm-up and the median of ``iters`` and suppresses
    nested kernel-level records, so one op yields one op-level trace.
    """

    def __init__(self, clock_hz: float = DEFAULT_CLOCK_HZ, *,
                 iters: int = 1, warmup: int = 1) -> None:
        if clock_hz <= 0:
            raise ValueError(f"clock_hz must be > 0, got {clock_hz!r}")
        self.clock_hz = clock_hz
        self.iters = max(1, iters)
        self.warmup = max(0, warmup)
        self.records: List[KernelTrace] = []
        self._labels: List[str] = []
        self._suppressed = 0

    # ---- labels: record_plan names the op before entering a kernel ----

    @contextlib.contextmanager
    def label(self, name: str) -> Iterator[None]:
        self._labels.append(name)
        try:
            yield
        finally:
            self._labels.pop()

    def current_label(self, default: str) -> str:
        return f"{self._labels[-1]}/{default}" if self._labels else default

    # ---- record/measure ----

    @property
    def suppressed(self) -> bool:
        return self._suppressed > 0

    def add(self, trace: KernelTrace) -> None:
        if not self.suppressed:
            self.records.append(trace)

    def seconds_to_cycles(self, seconds: float) -> int:
        return max(1, int(round(seconds * self.clock_hz)))

    def _times(self, fn: Callable[[], object], cuda: bool
               ) -> Tuple[object, List[float]]:
        """(last result, seconds of each of ``iters`` timed calls)."""
        out = None
        for _ in range(self.warmup):
            out = fn()
        if not cuda:
            times = []
            for _ in range(self.iters):
                t0 = time.perf_counter()
                out = fn()
                times.append(time.perf_counter() - t0)
            return out, times
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.iters)]
        for start, end in pairs:
            start.record()
            out = fn()
            end.record()
        torch.cuda.synchronize()
        return out, [start.elapsed_time(end) / 1e3 for start, end in pairs]

    def measure(self, fn: Callable[[], object], *, op: str, kind: str,
                mode: str = "", grid: Tuple[int, ...] = (),
                block_q: int = 0, block_kv: int = 0, hbm_bytes: int = 0,
                flops: int = 0, device: Optional[torch.device] = None,
                launched: Optional[Callable[[], Optional[Geometry]]] = None
                ) -> object:
        """Run ``fn`` (warm-up + iters), record the median time as one
        op-level ``KernelTrace``, and return the *last* result.  Nested
        kernel-level instrumentation is suppressed for the duration.

        ``device``: a CUDA device times with CUDA events, anything else
        with the host clock.  ``launched``: called after the timed calls;
        a (grid, block_q, block_kv) it returns replaces the given ones
        (the geometry of the CUDA route that ran)."""
        cuda = device is not None and torch.device(device).type == "cuda"
        self._suppressed += 1
        try:
            out, times = self._times(fn, cuda)
        finally:
            self._suppressed -= 1
        times.sort()
        seconds = times[len(times) // 2]
        geometry = launched() if launched is not None else None
        if geometry is not None:
            grid, block_q, block_kv = geometry
        self.records.append(KernelTrace(
            op=op, kind=kind, mode=mode, grid=tuple(grid),
            block_q=block_q, block_kv=block_kv,
            cycles=self.seconds_to_cycles(seconds), hbm_bytes=hbm_bytes,
            wall_time_s=seconds, flops=flops, clock_hz=self.clock_hz,
            source="cuda_events" if cuda else "wall_time"))
        return out

    def by_op(self) -> Dict[str, KernelTrace]:
        """Latest record per op name (kernel-level ``parent/kernel``
        sub-records keep their slash-labels and never shadow op names)."""
        return {t.op: t for t in self.records}


_ACTIVE: List[KernelRecorder] = []


def active_recorder() -> Optional[KernelRecorder]:
    """The innermost active recorder, or None (the common case: the
    instrumented kernels call this on every invocation)."""
    return _ACTIVE[-1] if _ACTIVE else None


def recorder_for(*tensors) -> Optional[KernelRecorder]:
    """Kernel-side hook: the active recorder iff recording applies to this
    call.  None when no recorder is active, when it is suppressed (the
    call is already timed at op level), when ``torch.compile`` is tracing,
    or when the current CUDA stream is capturing a graph (nothing runs
    then to be timed).  The kernels consult this through ``sys.modules``,
    so an un-imported replay module costs them one dict lookup."""
    rec = active_recorder()
    if rec is None or rec.suppressed:
        return None
    if torch.compiler.is_compiling():
        return None
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors) \
            and torch.cuda.is_current_stream_capturing():
        return None
    return rec


@contextlib.contextmanager
def recording(recorder: Optional[KernelRecorder] = None, *,
              clock_hz: float = DEFAULT_CLOCK_HZ) -> Iterator[KernelRecorder]:
    """Activate a recorder for the dynamic extent of the block."""
    rec = recorder if recorder is not None else KernelRecorder(clock_hz)
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.pop()


# ---------------------------------------------------------------------------
# record_plan: drive a plan's op list through the kernels
# ---------------------------------------------------------------------------

def gemm_geometry(M: int, K: int, N: int) -> Geometry:
    """The JAX package's Pallas grid and blocks of ``tile_gemm`` for
    (M, K) @ (K, N) at its default blocks: what a GEMM record carries where
    no CUDA launch supplies its own (CPU tensors)."""
    bm, bn, bk = min(256, M), min(256, N), min(512, K)
    return (-(-N // bn), -(-M // bm), -(-K // bk)), bm, bn


def record_plan(plan, *, ops: Optional[Sequence[str]] = None,
                max_ops: Optional[int] = None, iters: int = 1,
                warmup: int = 1, clock_hz: float = DEFAULT_CLOCK_HZ,
                seed: int = 0, dtype: Optional[torch.dtype] = None,
                device=None):
    """Execute each planned op's kernel at the plan's own geometry
    (batch 1) under a recorder and return ``(traced_plan, recorder)``.

    ``ops`` restricts recording to the named plan ops; ``max_ops`` caps
    the count (plan order, attention before gemms); untraced ops keep the
    analytic lowering at replay time.  ``device`` defaults to the card
    (``runtime.resolve_device``); CPU tensors run the plain versions, so
    plan at a small ``seq_len`` there.  Inputs are standard normal, drawn
    from a ``torch.Generator`` seeded with ``seed`` on the device, in
    ``dtype`` (default f32).

    Byte and FLOP accounting are the JAX package's
    (``repro/sim/replay.py:250-330``): gemms x + w + out and 2·M·K·N;
    attention the mode's analytic traffic (``attention_by_plan``) and
    QK^T + PV + the K/V generation.
    """
    from repro_torch.core import runtime
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels._build import launch_hook
    from repro_torch.kernels.tile_gemm import tile_gemm

    device = runtime.resolve_device(device)
    dtype = dtype or torch.float32
    rec = KernelRecorder(clock_hz, iters=iters, warmup=warmup)
    wanted = set(ops) if ops is not None else None
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def selected(name: str, taken: int) -> bool:
        if wanted is not None and name not in wanted:
            return False
        return max_ops is None or taken < max_ops

    taken = 0
    with recording(rec), torch.no_grad():
        for lp in plan.layers:
            if not selected(lp.name, taken):
                continue
            taken += 1
            q = randn(1, lp.heads, lp.seq_q, lp.head_dim)
            x_kv = randn(1, lp.seq_kv, lp.d_kv)
            wk = randn(lp.d_kv, lp.kv_heads, lp.head_dim)
            wv = randn(lp.d_kv, lp.kv_heads, lp.head_dim)
            kops.attention_by_plan(lp, q, x_kv, wk, wv)
        for g in plan.gemms:
            if not selected(g.name, taken):
                continue
            taken += 1
            x, w = randn(g.m, g.k), randn(g.k, g.n)
            itemsize = x.element_size()
            grid, bm, bn = gemm_geometry(g.m, g.k, g.n)
            with rec.label(g.name):
                rec.measure(
                    lambda x=x, w=w: kops.projection(x, w),
                    op=g.name, kind="gemm", mode=g.mode.value,
                    grid=grid, block_q=bm, block_kv=bn,
                    hbm_bytes=(g.m * g.k + g.k * g.n
                               + g.m * g.n) * itemsize,
                    flops=2 * g.m * g.k * g.n, device=device,
                    launched=launch_hook(tile_gemm))
    return plan.attach_traces(rec.records), rec


# ---------------------------------------------------------------------------
# CalibrationReport + fitting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """Analytic-vs-recorded error per op class + fitted per-resource cycle
    scale factors.

    ``per_class[kind]`` carries ``count`` / ``analytic_cycles`` /
    ``recorded_cycles`` / ``ratio`` (recorded/analytic totals) /
    ``mean_abs_rel_err`` over the traced ops of that class.  ``scale``
    maps simulator resources to multiplicative cycle factors; apply with
    ``simulate_plan(plan, calibration=report)``.
    """

    name: str
    model: str
    hw: str
    clock_hz: float
    per_class: Mapping[str, Mapping[str, float]]
    scale: Mapping[str, float]

    def __post_init__(self):
        for r, s in self.scale.items():
            if s <= 0:
                raise ValueError(f"{self.name}: scale[{r!r}] must be > 0, "
                                 f"got {s!r}")

    @property
    def traced_ops(self) -> int:
        return int(sum(c.get("count", 0) for c in self.per_class.values()))

    def ratio(self, kind: str) -> float:
        """Recorded/analytic cycle ratio for one op class (1.0 = the
        analytic model already matches the recording)."""
        return float(self.per_class[kind]["ratio"])

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": KERNEL_TRACE_VERSION,
            "name": self.name, "model": self.model, "hw": self.hw,
            "clock_hz": self.clock_hz,
            "per_class": {k: dict(v) for k, v in self.per_class.items()},
            "scale": dict(self.scale),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "CalibrationReport":
        if d.get("version") != KERNEL_TRACE_VERSION:
            raise ValueError(
                f"unsupported CalibrationReport version {d.get('version')!r}")
        return cls(name=d["name"], model=d["model"], hw=d["hw"],
                   clock_hz=float(d["clock_hz"]),
                   per_class={k: dict(v)
                              for k, v in d["per_class"].items()},
                   scale={k: float(v) for k, v in d["scale"].items()})

    @classmethod
    def from_json(cls, s: str) -> "CalibrationReport":
        return cls.from_dict(json.loads(s))


def _traced_ops(plan) -> List[Tuple[str, KernelTrace]]:
    out = []
    for lp in tuple(plan.layers) + tuple(plan.gemms):
        tr = getattr(lp, "trace", None)
        if tr is not None:
            out.append((lp.name, tr))
    return out


def analytic_op_profile(plan, hw=None) -> Dict[str, Dict[str, object]]:
    """Per-op analytic timing decomposition: simulate the plan with replay
    *off* and reduce the event trace to ``{op: {"span": elapsed cycles,
    "busy": {resource: busy cycles}}}``, the denominator side of every
    calibration fit."""
    from repro_torch.sim.pipeline import simulate_plan
    res = simulate_plan(plan, hw=hw, replay=False)
    prof: Dict[str, Dict[str, object]] = {}
    for e in res.trace.events:
        p = prof.setdefault(e.op, {"start": e.start, "end": e.end,
                                   "busy": {}})
        p["start"] = min(p["start"], e.start)
        p["end"] = max(p["end"], e.end)
        p["busy"][e.resource] = p["busy"].get(e.resource, 0) + e.cycles
    return {op: {"span": p["end"] - p["start"], "busy": p["busy"]}
            for op, p in prof.items()}


def fit_calibration(plan, hw=None, *, name: Optional[str] = None,
                    ridge: float = 1e-3) -> CalibrationReport:
    """Fit a ``CalibrationReport`` from a plan's attached traces.

    Per-class error compares each traced op's recorded cycles with its
    analytic *span* (elapsed cycles under analytic lowering).  The
    per-resource scale solves ``recorded_i ~= sum_r busy[i][r] * s_r``
    by ridge-regularized least squares (prior: the global recorded/
    analytic-span ratio on every resource), so an under-determined
    system degrades to the global ratio instead of oscillating.  Scales
    are clamped positive.
    """
    import numpy as np

    traced = _traced_ops(plan)
    if not traced:
        raise ValueError(f"{plan.model}: no attached KernelTrace records — "
                         "record_plan / attach_traces first")
    prof = analytic_op_profile(plan, hw=hw)
    hw_name = hw.name if hw is not None else plan.hw

    resources = sorted({r for op, _ in traced
                        for r in prof[op]["busy"]})
    a = np.zeros((len(traced), len(resources)))
    b = np.zeros(len(traced))
    per_class: Dict[str, Dict[str, float]] = {}
    for i, (op, tr) in enumerate(traced):
        span = prof[op]["span"]
        b[i] = tr.cycles
        for j, r in enumerate(resources):
            a[i, j] = prof[op]["busy"].get(r, 0)
        c = per_class.setdefault(tr.kind, {
            "count": 0, "analytic_cycles": 0, "recorded_cycles": 0,
            "abs_rel_err_sum": 0.0})
        c["count"] += 1
        c["analytic_cycles"] += span
        c["recorded_cycles"] += tr.cycles
        c["abs_rel_err_sum"] += abs(tr.cycles - span) / max(span, 1)

    total_ana = sum(c["analytic_cycles"] for c in per_class.values())
    total_rec = sum(c["recorded_cycles"] for c in per_class.values())
    prior = total_rec / max(total_ana, 1)
    for c in per_class.values():
        c["ratio"] = c["recorded_cycles"] / max(c["analytic_cycles"], 1)
        c["mean_abs_rel_err"] = c.pop("abs_rel_err_sum") / c["count"]

    # Ridge-regularized normal equations around the global-ratio prior.
    ata = a.T @ a
    lam = ridge * max(float(np.trace(ata)) / max(len(resources), 1), 1.0)
    sol = np.linalg.solve(ata + lam * np.eye(len(resources)),
                          a.T @ b + lam * prior * np.ones(len(resources)))
    scale = {r: float(max(s, 1e-9)) for r, s in zip(resources, sol)}

    clock = traced[0][1].clock_hz
    return CalibrationReport(
        name=name or f"{plan.model}@{plan.shape}-{hw_name}",
        model=plan.model, hw=hw_name, clock_hz=clock,
        per_class=per_class, scale=scale)


def resolve_calibration(calibration) -> Optional[Mapping[str, float]]:
    """Normalize a ``simulate_plan(calibration=...)`` argument (a
    ``CalibrationReport``, a raw ``{resource: factor}`` mapping, or None)
    into the scale mapping the engine applies."""
    if calibration is None:
        return None
    scale = getattr(calibration, "scale", calibration)
    if not isinstance(scale, Mapping):
        raise TypeError(f"calibration must be a CalibrationReport or a "
                        f"resource->factor mapping, got {calibration!r}")
    return scale


# ---------------------------------------------------------------------------
# Optional cost-analysis timing source (FLOP count -> cycles)
# ---------------------------------------------------------------------------

def cost_analysis_cycles(fn: Callable, *args, hw=None) -> Tuple[int, int]:
    """(cycles, flops) for one kernel call from a FLOP count instead of
    wall time (replay.py:499): the FLOPs ``FlopCounterMode`` counts over
    one call of ``fn(*args)``, divided by the design point's aggregate
    INT8 MAC throughput (``EnergyModel.macro_ops_per_cycle`` x
    ``num_macros``).  A deterministic timing source: no clock noise."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.hardware import STREAMDCIM_BASE
    from repro_torch.sim.energy import STREAMDCIM_ENERGY_BASE

    hw = hw or STREAMDCIM_BASE
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    flops = int(fc.get_total_flops())
    per_cycle = (STREAMDCIM_ENERGY_BASE.macro_ops_per_cycle(hw)
                 * hw.num_macros)
    return max(1, math.ceil(flops / max(per_cycle, 1.0))), flops
