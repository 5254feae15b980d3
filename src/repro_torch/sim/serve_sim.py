"""``simulate_serve``: lower a multi-request serving timeline through the
StreamDCIM schedulers (copy of ``repro/sim/serve_sim.py``, DESIGN.md §11).

The prefill-only simulator answers "how fast is one shape"; serving
traffic is a *timeline* — arrivals, per-prompt prefills, per-step decodes
over growing KV caches, slot recycling.  ``simulate_serve`` drives the
exact continuous-batching schedule the live engine executes
(``repro_torch.serve.schedule.build_schedule`` — the shared scheduling core)
through the existing discrete-event schedulers:

* each admission lowers that request's prefill ``ExecutionPlan`` (compiled
  per prompt length, heterogeneous per-layer modes included);
* each step's active slots lower one ``DecodePlan``
  (``repro_torch.plan.plan_decode_step``): per-layer modes, per-slot KV lengths
  shrunk by DTPU pruning, tile-granular cache rewrites;
* steps chain sequentially on one engine, so TILE/LAYER/NON comparisons,
  ``SimResult.energy()`` and trace calibration all apply to serving
  traffic, not just one prefill.

Cross-assert (always on): each decode step's simulated HBM bytes must
equal its ``DecodePlan.total_hbm_bytes`` prediction — the planner and the
simulator implement the same traffic model or the run fails loudly.
Decode ops carrying recorded ``KernelTrace``s (via ``decode_plans`` /
``attach_traces``) replay their measured timing instead and are exempt.

``decode_lowering="coarse"`` (DESIGN.md §15) collapses each step's
decode sub-graph to one aggregated event per shape bucket instead of
per-layer tasks, keeping long-context × many-slot sweeps tractable.
This is *exact*, not approximate: every step ends in a barrier covering
all its tasks, so a decode sub-graph always starts with every resource
free — its span is context-independent, and simulating the step's
``DecodePlan`` once on a scratch engine (same calibration) yields the
very span the fine lowering would produce in situ.  Spans are memoized
per KV-length tuple; bytes are re-emitted per bucket (analytic per-slot
split, recorded-trace remainder on the last bucket) so the per-step
cross-assert and every byte total stay bit-identical to fine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.hardware import HardwareConfig
from repro_torch.core.types import ExecutionMode, ModelConfig
from repro_torch.obs.metrics import (MetricsRegistry, RequestSpan,
                                     observe_spans, spans_from_steps,
                                     spans_from_timeline, summarize_spans)
from repro_torch.serve.schedule import Schedule, ServeRequest, build_schedule
from repro_torch.sim.dataflow import Engine
from repro_torch.sim.pipeline import (SimResult, _SCHEDULERS, _Scheduler,
                                      _build_replay, _CalibratedEngine)
from repro_torch.sim.workload import (AttnOp, DecodeOp, Workload,
                                      decode_workload_from_plan,
                                      workload_from_plan)

#: tag prefixes keeping each step's events separable in the trace
_PREFILL = "pre.r{rid}."
_DECODE = "dec."


@dataclasses.dataclass(frozen=True)
class ServeStepSim:
    """One simulated engine step."""

    step: int
    admitted: Tuple[int, ...]          # rids prefilled this step
    decoded: Tuple[int, ...]           # rids advanced one token
    kv_lens: Tuple[int, ...]           # per decoded slot: attended KV length
    cycles: int                        # span of this step's task graph
    hbm_bytes: int                     # all HBM bytes the step moved
    prefill_hbm_bytes: int
    decode_hbm_bytes: int
    predicted_decode_hbm_bytes: int    # DecodePlan.total_hbm_bytes
    predicted_rewrite_cycles: int      # DecodePlan.total_rewrite_cycles

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        for k in ("admitted", "decoded", "kv_lens"):
            d[k] = list(d[k])
        return d


@dataclasses.dataclass
class ServeSimResult:
    """The simulated serving timeline plus its derived artifacts."""

    workload: str
    slots: int
    schedule: Schedule
    steps: List[ServeStepSim]
    result: SimResult                  # whole-timeline trace (energy-ready)
    prefill_plans: Dict[int, object]   # prompt_len -> ExecutionPlan
    decode_plans: Dict[Tuple[int, ...], object]  # kv_lens -> DecodePlan
    arrivals: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Cycle-domain lifecycle spans (admission/first-token/finish mapped to
    # simulated cycle bounds) — the *interesting* TTFT/TPOT distributions.
    cycle_spans: List[RequestSpan] = dataclasses.field(default_factory=list)
    registry: Optional[MetricsRegistry] = None

    @property
    def request_spans(self) -> List[RequestSpan]:
        """Step-domain lifecycle spans from the *executed* step records —
        the side compared against ``Engine.stats()`` by
        ``obs.metrics.assert_serve_parity`` (DESIGN.md §12)."""
        return spans_from_steps(self.steps, self.arrivals)

    @property
    def metrics(self) -> Dict[str, object]:
        """Step-domain TTFT/TPOT/queue-delay p50/p95/p99 summary
        (well-defined zeros for a zero-request run)."""
        return summarize_spans(self.request_spans, unit="steps")

    @property
    def cycle_metrics(self) -> Dict[str, object]:
        """Cycle-domain lifecycle summary over ``cycle_spans``."""
        return summarize_spans(self.cycle_spans, unit="cycles")

    @property
    def cycles(self) -> int:
        return self.result.cycles

    @property
    def hbm_bytes(self) -> int:
        return self.result.hbm_bytes

    @property
    def decode_steps(self) -> Dict[int, int]:
        """rid -> decode steps consumed (the engine-agreement number)."""
        return dict(self.schedule.decode_steps)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def energy(self, model=None):
        return self.result.energy(model)

    def requests_per_kilocycle(self) -> float:
        n = len(self.schedule.admit_step)
        return 1000.0 * n / max(self.result.cycles, 1)

    def to_dict(self) -> Dict[str, object]:
        return {
            "workload": self.workload, "slots": self.slots,
            "num_steps": self.num_steps, "cycles": self.cycles,
            "hbm_bytes": self.hbm_bytes,
            "decode_steps": {str(k): v
                             for k, v in self.decode_steps.items()},
            "admit_step": {str(k): v
                           for k, v in self.schedule.admit_step.items()},
            "finish_step": {str(k): v
                            for k, v in self.schedule.finish_step.items()},
            "steps": [s.to_dict() for s in self.steps],
            "prefill_plans": {str(k): p.summary()
                              for k, p in self.prefill_plans.items()},
            "decode_plans": {",".join(map(str, k)): p.summary()
                             for k, p in self.decode_plans.items()},
            "metrics": self.metrics,
            "cycle_metrics": self.cycle_metrics,
            "request_spans": [s.to_dict() for s in self.request_spans],
            "cycle_spans": [s.to_dict() for s in self.cycle_spans],
        }


def _lower(eng: Engine, scheds, wl: Workload, mode_of: Mapping[str, object],
           trace_of: Mapping[str, object], prev: int, *,
           decode: bool = False) -> Tuple[int, int]:
    """Chain one workload's ops onto ``eng`` starting at ``prev``; returns
    (last barrier, replayed op count).  ``decode=True`` lowers GEMMs
    through the shared on-chip lowering for *every* mode: a decode step's
    activations are single token vectors that stay resident even in the
    unfused baseline, so only attention traffic differs between modes —
    which is what keeps the per-step byte cross-assert mode-exact."""
    replayed = 0
    for layer in wl.layers:
        for op in layer.ops:
            kt = trace_of.get(op.name)
            if kt is not None:
                prev = _build_replay(eng, op, kt, prev)
                replayed += 1
                continue
            sched = scheds[mode_of[op.name]]
            if isinstance(op, AttnOp):
                prev = sched.build_attn(eng, op, prev)
            elif isinstance(op, DecodeOp):
                prev = sched.build_decode(eng, op, prev)
            elif decode:
                prev = _Scheduler.build_gemm(sched, eng, op, prev)
            else:
                prev = sched.build_gemm(eng, op, prev)
    return prev, replayed


def simulate_serve(cfg: ModelConfig,
                   requests: Sequence[ServeRequest], *,
                   slots: int = 4,
                   hw: Optional[HardwareConfig] = None,
                   mode: Optional[ExecutionMode] = None,
                   force_mode: bool = False,
                   plan_fn: Optional[Callable[[int], object]] = None,
                   decode_plan_fn: Optional[
                       Callable[[Tuple[int, ...]], object]] = None,
                   calibration=None,
                   decode_lowering: str = "fine") -> ServeSimResult:
    """Simulate serving ``requests`` on ``slots`` continuous-batching
    slots.

    ``mode``/``force_mode`` pass through to the planners (three-way
    serving comparisons pin a mode with ``force_mode=True``).  ``plan_fn``
    / ``decode_plan_fn`` override plan compilation — inject the *live
    engine's own* plan objects (cross-validation) or plans with recorded
    ``KernelTrace``s attached (decode replay).  ``calibration`` applies
    fitted per-resource cycle scales to the analytic task durations
    (DESIGN.md §10); replayed ops stay verbatim.
    ``decode_lowering``: ``"fine"`` (default) lowers every decode step's
    per-layer task graph; ``"coarse"`` emits one aggregated event per
    shape bucket with a memoized exact span — same cycles, bytes, and
    metrics, far fewer trace events (see module docstring).
    """
    from repro_torch.plan.decode import plan_decode_step
    from repro_torch.plan.heuristics import decode_attn_hbm_bytes
    from repro_torch.plan.planner import plan_model, resolve_hw
    from repro_torch.serve.kv_cache import shape_buckets
    from repro_torch.sim.replay import resolve_calibration

    if decode_lowering not in ("fine", "coarse"):
        raise ValueError(f"decode_lowering must be 'fine' or 'coarse', "
                         f"got {decode_lowering!r}")

    hw = hw if isinstance(hw, HardwareConfig) else resolve_hw(hw)
    schedule = build_schedule(requests, slots)
    by_rid = {r.rid: r for r in requests}
    scale = resolve_calibration(calibration)
    eng = _CalibratedEngine(scale) if scale else Engine()
    scheds = {m: _SCHEDULERS[m](hw) for m in ExecutionMode}

    if plan_fn is None:
        plan_fn = lambda p: plan_model(cfg, seq_len=p, hw=hw, mode=mode,
                                       force_mode=force_mode)
    if decode_plan_fn is None:
        decode_plan_fn = lambda kv: plan_decode_step(
            cfg, kv, hw=hw, mode=mode, force_mode=force_mode)

    prefill_plans: Dict[int, object] = {}
    decode_plans: Dict[Tuple[int, ...], object] = {}
    # kv-length tuple -> (exact decode span, per-slot analytic bytes over
    # untraced layers, recorded-trace byte total, replayed-op count),
    # memoized from one scratch-engine run of the step's DecodePlan.
    # Bytes are *recomputed* from the plan's shapes — never read off its
    # hbm_bytes predictions — so the per-step cross-assert below still
    # catches a plan whose prediction disagrees with the traffic model.
    coarse_memo: Dict[Tuple[int, ...],
                      Tuple[int, List[int], int, int]] = {}

    def coarse_spec(kv: Tuple[int, ...], dp) -> Tuple[int, List[int], int,
                                                      int]:
        spec = coarse_memo.get(kv)
        if spec is not None:
            return spec
        eng2 = _CalibratedEngine(scale) if scale else Engine()
        p0 = eng2.barrier([], tag="start")
        wl2 = decode_workload_from_plan(dp, _DECODE)
        mode2 = {_DECODE + q.name: q.mode
                 for q in tuple(dp.layers) + tuple(dp.gemms)}
        trace2 = {_DECODE + q.name: q.trace
                  for q in tuple(dp.layers) + tuple(dp.gemms)
                  if getattr(q, "trace", None) is not None}
        pend, r2 = _lower(eng2, scheds, wl2, mode2, trace2, p0, decode=True)
        pend = eng2.barrier([pend], tag="end")
        eng2.run()
        span = eng2.finish_times[pend] - eng2.finish_times[p0]
        per_slot = [sum(decode_attn_hbm_bytes(
            lp.seq_kv[s], lp.heads, lp.kv_heads, lp.head_dim, lp.mode,
            append=not lp.cross, bytes_per_el=hw.act_bytes)
            for lp in dp.layers if lp.trace is None)
            for s in range(len(kv))]
        traced = sum(p.trace.hbm_bytes for p in dp.layers
                     if p.trace is not None)
        traced += sum(g.trace.hbm_bytes for g in dp.gemms
                      if g.trace is not None)
        spec = (span, per_slot, traced, r2)
        coarse_memo[kv] = spec
        return spec

    prev = eng.barrier([], tag="start")
    marks: List[Tuple[object, int, object]] = []   # (sched step, mark, dp)
    replayed = 0
    for st in schedule.steps:
        tprefix = f"t{st.step}."
        for _, rid in st.admitted:
            p = by_rid[rid].prompt_len
            if p not in prefill_plans:
                prefill_plans[p] = plan_fn(p)
            plan = prefill_plans[p]
            prefix = tprefix + _PREFILL.format(rid=rid)
            wl = workload_from_plan(plan, prefix)
            mode_of = {prefix + q.name: q.mode
                       for q in tuple(plan.layers) + tuple(plan.gemms)}
            trace_of = {prefix + q.name: q.trace
                        for q in tuple(plan.layers) + tuple(plan.gemms)
                        if getattr(q, "trace", None) is not None}
            prev, r = _lower(eng, scheds, wl, mode_of, trace_of, prev)
            replayed += r
        dp = None
        if st.decoding:
            kv = tuple(k for _, _, k in st.decoding)
            if kv not in decode_plans:
                decode_plans[kv] = decode_plan_fn(kv)
            dp = decode_plans[kv]
            prefix = tprefix + _DECODE
            if decode_lowering == "coarse":
                span, per_slot, traced, r = coarse_spec(kv, dp)
                replayed += r
                buckets = shape_buckets(kv)
                deps: List[int] = []
                for i, (_, positions) in enumerate(buckets):
                    b = sum(per_slot[p] for p in positions)
                    if i == len(buckets) - 1:
                        # Recorded-trace bytes land on the last bucket
                        # (traces are op-level, not per-slot splittable).
                        b += traced
                    deps.append(eng.task(
                        "dma", "HBM", 0, [prev], nbytes=b,
                        tag=f"{prefix}coarse.b{i}:dma"))
                exempt_before = getattr(eng, "exempt", None)
                if exempt_before is not None:
                    # The memoized span came out of an identically
                    # calibrated scratch engine — re-scaling it here
                    # would double-apply the calibration.
                    eng.exempt = True
                try:
                    deps.append(eng.task("compute", "ATTN", span, [prev],
                                         tag=f"{prefix}coarse:span"))
                finally:
                    if exempt_before is not None:
                        eng.exempt = exempt_before
                prev = eng.barrier(deps, tag=f"{prefix}coarse:done")
            else:
                wl = decode_workload_from_plan(dp, prefix)
                mode_of = {prefix + q.name: q.mode
                           for q in tuple(dp.layers) + tuple(dp.gemms)}
                trace_of = {prefix + q.name: q.trace
                            for q in tuple(dp.layers) + tuple(dp.gemms)
                            if getattr(q, "trace", None) is not None}
                prev, r = _lower(eng, scheds, wl, mode_of, trace_of, prev,
                                 decode=True)
                replayed += r
        prev = eng.barrier([prev], tag=f"t{st.step}:end")
        marks.append((st, prev, dp))

    trace = eng.run()
    finish = eng.finish_times
    # One pass over the trace buckets HBM bytes per (step, prefill|decode)
    # — a per-step bytes_moved(pred=...) scan would be O(steps x events).
    pre_by_step: Dict[int, int] = {}
    dec_by_step: Dict[int, int] = {}
    # max event end per (admit step, rid): the cycle the request's prefill
    # — and hence its first token — actually completed (obs lifecycle).
    pre_end: Dict[Tuple[int, int], int] = {}
    for e in trace.events:
        if not e.tag.startswith("t"):
            continue
        head, _, rest = e.tag.partition(".")
        try:
            step_no = int(head[1:])
        except ValueError:
            continue
        if rest.startswith("pre."):
            parts = rest.split(".", 2)
            if len(parts) > 2 and parts[1][:1] == "r":
                try:
                    key = (step_no, int(parts[1][1:]))
                except ValueError:
                    key = None
                if key is not None and e.end > pre_end.get(key, 0):
                    pre_end[key] = e.end
            if e.resource == "HBM" and e.bytes:
                pre_by_step[step_no] = pre_by_step.get(step_no, 0) + e.bytes
        elif rest.startswith(_DECODE):
            if e.resource == "HBM" and e.bytes:
                dec_by_step[step_no] = dec_by_step.get(step_no, 0) + e.bytes
    steps: List[ServeStepSim] = []
    step_bounds: Dict[int, Tuple[int, int]] = {}
    bound = 0
    for st, mark, dp in marks:
        pre_b = pre_by_step.get(st.step, 0)
        dec_b = dec_by_step.get(st.step, 0)
        pred_b = dp.total_hbm_bytes if dp is not None else 0
        pred_rw = dp.total_rewrite_cycles if dp is not None else 0
        if dp is not None:
            # The planner==simulator traffic cross-assert.  Traced ops
            # replay their *recorded* bytes, so the expected total swaps
            # in trace.hbm_bytes for exactly those ops — a partial
            # recording must not silence the assert for the analytic rest.
            expect = sum(p.trace.hbm_bytes if p.trace is not None
                         else p.hbm_bytes for p in dp.layers)
            expect += sum(g.trace.hbm_bytes for g in dp.gemms
                          if g.trace is not None)
            if dec_b != expect:
                raise RuntimeError(
                    f"step {st.step}: simulated decode HBM bytes {dec_b} "
                    f"!= DecodePlan prediction {expect} (kv_lens "
                    f"{[k for _, _, k in st.decoding]}) — the planner and "
                    "the simulator disagree on the decode traffic model")
        steps.append(ServeStepSim(
            step=st.step,
            admitted=tuple(r for _, r in st.admitted),
            decoded=tuple(r for _, r, _ in st.decoding),
            kv_lens=tuple(k for _, _, k in st.decoding),
            cycles=finish[mark] - bound,
            hbm_bytes=pre_b + dec_b,
            prefill_hbm_bytes=pre_b, decode_hbm_bytes=dec_b,
            predicted_decode_hbm_bytes=pred_b,
            predicted_rewrite_cycles=pred_rw))
        step_bounds[st.step] = (bound, finish[mark])
        bound = finish[mark]

    arrivals = {r.rid: r.arrival_step for r in requests}
    # Cycle-domain lifecycle: first token when the request's prefill's
    # last event retired (``pre_end``), fallback to the step's end bound.
    cycle_spans = spans_from_timeline(
        schedule.admit_step, schedule.finish_step, schedule.decode_steps,
        arrivals, step_bounds,
        {rid: float(pre_end[(a, rid)])
         for rid, a in schedule.admit_step.items() if (a, rid) in pre_end},
        unit="cycles")
    sim = SimResult(cfg.name, mode if force_mode else None, hw.name,
                    trace.makespan, trace.bytes_moved("HBM"),
                    tuple(s.cycles for s in steps), trace, hw_cfg=hw,
                    replayed_ops=replayed)
    res = ServeSimResult(workload=cfg.name, slots=slots, schedule=schedule,
                         steps=steps, result=sim,
                         prefill_plans=prefill_plans,
                         decode_plans=decode_plans,
                         arrivals=arrivals, cycle_spans=cycle_spans,
                         registry=MetricsRegistry())
    res.registry.counter("steps").inc(len(steps))
    observe_spans(res.registry, res.request_spans, "steps.")
    observe_spans(res.registry, cycle_spans, "cycles.")
    return res
