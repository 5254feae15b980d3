"""Chrome/Perfetto ``trace_event`` export for simulator traces
(copy of ``repro/obs/timeline.py``, DESIGN.md §12).

A ``sim.Trace`` is a flat event list; nobody debugs a serving timeline
from 40 formatted rows.  This module renders any trace — prefill
simulations, DSE frontier replays, full ``simulate_serve`` timelines,
recorded ``KernelTrace`` streams — as Chrome ``trace_event`` JSON that
loads directly in https://ui.perfetto.dev (or ``chrome://tracing``):

* one track (thread) per simulator resource (GEN / ATTN / BUS / NOC /
  HBM / VEC), events colored by kind (compute / rewrite / dma / forward)
  with the full ``op:kind:tile`` tag preserved in ``args``;
* serving timelines additionally get a **steps** track (one slice per
  engine step) and a per-request **lifecycle** track group
  (queued → prefill → decode slices per request);
* ``KernelRecorder`` records lay out end-to-end on a **kernels** track.

Time convention: 1 simulated cycle = 1 microsecond of trace time (the
``ts``/``dur`` unit the viewers expect), so durations read directly as
cycle counts; wall-clock kernel records convert through their own
``clock_hz``.  ``validate_timeline`` is the CI gate: parses, non-empty
tracks, per-track monotone timestamps, non-negative durations.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

TIMELINE_SCHEMA_VERSION = 1

#: Stable track order: the floorplan resources first, stragglers after.
RESOURCE_ORDER = ("GEN", "ATTN", "BUS", "NOC", "HBM", "VEC")

#: Chrome trace-viewer reserved color names per event kind.
KIND_COLORS = {
    "compute": "thread_state_running",      # green
    "rewrite": "terrible",                  # red — the paper's villain
    "dma": "thread_state_iowait",           # orange
    "forward": "thread_state_runnable",     # blue
    "sync": "grey",
}

_PID_SIM = 1
_PID_STEPS = 2
_PID_REQUESTS = 3
_PID_KERNELS = 4
_PID_NOC = 9        # shared mesh links (timeline_from_sharded)
_PID_CHIPS = 10     # chip i renders as pid _PID_CHIPS + i


def _meta(pid: int, name: str, tid: Optional[int] = None,
          sort_index: Optional[int] = None) -> List[Dict[str, object]]:
    """process/thread naming metadata events."""
    key = "thread_name" if tid is not None else "process_name"
    ev: Dict[str, object] = {"ph": "M", "pid": pid, "name": key,
                             "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    out = [ev]
    if sort_index is not None and tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": sort_index}})
    return out


def _resource_tids(resources: Iterable[str]) -> Dict[str, int]:
    seen = set(resources)
    ordered = [r for r in RESOURCE_ORDER if r in seen]
    ordered += sorted(seen - set(ordered))
    return {r: i + 1 for i, r in enumerate(ordered)}


def _slice(e, pid: int, tid: int) -> Dict[str, object]:
    """One complete ("X") event for a trace event on track (pid, tid)."""
    return {
        "name": e.tag or e.kind,
        "cat": e.kind,
        "ph": "X",
        "ts": float(e.start),
        "dur": float(e.cycles),
        "pid": pid,
        "tid": tid,
        "cname": KIND_COLORS.get(e.kind, "generic_work"),
        "args": {"tag": e.tag, "op": e.op, "kind_tag": e.kind_tag,
                 "tile": e.tile, "bytes": e.bytes,
                 "cycles": e.cycles},
    }


def trace_events(trace, *, pid: int = _PID_SIM,
                 process_name: str = "sim",
                 critical_path: bool = False) -> List[Dict[str, object]]:
    """Lower a ``sim.Trace`` to ``trace_event`` dicts: one complete
    ("X") event per trace event on its resource's track, sorted by start
    within each track (the in-order-per-resource scheduler makes starts
    monotone, so sorting is just defense against hand-built traces).

    With ``critical_path=True`` the edges of the causal critical path
    (``repro_torch.obs.critpath``) are appended as Chrome flow events
    ("s"/"f" pairs), so Perfetto draws arrows along the chain that
    bounds the makespan."""
    tids = _resource_tids(e.resource for e in trace.events)
    out: List[Dict[str, object]] = _meta(pid, process_name)
    for res, tid in tids.items():
        out.extend(_meta(pid, res, tid, sort_index=tid))
    for e in sorted(trace.events, key=lambda e: (tids[e.resource], e.start)):
        out.append(_slice(e, pid, tids[e.resource]))
    if critical_path:
        from repro_torch.obs.critpath import critical_path as _critpath
        out.extend(critical_path_flow_events(
            _critpath(trace).path, tids, pid))
    return out


def critical_path_flow_events(path: Sequence, tids: Mapping[str, int],
                              pid: int) -> List[Dict[str, object]]:
    """Chrome flow events along consecutive critical-path edges: an "s"
    (flow start) anchored at the tail of the source slice and an "f"
    (flow finish, binding point "e" = enclosing slice end) at the head
    of the destination slice.  Perfetto renders these as arrows."""
    out: List[Dict[str, object]] = []
    for k, (a, b) in enumerate(zip(path, path[1:])):
        fid = k + 1
        common = {"cat": "critpath", "name": "critical-path", "id": fid}
        out.append({**common, "ph": "s", "pid": pid,
                    "tid": tids[a.resource], "ts": float(a.end)})
        out.append({**common, "ph": "f", "bp": "e", "pid": pid,
                    "tid": tids[b.resource], "ts": float(b.start)})
    return out


def _wrap(events: List[Dict[str, object]], title: str) -> Dict[str, object]:
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema_version": TIMELINE_SCHEMA_VERSION,
            "title": title,
            "clock": "1 simulated cycle = 1us of trace time",
        },
    }


def timeline_from_trace(trace, *, title: str = "sim",
                        critical_path: bool = False) -> Dict[str, object]:
    """A complete timeline document for one simulated trace."""
    return _wrap(trace_events(trace, process_name=title,
                              critical_path=critical_path), title)


def timeline_from_sim(result, *, title: Optional[str] = None,
                      critical_path: bool = False) -> Dict[str, object]:
    """Timeline for a ``SimResult`` (prefill simulation / DSE replay)."""
    return timeline_from_trace(
        result.trace, title=title or f"{result.workload}@{result.hw}",
        critical_path=critical_path)


def _link_sort_key(name: str) -> Tuple[str, int]:
    digits = "".join(ch for ch in name if ch.isdigit())
    return (name.rstrip("0123456789"), int(digits) if digits else -1)


def timeline_from_sharded(result, *, title: Optional[str] = None
                          ) -> Dict[str, object]:
    """Timeline for a ``ShardSimResult`` (``repro_torch.shard``): one process
    per chip carrying its own resource tracks (``c3.ATTN`` renders as
    the ``ATTN`` track of process ``chip3``) plus a ``noc`` process with
    one track per mesh link, so collective wire traffic reads directly
    against the per-chip compute it overlaps — or fails to."""
    from repro_torch.obs.attribution import NOC_LINK_PREFIX
    mesh = result.plan.mesh
    title = title or f"shard:{mesh.name}@{result.hw}"
    chips: Dict[int, Dict[str, List[object]]] = {}
    links: Dict[str, List[object]] = {}
    stray: List[object] = []
    for e in result.trace.events:
        r = e.resource
        if r.startswith(NOC_LINK_PREFIX):
            links.setdefault(r, []).append(e)
            continue
        head, _, base = r.partition(".")
        if base and head[:1] == "c" and head[1:].isdigit():
            chips.setdefault(int(head[1:]), {}).setdefault(
                base, []).append(e)
        else:
            stray.append(e)
    events: List[Dict[str, object]] = []
    if links:
        events += _meta(_PID_NOC, "noc")
        for tid, link in enumerate(sorted(links, key=_link_sort_key), 1):
            events += _meta(_PID_NOC, link, tid, sort_index=tid)
            for e in sorted(links[link], key=lambda e: e.start):
                events.append(_slice(e, _PID_NOC, tid))
    for i in sorted(chips):
        pid = _PID_CHIPS + i
        events += _meta(pid, f"chip{i}")
        tids = _resource_tids(chips[i])
        for res, tid in tids.items():
            events += _meta(pid, res, tid, sort_index=tid)
            for e in sorted(chips[i][res], key=lambda e: e.start):
                events.append(_slice(e, pid, tid))
    if stray:
        holder = type("_Events", (), {"events": stray})()
        events += trace_events(holder, process_name="sim")
    return _wrap(events, title)


def step_bounds(steps) -> List[Tuple[int, int, int]]:
    """Cumulative (step, start_cycle, end_cycle) bounds from per-step
    ``cycles`` spans (``ServeStepSim`` records)."""
    out, t = [], 0
    for s in steps:
        out.append((s.step, t, t + s.cycles))
        t += s.cycles
    return out


def timeline_from_serve(result, *, records: Sequence[object] = (),
                        title: str = "serve") -> Dict[str, object]:
    """Timeline for a ``ServeSimResult``: resource tracks + a serve-step
    track + one lifecycle track per request (queued / prefill / decode
    slices from the cycle-domain ``RequestSpan``s) + optionally a
    kernels track from recorded ``KernelTrace``s."""
    events = trace_events(result.result.trace, process_name=title)
    events += _meta(_PID_STEPS, "serve steps")
    events += _meta(_PID_STEPS, "steps", 1, sort_index=1)
    for step, start, end in step_bounds(result.steps):
        rec = result.steps[0].__class__  # noqa: F841 (doc: ServeStepSim)
        s = next(x for x in result.steps if x.step == step)
        events.append({
            "name": f"step{step}",
            "cat": "serve-step", "ph": "X",
            "ts": float(start), "dur": float(end - start),
            "pid": _PID_STEPS, "tid": 1,
            "args": {"step": step, "admitted": list(s.admitted),
                     "decoded": list(s.decoded),
                     "kv_lens": list(s.kv_lens),
                     "hbm_bytes": s.hbm_bytes},
        })
    events += _meta(_PID_REQUESTS, "requests")
    for i, span in enumerate(result.cycle_spans):
        tid = i + 1
        events += _meta(_PID_REQUESTS, f"r{span.rid}", tid, sort_index=tid)
        phases = [("queued", span.arrival, span.admit, "grey"),
                  ("prefill", span.admit, span.first_token,
                   "thread_state_running"),
                  ("decode", span.first_token, span.finish,
                   "thread_state_runnable")]
        for name, t0, t1, color in phases:
            if t1 <= t0:
                continue
            events.append({
                "name": f"r{span.rid}:{name}",
                "cat": "request", "ph": "X",
                "ts": float(t0), "dur": float(t1 - t0),
                "pid": _PID_REQUESTS, "tid": tid, "cname": color,
                "args": {"rid": span.rid, "tokens": span.tokens,
                         "ttft_cycles": span.ttft,
                         "tpot_cycles": span.tpot},
            })
    if records:
        events += kernel_events(records)
    return _wrap(events, title)


def kernel_events(records: Sequence[object],
                  pid: int = _PID_KERNELS) -> List[Dict[str, object]]:
    """Lay recorded ``KernelTrace``s end-to-end on a ``kernels`` track
    (records carry durations, not timestamps — the recording ran them
    sequentially, so end-to-end placement reflects the measurement)."""
    events = _meta(pid, "kernels") + _meta(pid, "recorded", 1, sort_index=1)
    t = 0.0
    for r in records:
        events.append({
            "name": f"{r.op} [{r.kind}]",
            "cat": "kernel", "ph": "X",
            "ts": t, "dur": float(r.cycles),
            "pid": pid, "tid": 1,
            "cname": "thread_state_running",
            "args": {"op": r.op, "kind": r.kind, "mode": r.mode,
                     "grid": list(r.grid), "block_q": r.block_q,
                     "block_kv": r.block_kv, "hbm_bytes": r.hbm_bytes,
                     "flops": r.flops, "source": r.source,
                     "wall_time_s": r.wall_time_s},
        })
        t += float(r.cycles)
    return events


def timeline_from_records(records: Sequence[object],
                          *, title: str = "kernels") -> Dict[str, object]:
    """Timeline for a raw ``KernelRecorder.records`` list."""
    return _wrap(kernel_events(records), title)


def write_timeline(timeline: Mapping[str, object], path: str) -> str:
    with open(path, "w") as f:
        json.dump(timeline, f)
    return path


def validate_timeline(obj: Mapping[str, object]) -> Dict[str, int]:
    """The CI gate for emitted timelines: the document must carry a
    non-empty ``traceEvents`` list with at least one named track; every
    duration event needs numeric non-negative ts/dur and timestamps must
    be monotone non-decreasing within each (pid, tid) track.  Flow
    events ("s"/"t"/"f" — critical-path arrows) must carry a numeric
    non-negative ts and an id, and are exempt from the per-track
    monotonicity check (they anchor to slices, not to track order).
    Returns ``{"events": n, "tracks": m}``; raises ValueError on any
    violation."""
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("timeline has no traceEvents")
    tracks = set()
    last_ts: Dict[Tuple[object, object], float] = {}
    slices = 0
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") in ("process_name", "thread_name"):
                tracks.add((e.get("pid"), e.get("tid")))
            continue
        if ph in ("s", "t", "f"):
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"flow event {i}: bad ts {ts!r}")
            if e.get("id") is None:
                raise ValueError(f"flow event {i}: missing flow id")
            continue
        if ph != "X":
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} ({e.get('name')!r}): bad ts {ts!r}")
        if not isinstance(dur, (int, float)) or dur < 0:
            raise ValueError(f"event {i} ({e.get('name')!r}): "
                             f"bad dur {dur!r}")
        key = (e.get("pid"), e.get("tid"))
        if ts < last_ts.get(key, 0.0):
            raise ValueError(
                f"event {i} ({e.get('name')!r}): timestamps not monotone "
                f"on track {key} ({ts} < {last_ts[key]})")
        last_ts[key] = float(ts)
        slices += 1
    if slices == 0:
        raise ValueError("timeline has metadata but no duration events")
    if not tracks:
        raise ValueError("timeline names no tracks")
    return {"events": slices, "tracks": len(last_ts)}


def load_timeline(path: str) -> Dict[str, object]:
    with open(path) as f:
        return json.load(f)
