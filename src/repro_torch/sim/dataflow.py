"""Discrete-event engine + the mixed-stationary cross-forwarding schedule.

``Engine`` is a small list-scheduling discrete-event simulator: tasks carry
a resource, a cycle cost, and dependencies; each resource issues in-order
and a task starts at max(deps ready, resource free).  Resources model the
StreamDCIM floorplan:

* ``GEN``  — weight-stationary macro groups (Q/K/V generation, FFN GEMMs)
* ``ATTN`` — input-stationary macro groups (QK^T / PV against resident
             K/V tiles)
* ``BUS``  — the shared CIM rewrite port (only used as a separate resource
             when ping-pong shadow sub-arrays let rewrite overlap compute;
             otherwise rewrite tasks occupy ``ATTN`` directly)
* ``NOC``  — the tile-based streaming network that cross-forwards K/V
             tiles between macro groups
* ``HBM``  — the off-chip port; every event on it carries a byte count so
             traces can be cross-checked against the analytic traffic
             model in ``repro.core.streaming``
* ``VEC``  — the SIMD softmax/elementwise unit

``cross_forward_attention`` builds the paper's §II-B schedule for one
attention op: per query block, ``x_kv`` tiles stream from HBM into the
stationary-weight macros, each generated K/V tile cross-forwards over the
NOC into the attention macros' shadow sub-array (ping-pong, §II-C), and
the tile's QK^T/PV fire as soon as *that tile* is resident — tile-level
execution decoupling, no layer barrier, K/V never touching HBM.

Copy of ``repro/sim/dataflow.py``, pure Python: the same code, its imports
pointed at the port's copies (``repro_torch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.configs.hardware import HardwareConfig
from repro_torch.sim.macro import MacroArray, dma_cycles, noc_cycles
from repro_torch.sim.trace import Event, Trace
from repro_torch.sim.workload import BLOCK, AttnOp

import math


@dataclasses.dataclass(slots=True)
class _Task:
    kind: str
    resource: str
    cycles: int
    deps: Tuple[int, ...]
    nbytes: int
    tag: str


class Engine:
    """In-order-per-resource list scheduler over an explicit task DAG."""

    def __init__(self) -> None:
        self._tasks: List[_Task] = []

    def task(self, kind: str, resource: str, cycles: int,
             deps: Sequence[int] = (), nbytes: int = 0, tag: str = "") -> int:
        for d in deps:
            if not 0 <= d < len(self._tasks):
                raise ValueError(f"dep {d} not yet submitted (task {tag})")
        self._tasks.append(_Task(kind, resource, int(cycles), tuple(deps),
                                 nbytes, tag))
        return len(self._tasks) - 1

    def barrier(self, deps: Sequence[int], tag: str = "sync") -> int:
        """Zero-cost join point (layer boundaries, phase barriers)."""
        return self.task("sync", "SYNC", 0, deps, tag=tag)

    def run(self) -> Trace:
        # The DSE/sweep hot loop: locals for every per-iteration global
        # lookup, events gathered in a plain list and handed to the
        # trace in one assignment (one cache invalidation instead of one
        # per ``add``).  Semantics are unchanged from the reference loop.
        tasks = self._tasks
        n = len(tasks)
        free: Dict[str, int] = {}
        last_on: Dict[str, int] = {}   # last emitted event per resource
        end: List[int] = [0] * n
        # Resolved predecessors per task: data deps with zero-cost SYNC
        # joins flattened to the real events behind them, plus the
        # in-order resource-occupancy predecessor.  Stamped onto every
        # emitted Event so the trace is a self-contained scheduling DAG
        # (repro.obs.critpath / repro.obs.whatif rebuild the schedule
        # from events alone).
        preds: List[Tuple[int, ...]] = [()] * n
        events: List[Event] = []
        emit = events.append
        free_get = free.get
        last_get = last_on.get
        is_sync = [t.resource == "SYNC" for t in tasks]
        for i, t in enumerate(tasks):
            start = 0
            resolved: List[int] = []
            extend = resolved.extend
            append = resolved.append
            for d in t.deps:
                e = end[d]
                if e > start:
                    start = e
                if is_sync[d]:
                    extend(preds[d])
                else:
                    append(d)
            res = t.resource
            if not is_sync[i]:
                f = free_get(res, 0)
                if f > start:
                    start = f
                rp = last_get(res)
                if rp is not None:
                    append(rp)
            if len(resolved) > 1:
                seen: set = set()
                deps = tuple(d for d in resolved
                             if not (d in seen or seen.add(d)))
            else:
                deps = tuple(resolved)
            preds[i] = deps
            fin = start + t.cycles
            end[i] = fin
            if not is_sync[i]:
                free[res] = fin
                last_on[res] = i
                emit(Event(i, t.kind, res, start, fin,
                           t.nbytes, t.tag, deps))
        trace = Trace()
        trace.events = events
        self.finish_times = end
        return trace


def cross_forward_attention(eng: Engine, hw: HardwareConfig, op: AttnOp,
                            gen: MacroArray, attn: MacroArray,
                            start: int, tag: str) -> int:
    """Mixed-stationary cross-forwarding schedule for one attention op
    (TILE_STREAM).  Returns the op's completion barrier task id.

    Streamed HBM bytes mirror ``streamed_bytes_per_layer(TILE_STREAM)``:
    Q written once, output written once, ``x_kv`` re-streamed per q-block;
    K/V only ever cross the NOC.
    """
    ab = hw.act_bytes
    bq = getattr(op, "block_q", BLOCK)
    bkv = getattr(op, "block_kv", BLOCK)
    nqb = math.ceil(op.seq_q / bq)
    nkb = math.ceil(op.seq_kv / bkv)
    q_bytes = op.seq_q * op.heads * op.head_dim * ab

    # Q projection on the stationary-weight macros, written out once.
    qgen = eng.task("compute", "GEN",
                    gen.gemm_cycles(op.seq_q, op.d_q, op.heads * op.head_dim),
                    [start], tag=f"{tag}:qgen")
    qdma = eng.task("dma", "HBM", dma_cycles(hw, q_bytes), [qgen],
                    nbytes=q_bytes, tag=f"{tag}:qdma")

    kv_tile_bytes = 2 * bkv * op.kv_heads * op.head_dim * ab
    x_tile_bytes = bkv * op.d_kv * ab
    ends = []
    for i in range(nqb):
        compute_hist: List[int] = []   # per-tile QK/PV tasks of this q-block
        for j in range(nkb):
            xdma = eng.task("dma", "HBM", dma_cycles(hw, x_tile_bytes),
                            [start], nbytes=x_tile_bytes,
                            tag=f"{tag}:xdma:q{i}k{j}")
            # K_j and V_j generated from the x_kv tile (one read feeds both).
            kvgen = eng.task(
                "compute", "GEN",
                2 * gen.gemm_cycles(bkv, op.d_kv,
                                    op.kv_heads * op.head_dim),
                [xdma], tag=f"{tag}:kvgen:q{i}k{j}")
            fwd = eng.task("forward", "NOC", noc_cycles(hw, kv_tile_bytes),
                           [kvgen], nbytes=kv_tile_bytes,
                           tag=f"{tag}:fwd:q{i}k{j}")
            # Ping-pong: the shadow sub-array takes tile j while tile j-1
            # computes, but tile j must wait for tile j-2's compute to free
            # its buffer.  Without shadow arrays, rewrite holds ATTN itself.
            rw_deps = [fwd]
            if attn.overlap_rewrite and len(compute_hist) >= 2:
                rw_deps.append(compute_hist[-2])
            rw_res = "BUS" if attn.overlap_rewrite else "ATTN"
            rw = eng.task("rewrite", rw_res,
                          attn.rewrite_cycles(kv_tile_bytes), rw_deps,
                          nbytes=kv_tile_bytes, tag=f"{tag}:rw:q{i}k{j}")
            # QK^T + PV for this tile; online softmax keeps tiles in-order.
            c_deps = [rw, qdma] + compute_hist[-1:]
            comp = eng.task(
                "compute", "ATTN",
                2 * attn.gemm_cycles(bq, op.head_dim, bkv,
                                     count=op.heads),
                c_deps, tag=f"{tag}:qkpv:q{i}k{j}")
            compute_hist.append(comp)
        ends.append(compute_hist[-1])

    o_bytes = q_bytes
    odma = eng.task("dma", "HBM", dma_cycles(hw, o_bytes), ends,
                    nbytes=o_bytes, tag=f"{tag}:odma")
    return eng.barrier([odma], tag=f"{tag}:done")
