"""The three execution pipelines (paper §III comparison systems).

All three schedulers execute the same per-(q-block, kv-tile) flash-style
attention schedule — identical ATTN-array compute — and differ only in the
paper's three mechanisms:

* ``NON_STREAM``    — unfused: every intermediate (Q, K, V, scores,
  probabilities, attention out) round-trips HBM, softmax runs on the
  vector unit against spilled score tiles, CIM rewriting serializes with
  compute, and nothing overlaps (a fully sequential accelerator).
* ``LAYER_STREAM``  — fused projections + streaming attention, but with
  *layer-granularity* synchronization: attention starts only after the
  whole K/V layer is generated and spilled, K/V round-trip HBM per
  q-block, and rewriting K/V tiles into the attention macros blocks the
  macro array (normal mode — no shadow sub-array), reproducing the §I
  ~57% rewrite stall.
* ``TILE_STREAM``   — StreamDCIM: the mixed-stationary cross-forwarding
  schedule of ``dataflow.cross_forward_attention`` with tile-level
  decoupling and the ping-pong compute-rewriting overlap.

Capacity note: the §I micro-workload (K = 2048x512) fits the macro array,
so layer-based streaming can hold K fully resident
(``simulate_rewrite_stall``); the §III model workloads cannot (ViLBERT
K+V across heads need ~4x the array), so every scheduler re-streams KV
tiles per q-block — which is why all three share the same tile schedule.

Copy of ``repro/sim/pipeline.py``, pure Python: the same code, its imports
pointed at the port's copies (``repro_torch``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.hardware import HardwareConfig, STREAMDCIM_BASE
from repro_torch.core.types import ExecutionMode, ModelConfig
from repro_torch.sim.dataflow import Engine, cross_forward_attention
from repro_torch.sim.macro import MacroArray, MacroMode, dma_cycles
from repro_torch.sim.trace import Trace
from repro_torch.sim.workload import (AttnOp, BLOCK, DecodeOp, GemmOp,
                                      Workload, build_workload)


@dataclasses.dataclass(frozen=True)
class SimResult:
    workload: str
    mode: Optional[ExecutionMode]   # None: heterogeneous plan-driven run
    hw: str
    cycles: int
    hbm_bytes: int
    layer_cycles: Tuple[int, ...]
    trace: Trace
    # The actual design point simulated (not just its name), so ad-hoc
    # sweep configs get correct energy scaling without a preset lookup.
    hw_cfg: Optional[HardwareConfig] = None
    # Ops whose timing came from attached KernelTraces (plan/trace replay,
    # DESIGN.md §10) rather than the analytic schedulers.
    replayed_ops: int = 0

    def op_dma_bytes(self, op_name: str) -> int:
        """Simulated HBM bytes attributed to one op (tag prefix match)."""
        return self.trace.bytes_moved(
            "HBM", pred=lambda e: e.tag.startswith(op_name + ":"))

    def energy(self, model=None):
        """Fold an ``repro.sim.energy.EnergyModel`` (default
        ``STREAMDCIM_ENERGY_BASE``) over this run's trace."""
        from repro_torch.sim.energy import energy_of
        return energy_of(self, model=model)

    def edp(self, model=None) -> float:
        """Energy-delay product, pJ * cycles (DESIGN.md §9)."""
        return self.energy(model).edp

    def critical_path(self):
        """Causal critical-path report for this run's trace
        (``repro_torch.obs.critpath``, DESIGN.md §14)."""
        from repro_torch.obs.critpath import critical_path
        return critical_path(self.trace)


class _Scheduler:
    """Shared structure: layers chain sequentially; ops chain within a
    layer (the macro array is a single shared pool)."""

    mode: ExecutionMode

    def __init__(self, hw: HardwareConfig) -> None:
        self.hw = hw
        self.gen = MacroArray(hw, hw.gen_groups, MacroMode.NORMAL)

    def simulate(self, wl: Workload) -> SimResult:
        return _simulate_ops(wl, self.hw, lambda op: self, self.mode)

    # GEMMs (FFN, output projections) are weight-stationary and identical
    # across modes; streaming modes keep their activations on-chip.
    def build_gemm(self, eng: Engine, op: GemmOp, start: int) -> int:
        return eng.task("compute", "GEN",
                        self.gen.gemm_cycles(op.m, op.k, op.n), [start],
                        tag=f"{op.name}:gemm")

    def build_attn(self, eng: Engine, op: AttnOp, start: int) -> int:
        raise NotImplementedError

    # ---- decode-step lowering (DESIGN.md §11) ----------------------------
    # One DecodeOp advances every active slot by one token: the new
    # token's Q (and, for growing caches, K/V) are generated on the
    # stationary macros, the cached K/V stream in tile by tile and are
    # rewritten into the attention macros, and a 1-row attention runs per
    # tile.  Byte/rewrite accounting mirrors
    # ``plan.heuristics.decode_attn_hbm_bytes`` / ``decode_rewrite_cycles``
    # exactly — ``simulate_serve`` cross-asserts it per step.

    def _decode_gen(self, eng: Engine, op: DecodeOp, start: int,
                    tag: str) -> Tuple[int, int, List[int]]:
        """Shared front half: Q generation, new-token KV generation and
        the cache-append write.  Returns (qgen, kv_ready, byte_events)."""
        hw, ab = self.hw, self.hw.act_bytes
        n = op.slots
        qgen = eng.task("compute", "GEN",
                        self.gen.gemm_cycles(n, op.d_q,
                                             op.heads * op.head_dim),
                        [start], tag=f"{tag}:qgen")
        if not op.append:
            return qgen, start, []
        kvgen = eng.task("compute", "GEN",
                         2 * self.gen.gemm_cycles(
                             n, op.d_kv, op.kv_heads * op.head_dim),
                         [start], tag=f"{tag}:kvgen")
        row = op.kv_width * ab
        app = eng.task("dma", "HBM", dma_cycles(hw, n * row), [kvgen],
                       nbytes=n * row, tag=f"{tag}:kvappend")
        return qgen, kvgen, [app]

    def _decode_tiles(self, seq_kv: int, block_kv: int) -> List[int]:
        """Ragged tile split of one slot's attended KV (last tile short)."""
        out, done = [], 0
        while done < seq_kv:
            tile = min(block_kv, seq_kv - done)
            out.append(tile)
            done += tile
        return out

    def _decode_streamed(self, eng: Engine, op: DecodeOp, start: int,
                         rewrite_res: str) -> int:
        """The streaming decode schedule shared by TILE_STREAM (rewrites
        ride the shadow-array bus: ``rewrite_res="BUS"``) and LAYER_STREAM
        (rewrites block the macro array: ``"ATTN"``).  TILE additionally
        forwards the new token's K/V over the NoC instead of re-reading it
        from HBM — one fewer cached row moved per slot."""
        hw, ab = self.hw, self.hw.act_bytes
        tag = op.name
        qgen, kv_ready, byte_evs = self._decode_gen(eng, op, start, tag)
        row = op.kv_width * ab
        tile_overlap = rewrite_res == "BUS"
        ends: List[int] = list(byte_evs)
        for s, kept in enumerate(op.seq_kv):
            # TILE: the forwarded new-token row never re-reads from HBM.
            read_rows = kept - 1 if (op.append and tile_overlap) else kept
            gate = eng.barrier([qgen, kv_ready] + byte_evs[-1:],
                               tag=f"{tag}:s{s}:ready") \
                if not tile_overlap else qgen
            prev_comp: List[int] = []
            read_left = read_rows
            for j, tile in enumerate(self._decode_tiles(kept, op.block_kv)):
                rd_rows = min(tile, read_left)
                read_left -= rd_rows
                deps = [gate]
                if rd_rows > 0:
                    deps = [eng.task("dma", "HBM",
                                     dma_cycles(hw, rd_rows * row), [gate],
                                     nbytes=rd_rows * row,
                                     tag=f"{tag}:s{s}:kvdma:k{j}")]
                elif tile_overlap:
                    deps = [kv_ready]            # forwarded over the NoC
                rw = eng.task("rewrite", rewrite_res,
                              self.attn.rewrite_cycles(tile * row), deps,
                              nbytes=tile * row, tag=f"{tag}:s{s}:rw:k{j}")
                comp = eng.task("compute", "ATTN",
                                2 * self.attn.gemm_cycles(
                                    1, op.head_dim, tile, count=op.heads),
                                [rw] + prev_comp[-1:],
                                tag=f"{tag}:s{s}:qkpv:k{j}")
                prev_comp.append(comp)
            ends.append(prev_comp[-1])
        return eng.barrier(ends, tag=f"{tag}:done")

    def build_decode(self, eng: Engine, op: DecodeOp, start: int) -> int:
        raise NotImplementedError


class _TileStream(_Scheduler):
    mode = ExecutionMode.TILE_STREAM

    def __init__(self, hw: HardwareConfig) -> None:
        super().__init__(hw)
        # Hybrid reconfigurable mode: active + shadow sub-array per macro.
        self.attn = MacroArray(hw, hw.num_groups - hw.gen_groups,
                               MacroMode.HYBRID)

    def build_attn(self, eng: Engine, op: AttnOp, start: int) -> int:
        return cross_forward_attention(eng, self.hw, op, self.gen,
                                       self.attn, start, op.name)

    def build_decode(self, eng: Engine, op: DecodeOp, start: int) -> int:
        # Hybrid mode: rewrites ride the shadow sub-array bus and overlap
        # attention compute; the new token's K/V cross-forward on-chip.
        return self._decode_streamed(eng, op, start, "BUS")


class _LayerStream(_Scheduler):
    mode = ExecutionMode.LAYER_STREAM

    def __init__(self, hw: HardwareConfig) -> None:
        super().__init__(hw)
        # Normal mode: both sub-arrays stationary, rewrites block compute.
        self.attn = MacroArray(hw, hw.num_groups - hw.gen_groups,
                               MacroMode.NORMAL)

    def build_attn(self, eng: Engine, op: AttnOp, start: int) -> int:
        hw, ab = self.hw, self.hw.act_bytes
        bq = getattr(op, "block_q", BLOCK)
        bkv = getattr(op, "block_kv", BLOCK)
        nqb = math.ceil(op.seq_q / bq)
        nkb = math.ceil(op.seq_kv / bkv)
        q_bytes = op.seq_q * op.heads * op.head_dim * ab
        x_bytes = op.seq_kv * op.d_kv * ab
        kv_bytes = op.seq_kv * op.kv_width * ab

        xdma = eng.task("dma", "HBM", dma_cycles(hw, x_bytes), [start],
                        nbytes=x_bytes, tag=f"{op.name}:xdma")
        qgen = eng.task("compute", "GEN",
                        self.gen.gemm_cycles(op.seq_q, op.d_q,
                                             op.heads * op.head_dim),
                        [start], tag=f"{op.name}:qgen")
        qdma = eng.task("dma", "HBM", dma_cycles(hw, q_bytes), [qgen],
                        nbytes=q_bytes, tag=f"{op.name}:qdma")
        kvgen = eng.task("compute", "GEN",
                         2 * self.gen.gemm_cycles(
                             op.seq_kv, op.d_kv, op.kv_heads * op.head_dim),
                         [xdma], tag=f"{op.name}:kvgen")
        kvw = eng.task("dma", "HBM", dma_cycles(hw, kv_bytes), [kvgen],
                       nbytes=kv_bytes, tag=f"{op.name}:kvdma")
        # Layer-granularity sync: attention waits for the full K/V layer.
        barrier = eng.barrier([kvw, qdma], tag=f"{op.name}:layer_sync")

        kv_tile_bytes = 2 * bkv * op.kv_heads * op.head_dim * ab
        ends = []
        for i in range(nqb):
            prev_comp: List[int] = []
            for j in range(nkb):
                rd = eng.task("dma", "HBM", dma_cycles(hw, kv_tile_bytes),
                              [barrier], nbytes=kv_tile_bytes,
                              tag=f"{op.name}:kvdma:q{i}k{j}")
                # No shadow sub-array: the rewrite occupies the macro array.
                rw = eng.task("rewrite", "ATTN",
                              self.attn.rewrite_cycles(kv_tile_bytes), [rd],
                              nbytes=kv_tile_bytes,
                              tag=f"{op.name}:rw:q{i}k{j}")
                comp = eng.task("compute", "ATTN",
                                2 * self.attn.gemm_cycles(
                                    bq, op.head_dim, bkv,
                                    count=op.heads),
                                [rw] + prev_comp[-1:],
                                tag=f"{op.name}:qkpv:q{i}k{j}")
                prev_comp.append(comp)
            ends.append(prev_comp[-1])
        o_bytes = q_bytes
        odma = eng.task("dma", "HBM", dma_cycles(hw, o_bytes), ends,
                        nbytes=o_bytes, tag=f"{op.name}:odma")
        return eng.barrier([odma], tag=f"{op.name}:done")

    def build_decode(self, eng: Engine, op: DecodeOp, start: int) -> int:
        # Normal mode: layer-granular sync (append commits before the
        # cache re-read) and rewrites block the macro array.
        return self._decode_streamed(eng, op, start, "ATTN")


class _NonStream(_Scheduler):
    mode = ExecutionMode.NON_STREAM

    def __init__(self, hw: HardwareConfig) -> None:
        super().__init__(hw)
        self.attn = MacroArray(hw, hw.num_groups - hw.gen_groups,
                               MacroMode.NORMAL)

    def _chain(self, eng: Engine, prev: int, kind: str, resource: str,
               cycles: int, nbytes: int, tag: str) -> int:
        return eng.task(kind, resource, cycles, [prev], nbytes=nbytes,
                        tag=tag)

    def build_gemm(self, eng: Engine, op: GemmOp, start: int) -> int:
        # Unfused: activations round-trip HBM around every GEMM.  The
        # output projection's input read is already charged to the
        # attention op (odma read), matching the analytic model's 2*o.
        ab = self.hw.act_bytes
        t = start
        if not op.name.endswith("_oproj"):
            in_bytes = op.m * op.k * ab
            t = self._chain(eng, t, "dma", "HBM",
                            dma_cycles(self.hw, in_bytes), in_bytes,
                            f"{op.name}:indma")
        t = self._chain(eng, t, "compute", "GEN",
                        self.gen.gemm_cycles(op.m, op.k, op.n), 0,
                        f"{op.name}:gemm")
        out_bytes = op.m * op.n * ab
        return self._chain(eng, t, "dma", "HBM",
                           dma_cycles(self.hw, out_bytes), out_bytes,
                           f"{op.name}:outdma")

    def build_attn(self, eng: Engine, op: AttnOp, start: int) -> int:
        hw, ab = self.hw, self.hw.act_bytes
        q_bytes = op.seq_q * op.heads * op.head_dim * ab
        k_bytes = op.seq_kv * op.kv_heads * op.head_dim * ab
        x_bytes = op.seq_kv * op.d_kv * ab
        a_bytes = op.heads * op.seq_q * op.seq_kv * ab
        softmax_cycles = math.ceil(op.heads * op.seq_q * op.seq_kv
                                   / hw.macro_cols)
        n = op.name
        t = self._chain(eng, start, "dma", "HBM", dma_cycles(hw, x_bytes),
                        x_bytes, f"{n}:xdma")
        t = self._chain(eng, t, "compute", "GEN",
                        self.gen.gemm_cycles(op.seq_q, op.d_q,
                                             op.heads * op.head_dim),
                        0, f"{n}:qgen")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                        q_bytes, f"{n}:qdma")
        t = self._chain(eng, t, "compute", "GEN",
                        2 * self.gen.gemm_cycles(
                            op.seq_kv, op.d_kv, op.kv_heads * op.head_dim),
                        0, f"{n}:kvgen")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, 2 * k_bytes),
                        2 * k_bytes, f"{n}:kvdma")                 # K,V out
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                        q_bytes, f"{n}:qdma:read")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, k_bytes),
                        k_bytes, f"{n}:kvdma:readk")
        t = self._chain(eng, t, "rewrite", "ATTN",
                        self.attn.rewrite_cycles(k_bytes), k_bytes,
                        f"{n}:rwk")
        t = self._chain(eng, t, "compute", "ATTN",
                        self.attn.gemm_cycles(op.seq_q, op.head_dim,
                                              op.seq_kv, count=op.heads),
                        0, f"{n}:qk")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                        a_bytes, f"{n}:adma:write")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                        a_bytes, f"{n}:adma:read")
        t = self._chain(eng, t, "compute", "VEC", softmax_cycles, 0,
                        f"{n}:softmax")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                        a_bytes, f"{n}:adma:writep")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                        a_bytes, f"{n}:adma:readp")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, k_bytes),
                        k_bytes, f"{n}:kvdma:readv")
        t = self._chain(eng, t, "rewrite", "ATTN",
                        self.attn.rewrite_cycles(k_bytes), k_bytes,
                        f"{n}:rwv")
        t = self._chain(eng, t, "compute", "ATTN",
                        self.attn.gemm_cycles(op.seq_q, op.seq_kv,
                                              op.head_dim, count=op.heads),
                        0, f"{n}:pv")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                        q_bytes, f"{n}:odma:write")
        t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                        q_bytes, f"{n}:odma:read")
        return eng.barrier([t], tag=f"{n}:done")

    def build_decode(self, eng: Engine, op: DecodeOp, start: int) -> int:
        # Unfused: per slot, Q and the score/probability rows round-trip
        # HBM; whole K then whole V rewrite serially into the array.
        hw, ab = self.hw, self.hw.act_bytes
        n = op.name
        qgen, kv_ready, byte_evs = self._decode_gen(eng, op, start, n)
        q_bytes = op.heads * op.head_dim * ab
        ends: List[int] = []
        for s, kept in enumerate(op.seq_kv):
            half = kept * op.kv_heads * op.head_dim * ab
            a_bytes = op.heads * kept * ab
            t = eng.barrier([qgen, kv_ready] + byte_evs, tag=f"{n}:s{s}:in")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                            q_bytes, f"{n}:s{s}:qdma:write")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                            q_bytes, f"{n}:s{s}:qdma:read")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, half),
                            half, f"{n}:s{s}:kvdma:readk")
            t = self._chain(eng, t, "rewrite", "ATTN",
                            self.attn.rewrite_cycles(half), half,
                            f"{n}:s{s}:rwk")
            t = self._chain(eng, t, "compute", "ATTN",
                            self.attn.gemm_cycles(1, op.head_dim, kept,
                                                  count=op.heads),
                            0, f"{n}:s{s}:qk")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                            a_bytes, f"{n}:s{s}:adma:write")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                            a_bytes, f"{n}:s{s}:adma:read")
            t = self._chain(eng, t, "compute", "VEC",
                            math.ceil(op.heads * kept / hw.macro_cols), 0,
                            f"{n}:s{s}:softmax")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                            a_bytes, f"{n}:s{s}:adma:writep")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, a_bytes),
                            a_bytes, f"{n}:s{s}:adma:readp")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, half),
                            half, f"{n}:s{s}:kvdma:readv")
            t = self._chain(eng, t, "rewrite", "ATTN",
                            self.attn.rewrite_cycles(half), half,
                            f"{n}:s{s}:rwv")
            t = self._chain(eng, t, "compute", "ATTN",
                            self.attn.gemm_cycles(1, kept, op.head_dim,
                                                  count=op.heads),
                            0, f"{n}:s{s}:pv")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                            q_bytes, f"{n}:s{s}:odma:write")
            t = self._chain(eng, t, "dma", "HBM", dma_cycles(hw, q_bytes),
                            q_bytes, f"{n}:s{s}:odma:read")
            ends.append(t)
        return eng.barrier(ends, tag=f"{n}:done")


_SCHEDULERS = {
    ExecutionMode.TILE_STREAM: _TileStream,
    ExecutionMode.LAYER_STREAM: _LayerStream,
    ExecutionMode.NON_STREAM: _NonStream,
}


class _CalibratedEngine(Engine):
    """Engine whose task durations scale by a fitted per-resource factor
    (``repro.sim.replay.CalibrationReport.scale``).  Replayed tasks are
    recorded ground truth and bypass scaling (``exempt``)."""

    def __init__(self, scale) -> None:
        super().__init__()
        self.scale = dict(scale)
        self.exempt = False

    def task(self, kind, resource, cycles, deps=(), nbytes=0, tag=""):
        s = self.scale.get(resource, 1.0)
        if cycles and not self.exempt and s != 1.0:
            cycles = max(1, int(math.ceil(cycles * s)))
        return super().task(kind, resource, cycles, deps, nbytes, tag)


def _build_replay(eng: Engine, op, kt, start: int) -> int:
    """Lower one traced op to its *recorded* timing (DESIGN.md §10): a
    single compute event spanning ``kt.cycles`` on the op class's macro
    resource, plus a zero-cycle HBM accounting event carrying the bytes
    the recorded kernel actually moved (the measured wall time already
    includes memory time — the recording platform overlaps DMA with
    compute, so charging the span once is the honest accounting)."""
    exempt_before = getattr(eng, "exempt", None)
    if exempt_before is not None:
        eng.exempt = True
    try:
        dma = eng.task("dma", "HBM", 0, [start], nbytes=kt.hbm_bytes,
                       tag=f"{op.name}:replay:dma")
        comp = eng.task("compute", kt.resource, kt.cycles, [start],
                        tag=f"{op.name}:replay")
        return eng.barrier([dma, comp], tag=f"{op.name}:replay:done")
    finally:
        if exempt_before is not None:
            eng.exempt = exempt_before


def _simulate_ops(wl: Workload, hw: HardwareConfig, sched_for_op,
                  mode: Optional[ExecutionMode],
                  trace_of: Optional[Dict[str, object]] = None,
                  scale: Optional[Dict[str, float]] = None) -> SimResult:
    """The shared per-layer scheduling loop: layers chain sequentially;
    ``sched_for_op(op)`` picks the scheduler that builds each op's task
    graph — a constant for the homogeneous paths, per-op for plan-driven
    simulation (heterogeneous modes in one model).  Ops named in
    ``trace_of`` replay their recorded ``KernelTrace`` timing instead;
    ``scale`` applies a fitted per-resource calibration factor to the
    analytic (non-replayed) task durations."""
    eng = _CalibratedEngine(scale) if scale else Engine()
    prev = eng.barrier([], tag="start")
    layer_marks: List[int] = []
    replayed = 0
    for layer in wl.layers:
        for op in layer.ops:
            kt = trace_of.get(op.name) if trace_of else None
            if kt is not None:
                prev = _build_replay(eng, op, kt, prev)
                replayed += 1
            else:
                sched = sched_for_op(op)
                if isinstance(op, AttnOp):
                    prev = sched.build_attn(eng, op, prev)
                elif isinstance(op, DecodeOp):
                    prev = sched.build_decode(eng, op, prev)
                else:
                    prev = sched.build_gemm(eng, op, prev)
        prev = eng.barrier([prev], tag=f"layer{layer.index}")
        layer_marks.append(prev)
    trace = eng.run()
    finish = eng.finish_times
    bounds = [0] + [finish[m] for m in layer_marks]
    per_layer = tuple(b - a for a, b in zip(bounds, bounds[1:]))
    return SimResult(wl.name, mode, hw.name, trace.makespan,
                     trace.bytes_moved("HBM"), per_layer, trace, hw_cfg=hw,
                     replayed_ops=replayed)


def simulate(wl: Workload, hw: HardwareConfig,
             mode: ExecutionMode) -> SimResult:
    return _SCHEDULERS[mode](hw).simulate(wl)


def simulate_plan(plan, hw: Optional[HardwareConfig] = None, *,
                  replay: bool = True,
                  calibration=None) -> SimResult:
    """Execute an ``repro.plan.ExecutionPlan``: the plan's op list is
    lowered directly (``workload_from_plan``) and each op's task graph is
    built by the scheduler for *that op's* resolved mode — per-layer
    heterogeneous modes run in one simulated model.  ``SimResult.mode``
    is the plan's uniform mode, or None for a heterogeneous plan.

    Plan/trace replay (DESIGN.md §10): ops carrying an attached
    ``KernelTrace`` (``plan.attach_traces`` / ``record_plan``) replay
    their *recorded* timing and bytes verbatim; untraced ops keep the
    analytic lowering — one plan mixes both.  ``replay=False`` forces
    analytic lowering everywhere (the denominator of every calibration
    fit).  ``calibration`` — a ``repro.sim.replay.CalibrationReport`` or
    raw ``{resource: factor}`` mapping — scales the analytic task
    durations by the fitted per-resource factors (replayed ops are
    ground truth and stay untouched)."""
    from repro_torch.sim.replay import resolve_calibration
    from repro_torch.sim.workload import workload_from_plan
    hw = hw or _hw_for_plan(plan)
    scheds = {m: _SCHEDULERS[m](hw) for m in ExecutionMode}
    mode_of: Dict[str, ExecutionMode] = {}
    trace_of: Dict[str, object] = {}
    for p in tuple(plan.layers) + tuple(plan.gemms):
        mode_of[p.name] = p.mode
        kt = getattr(p, "trace", None)
        if replay and kt is not None:
            trace_of[p.name] = kt
    wl = workload_from_plan(plan)
    return _simulate_ops(wl, hw, lambda op: scheds[mode_of[op.name]],
                         plan.uniform_mode, trace_of=trace_of or None,
                         scale=resolve_calibration(calibration))


def _hw_for_plan(plan) -> HardwareConfig:
    if hasattr(plan, "hw_config"):
        return plan.hw_config()      # carries ad-hoc design points verbatim
    from repro_torch.configs.hardware import HW_PRESETS
    return HW_PRESETS[plan.hw]


def simulate_model(cfg, hw: Optional[HardwareConfig] = None,
                   mode: Optional[ExecutionMode] = None,
                   seq_len: int = 0) -> SimResult:
    """Simulate a ``ModelConfig`` (legacy: mode forced or taken from the
    config; default hardware STREAMDCIM_BASE) or an
    ``repro.plan.ExecutionPlan`` (the planned path — per-layer modes come
    from the plan; ``hw`` overrides the plan's recorded preset, ``mode``
    is rejected: re-plan instead)."""
    if hasattr(cfg, "layers") and hasattr(cfg, "gemms"):
        if mode is not None:
            raise ValueError(
                "mode= conflicts with an ExecutionPlan (the plan already "
                "records per-layer modes); build a new plan instead")
        return simulate_plan(cfg, hw=hw)
    return simulate(build_workload(cfg, seq_len), hw or STREAMDCIM_BASE,
                    mode or cfg.execution_mode)


def compare_modes(cfg: ModelConfig, hw: HardwareConfig = STREAMDCIM_BASE,
                  seq_len: int = 0) -> Dict[ExecutionMode, SimResult]:
    """Three forced-mode plans for one model, built once and simulated —
    the §III comparison harness.  Each plan pins every layer to one mode
    (``force_mode=True``), so TILE_STREAM is simulated even where the
    planner would fall back (that inversion is the GQA cross-check).
    ``hw`` is passed through to the simulation verbatim, so ad-hoc
    (unregistered / modified) design points sweep correctly."""
    from repro_torch.plan.planner import plan_model
    return {m: simulate_plan(plan_model(cfg, hw=hw, seq_len=seq_len,
                                        mode=m, force_mode=True), hw=hw)
            for m in ExecutionMode}


def rewrite_stall_trace(hw: HardwareConfig = STREAMDCIM_BASE,
                        n: int = 2048, d: int = 512, *,
                        ping_pong: bool = False,
                        iters: int = 4) -> Trace:
    """The §I micro-workload as a raw ``Trace`` — the input to
    ``simulate_rewrite_stall``'s arithmetic and to ``obs.attribution``'s
    reproduction of the 57% stall number."""
    mode = MacroMode.HYBRID if ping_pong else MacroMode.NORMAL
    arr = MacroArray(hw, hw.num_groups, mode)
    rw_cycles = arr.rewrite_cycles(n * d)            # INT8: n*d bytes
    comp_cycles = arr.gemm_cycles(n, d, n)           # stream n q-vectors
    eng = Engine()
    comps: List[int] = []
    for it in range(iters):
        deps = comps[-1:] if not arr.overlap_rewrite else comps[-2:-1]
        res = "ATTN" if not arr.overlap_rewrite else "BUS"
        rw = eng.task("rewrite", res, rw_cycles, deps, nbytes=n * d,
                      tag=f"it{it}:rw")
        comp = eng.task("compute", "ATTN", comp_cycles,
                        [rw] + comps[-1:], tag=f"it{it}:qk")
        comps.append(comp)
    return eng.run()


def simulate_rewrite_stall(hw: HardwareConfig = STREAMDCIM_BASE,
                           n: int = 2048, d: int = 512, *,
                           ping_pong: bool = False,
                           iters: int = 4) -> Dict[str, float]:
    """Paper §I micro-workload: QK^T phases with K = n x d INT8 resident
    in the macro array (it fits, unlike the §III models).  Serial
    (layer-based streaming) rewriting stalls the array; with the ping-pong
    shadow sub-array the next phase's K rewrites during the current
    phase's compute and only the bus-bound residue is exposed."""
    mode = MacroMode.HYBRID if ping_pong else MacroMode.NORMAL
    arr = MacroArray(hw, hw.num_groups, mode)
    rw_cycles = arr.rewrite_cycles(n * d)            # INT8: n*d bytes
    comp_cycles = arr.gemm_cycles(n, d, n)           # stream n q-vectors
    trace = rewrite_stall_trace(hw, n, d, ping_pong=ping_pong, iters=iters)
    span = trace.makespan
    exposed = span - trace.busy_cycles("ATTN") if arr.overlap_rewrite else 0
    return {
        "rewrite_cycles": float(rw_cycles),
        "compute_cycles": float(comp_cycles),
        "span_cycles": float(span),
        "cycles_per_phase": span / iters,
        "rewrite_frac": trace.rewrite_stall_fraction(),
        "exposed_stall_frac": (exposed / span if arr.overlap_rewrite
                               else trace.rewrite_stall_fraction()),
    }
