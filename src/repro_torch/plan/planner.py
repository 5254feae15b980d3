"""``plan_model``: one compile→plan step shared by kernels, simulator and
serving (DESIGN.md §8).

An ``ExecutionPlan`` is the single, inspectable, serializable artifact that
records StreamDCIM's *reconfiguration decision* for one (model, shape,
hardware) triple: per-attention-layer execution mode (the TBR-CIM
hybrid/normal reconfiguration analogue), block tiling, fuse/prune
decisions, and the predicted per-layer HBM bytes + CIM rewrite cycles.
It is consumed by

* ``kernels.ops.attention_by_plan``   — the kernel path,
* ``sim.simulate_plan``               — the cycle-approximate simulator
  (per-layer heterogeneous modes in one run), and
* ``serve.Engine(plan=...)``          — the serving engine, which re-plans
  per admitted wave's prompt shape.

Layer enumeration reuses the simulator's lowering (``sim.workload``): the
planner sees exactly the op graph the simulator executes, so predicted and
simulated traffic are asserted against the *same object* in benchmarks and
tests.  Plans follow CIMFlow's compile-then-evaluate shape
(arXiv:2505.01107) and NeuroSim's one-config-object-through-both-paths
discipline (arXiv:2505.02314).

Copy of ``repro/plan/planner.py``: the same code, its imports pointed at the
port's copies (``repro_torch``).  The port's kernels record traces through
``repro_torch.kernels.ops`` and ``repro_torch.sim.replay``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import (Dict, Iterable, Mapping, Optional, Tuple, TYPE_CHECKING,
                    Union)

from repro_torch.configs.hardware import HW_PRESETS, HardwareConfig
from repro_torch.core.types import (AttnKind, ExecutionMode, ModelConfig,
                                    ShapeConfig, SHAPES)
from repro_torch.plan.heuristics import (DEFAULT_BLOCK, attn_hbm_bytes,
                                         resolve_layer_mode)

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.sim.replay import KernelTrace

PLAN_VERSION = 1


# ---------------------------------------------------------------------------
# Plan dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """The resolved decision record for one attention layer (paper-sense:
    one attention op, including its Q projection and KV generation)."""

    op_index: int          # position in the lowered op stream
    layer_index: int       # model layer this op belongs to
    name: str              # op tag (e.g. "cox0_co") — stable across paths
    mode: ExecutionMode    # resolved mode (NOT the requested one)
    seq_q: int
    seq_kv: int
    d_q: int               # width of the query-side activations
    d_kv: int              # width of the KV-source activations
    heads: int
    kv_heads: int
    head_dim: int
    cross: bool            # K/V generated from the *other* stream
    block_q: int           # q-tile edge handed to the kernels/simulator
    block_kv: int          # kv-tile edge
    fuse_kv: bool          # generation-fusion on (== mode is TILE_STREAM)
    keep_tokens: int       # DTPU prune decision: kept q tokens (== seq_q
                           # when pruning is off; informational for now)
    hbm_bytes: int         # predicted streamed HBM bytes for this layer
    rewrite_cycles: int    # predicted CIM write-port cycles for this layer
    # Recorded kernel execution for this op (repro.sim.replay.KernelTrace)
    # or None; when present, simulate_plan replays it in place of the
    # analytic lowering (DESIGN.md §10).
    trace: Optional["KernelTrace"] = None

    @property
    def kv_width(self) -> int:
        return 2 * self.kv_heads * self.head_dim

    def attach_trace(self, trace: Optional["KernelTrace"]) -> "LayerPlan":
        """A copy with ``trace`` attached (or detached for None).  The
        record must name this op — attaching another op's timing would
        silently mis-calibrate the replay."""
        if trace is not None and trace.op != self.name:
            raise ValueError(f"trace for op {trace.op!r} cannot attach to "
                             f"LayerPlan {self.name!r}")
        return dataclasses.replace(self, trace=trace)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A plain weight-stationary GEMM (FFN matmul, output projection).
    Carried so a plan is self-contained for simulation; ``mode`` is the
    enclosing layer's resolved mode (NON_STREAM round-trips activations)."""

    op_index: int
    layer_index: int
    name: str
    m: int
    k: int
    n: int
    mode: ExecutionMode
    trace: Optional["KernelTrace"] = None   # recorded timing (see LayerPlan)

    def attach_trace(self, trace: Optional["KernelTrace"]) -> "GemmPlan":
        if trace is not None and trace.op != self.name:
            raise ValueError(f"trace for op {trace.op!r} cannot attach to "
                             f"GemmPlan {self.name!r}")
        return dataclasses.replace(self, trace=trace)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The compile→plan artifact for one (model, shape, hw) triple."""

    model: str
    shape: str             # shape-cell name, or "seq<N>" / "default"
    hw: str                # HardwareConfig name (preset or ad-hoc)
    seq_len: int           # requested sequence length (0 = model default)
    layers: Tuple[LayerPlan, ...]
    gemms: Tuple[GemmPlan, ...] = ()
    # Full design-point parameters (dataclasses.asdict of the resolved
    # HardwareConfig), so ad-hoc/modified design points — the sweep use
    # case — survive serialization and re-planning, not just the name.
    hw_params: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def hw_config(self) -> HardwareConfig:
        """The design point this plan was compiled for."""
        if self.hw_params:
            return HardwareConfig(**self.hw_params)
        return HW_PRESETS[self.hw]

    # ---------- inspection ----------

    @property
    def modes(self) -> Tuple[ExecutionMode, ...]:
        """Distinct resolved modes, in first-appearance order."""
        seen = []
        for lp in self.layers:
            if lp.mode not in seen:
                seen.append(lp.mode)
        return tuple(seen)

    @property
    def uniform_mode(self) -> Optional[ExecutionMode]:
        """The single resolved mode, or None for a heterogeneous plan."""
        ms = self.modes
        return ms[0] if len(ms) == 1 else None

    @property
    def heterogeneous(self) -> bool:
        return len(self.modes) > 1

    @property
    def total_hbm_bytes(self) -> int:
        """Predicted attention-layer HBM traffic (weight/FFN traffic is
        mode-invariant and omitted, matching the analytic model)."""
        return sum(lp.hbm_bytes for lp in self.layers)

    @property
    def total_rewrite_cycles(self) -> int:
        return sum(lp.rewrite_cycles for lp in self.layers)

    @property
    def traced_ops(self) -> Tuple[str, ...]:
        """Names of ops carrying an attached ``KernelTrace`` (these replay
        recorded timing in ``simulate_plan``; the rest lower analytically
        — DESIGN.md §10)."""
        return tuple(p.name for p in self.layers + self.gemms
                     if p.trace is not None)

    def layer(self, key: Union[int, str]) -> LayerPlan:
        """Look up a LayerPlan by op name, or by *position* in
        ``self.layers`` for an int (NOT the model layer index — multimodal
        layers hold several attention ops; use ``layers_of`` for those,
        and note ``with_layer_modes`` int keys ARE model layer indices)."""
        if isinstance(key, str):
            for lp in self.layers:
                if lp.name == key:
                    return lp
            raise KeyError(key)
        return self.layers[key]

    def layers_of(self, layer_index: int) -> Tuple[LayerPlan, ...]:
        """All attention ops of one *model* layer (the unit
        ``with_layer_modes`` int keys address)."""
        return tuple(lp for lp in self.layers
                     if lp.layer_index == layer_index)

    def summary(self) -> Dict[str, object]:
        """Compact dict for sweep tooling / ``benchmarks/run.py --json``."""
        counts: Dict[str, int] = {}
        for lp in self.layers:
            counts[lp.mode.value] = counts.get(lp.mode.value, 0) + 1
        return {
            "model": self.model, "shape": self.shape, "hw": self.hw,
            "seq_len": self.seq_len, "attention_layers": len(self.layers),
            "modes": counts,
            "heterogeneous": self.heterogeneous,
            "total_hbm_bytes": self.total_hbm_bytes,
            "total_rewrite_cycles": self.total_rewrite_cycles,
            "traced_ops": len(self.traced_ops),
        }

    # ---------- trace attachment (repro.sim.replay) ----------

    def attach_traces(self, traces: Union[Mapping[str, object],
                                          Iterable[object]]
                      ) -> "ExecutionPlan":
        """Return a new plan with recorded ``KernelTrace``s attached to
        the ops they name.  ``traces`` is an iterable of records (later
        records win) or an op->trace mapping; records whose ``op`` names
        no plan op — e.g. kernel-level ``parent/kernel`` sub-records —
        are ignored, so a raw ``KernelRecorder.records`` list attaches
        directly."""
        if isinstance(traces, Mapping):
            by_op = dict(traces)
        else:
            by_op = {t.op: t for t in traces}
        layers = tuple(lp.attach_trace(by_op[lp.name])
                       if lp.name in by_op else lp for lp in self.layers)
        gemms = tuple(g.attach_trace(by_op[g.name])
                      if g.name in by_op else g for g in self.gemms)
        return dataclasses.replace(self, layers=layers, gemms=gemms)

    def without_traces(self) -> "ExecutionPlan":
        """A copy with every attached trace dropped (pure analytic plan)."""
        return dataclasses.replace(
            self,
            layers=tuple(lp.attach_trace(None) for lp in self.layers),
            gemms=tuple(g.attach_trace(None) for g in self.gemms))

    # ---------- heterogeneous re-planning ----------

    def with_layer_modes(
            self, overrides: Mapping[Union[int, str], ExecutionMode]
    ) -> "ExecutionPlan":
        """Return a new plan with some layers forced to different modes.

        Keys are op names (``"cox0_co"``) or model layer indices (all
        attention ops of that layer).  Predicted bytes / rewrite cycles are
        recomputed for the affected layers; each gemm follows the nearest
        *preceding* attention op of its layer (``plan_model``'s rule), so
        an op-level override also moves that op's output projection.
        """
        hw = self.hw_config()
        new_layers = []
        for lp in self.layers:
            mode = lp.mode
            if lp.name in overrides:
                mode = ExecutionMode(overrides[lp.name])
            elif lp.layer_index in overrides:
                mode = ExecutionMode(overrides[lp.layer_index])
            if mode != lp.mode:
                # A recorded trace is only valid for the mode it ran
                # under — a mode override drops it back to analytic.
                lp = dataclasses.replace(
                    lp, mode=mode, trace=None,
                    fuse_kv=mode == ExecutionMode.TILE_STREAM,
                    hbm_bytes=_predict_bytes(lp, mode, hw),
                    rewrite_cycles=_predict_rewrites(lp, mode, hw))
            new_layers.append(lp)
        attn_by_layer: Dict[int, list] = {}
        for lp in new_layers:                    # op order is preserved
            attn_by_layer.setdefault(lp.layer_index, []).append(lp)
        def gemm_mode(g: GemmPlan) -> ExecutionMode:
            preceding = [lp.mode for lp in attn_by_layer.get(g.layer_index, [])
                         if lp.op_index < g.op_index]
            return preceding[-1] if preceding else g.mode
        def regem(g: GemmPlan) -> GemmPlan:
            m = gemm_mode(g)
            if m == g.mode:
                return g
            return dataclasses.replace(g, mode=m, trace=None)
        new_gemms = tuple(regem(g) for g in self.gemms)
        return dataclasses.replace(self, layers=tuple(new_layers),
                                   gemms=new_gemms)

    # ---------- serialization ----------

    def to_dict(self) -> Dict[str, object]:
        def enc(obj):
            d = dataclasses.asdict(obj)
            d["mode"] = obj.mode.value
            # KernelTrace serializes via its own versioned encoder so a
            # traced plan round-trips traces exactly (DESIGN.md §10).
            d["trace"] = obj.trace.to_dict() if obj.trace else None
            return d
        return {
            "version": PLAN_VERSION,
            "model": self.model, "shape": self.shape, "hw": self.hw,
            "hw_params": dict(self.hw_params),
            "seq_len": self.seq_len,
            "layers": [enc(lp) for lp in self.layers],
            "gemms": [enc(g) for g in self.gemms],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "ExecutionPlan":
        if d.get("version") != PLAN_VERSION:
            raise ValueError(f"unsupported plan version {d.get('version')!r}")

        def dec(rec):
            rec = dict(rec)
            rec["mode"] = ExecutionMode(rec["mode"])
            tr = rec.get("trace")
            if tr is not None:
                from repro_torch.sim.replay import KernelTrace
                rec["trace"] = KernelTrace.from_dict(tr)
            return rec

        layers = tuple(LayerPlan(**dec(lp)) for lp in d["layers"])
        gemms = tuple(GemmPlan(**dec(g)) for g in d.get("gemms", []))
        return cls(model=d["model"], shape=d["shape"], hw=d["hw"],
                   hw_params=dict(d.get("hw_params", {})),
                   seq_len=int(d["seq_len"]), layers=layers, gemms=gemms)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Prediction helpers (mirror the simulator's scheduler arithmetic exactly)
# ---------------------------------------------------------------------------

def resolve_hw(hw: Union[str, HardwareConfig, None]) -> HardwareConfig:
    if hw is None:
        return HW_PRESETS["streamdcim-base"]
    if isinstance(hw, str):
        return HW_PRESETS[hw]
    return hw


def _predict_bytes(lp: LayerPlan, mode: ExecutionMode,
                   hw: HardwareConfig) -> int:
    return attn_hbm_bytes(lp.seq_q, lp.seq_kv, lp.d_kv, lp.heads,
                          lp.kv_heads, lp.head_dim, mode,
                          block_q=lp.block_q, bytes_per_el=hw.act_bytes)


def _predict_rewrites(lp: LayerPlan, mode: ExecutionMode,
                      hw: HardwareConfig,
                      act_bytes: Optional[int] = None) -> int:
    """CIM write-port cycles spent rewriting K/V for this layer — the same
    arithmetic the simulator's schedulers charge (``sim.pipeline``):
    streaming modes rewrite one KV tile per (q-block, kv-tile) pair
    (TILE_STREAM rides the shadow-array bus, LAYER_STREAM stalls the
    array — the §I 57% analysis); NON_STREAM rewrites K and V whole.
    ``act_bytes`` overrides the hardware's DMA element width so a plan's
    byte and cycle predictions always assume the same element size."""
    rbpc = hw.rewrite_bytes_per_cycle
    ab = hw.act_bytes if act_bytes is None else act_bytes
    if mode == ExecutionMode.NON_STREAM:
        k_bytes = lp.seq_kv * lp.kv_heads * lp.head_dim * ab
        return 2 * math.ceil(k_bytes / rbpc)
    nqb = math.ceil(lp.seq_q / lp.block_q)
    nkb = math.ceil(lp.seq_kv / lp.block_kv)
    kv_tile_bytes = 2 * lp.block_kv * lp.kv_heads * lp.head_dim * ab
    return nqb * nkb * math.ceil(kv_tile_bytes / rbpc)


# ---------------------------------------------------------------------------
# plan_model / plan_attention
# ---------------------------------------------------------------------------

def _resolve_shape(shape: Union[ShapeConfig, str, None],
                   seq_len: int) -> Tuple[str, int]:
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape is not None:
        return shape.name, (seq_len or shape.seq_len)
    return (f"seq{seq_len}" if seq_len else "default"), seq_len


def plan_model(cfg: ModelConfig,
               shape: Union[ShapeConfig, str, None] = None, *,
               hw: Union[str, HardwareConfig, None] = None,
               seq_len: int = 0,
               mode: Optional[ExecutionMode] = None,
               force_mode: bool = False,
               layer_modes: Optional[Mapping[Union[int, str],
                                             ExecutionMode]] = None,
               block_q: int = DEFAULT_BLOCK,
               block_kv: int = DEFAULT_BLOCK) -> ExecutionPlan:
    """Compile one (model, shape, hw) triple into an ``ExecutionPlan``.

    * ``shape`` — a ``ShapeConfig`` (or its registry name); its ``seq_len``
      is used unless an explicit ``seq_len`` is given.  ``seq_len=0`` with
      no shape picks the model's paper-typical sequence (``sim.workload``).
    * ``mode`` — the requested execution mode (default:
      ``cfg.execution_mode``).  A TILE_STREAM request is still subject to
      the per-layer profitability / MLA / fusion-knob rules
      (``plan.heuristics``) unless ``force_mode=True``, which pins every
      layer verbatim (benchmark baselines).
    * ``layer_modes`` — per-layer overrides ({op name | layer index:
      mode}) applied after resolution: the heterogeneous-plan entry point.

    Raises ``ValueError`` for attention-free families (no K/V streaming to
    schedule — same contract as ``sim.build_workload``).
    """
    from repro_torch.sim.workload import AttnOp, build_workload
    hw_cfg = resolve_hw(hw)
    shape_name, seq = _resolve_shape(shape, seq_len)
    wl = build_workload(cfg, seq)
    requested = mode or cfg.execution_mode

    layers = []
    gemms = []
    op_index = 0
    for layer in wl.layers:
        cur_mode = requested
        for op in layer.ops:
            if isinstance(op, AttnOp):
                if force_mode:
                    resolved = requested
                else:
                    resolved = resolve_layer_mode(
                        requested, d_kv=op.d_kv, num_kv_heads=op.kv_heads,
                        head_dim=op.head_dim, attn_kind=cfg.attn_kind,
                        fuse_kv_generation=cfg.fuse_kv_generation)
                cur_mode = resolved
                keep = op.seq_q
                if cfg.pruning.enabled:
                    keep = cfg.pruning.kept_tokens(
                        layer.index, len(wl.layers), op.seq_q)
                lp = LayerPlan(
                    op_index=op_index, layer_index=layer.index, name=op.name,
                    mode=resolved, seq_q=op.seq_q, seq_kv=op.seq_kv,
                    d_q=op.d_q, d_kv=op.d_kv, heads=op.heads,
                    kv_heads=op.kv_heads, head_dim=op.head_dim,
                    cross=op.cross, block_q=block_q, block_kv=block_kv,
                    fuse_kv=resolved == ExecutionMode.TILE_STREAM,
                    keep_tokens=keep, hbm_bytes=0, rewrite_cycles=0)
                lp = dataclasses.replace(
                    lp, hbm_bytes=_predict_bytes(lp, resolved, hw_cfg),
                    rewrite_cycles=_predict_rewrites(lp, resolved, hw_cfg))
                layers.append(lp)
            else:
                gemms.append(GemmPlan(op_index=op_index,
                                      layer_index=layer.index, name=op.name,
                                      m=op.m, k=op.k, n=op.n, mode=cur_mode))
            op_index += 1

    plan = ExecutionPlan(model=cfg.name, shape=shape_name, hw=hw_cfg.name,
                         hw_params=dataclasses.asdict(hw_cfg),
                         seq_len=seq, layers=tuple(layers),
                         gemms=tuple(gemms))
    if layer_modes:
        plan = plan.with_layer_modes(layer_modes)
    return plan


def plan_attention(mode: ExecutionMode, *, seq_q: int, seq_kv: int,
                   d_kv: int, heads: int, kv_heads: int, head_dim: int,
                   d_q: Optional[int] = None,
                   hw: Union[str, HardwareConfig, None] = None,
                   block_q: int = DEFAULT_BLOCK,
                   block_kv: int = DEFAULT_BLOCK,
                   bytes_per_el: Optional[int] = None,
                   name: str = "attn", cross: bool = False,
                   force_mode: bool = True,
                   attn_kind: AttnKind = AttnKind.FULL,
                   fuse_kv_generation: bool = True) -> LayerPlan:
    """Build a single ad-hoc ``LayerPlan`` from raw geometry — the planner
    entry point for one attention layer outside a full model (benchmarks,
    the ``attention_by_mode`` deprecation shim, unit tests).

    ``force_mode=True`` (default) pins ``mode`` verbatim, matching the
    legacy dispatch semantics; ``force_mode=False`` applies the resolution
    rules.  ``bytes_per_el`` overrides the hardware's DMA element width
    for the traffic prediction (e.g. 2 for bf16 projections).
    """
    hw_cfg = resolve_hw(hw)
    resolved = mode if force_mode else resolve_layer_mode(
        mode, d_kv=d_kv, num_kv_heads=kv_heads, head_dim=head_dim,
        attn_kind=attn_kind, fuse_kv_generation=fuse_kv_generation)
    lp = LayerPlan(
        op_index=0, layer_index=0, name=name, mode=resolved,
        seq_q=seq_q, seq_kv=seq_kv, d_q=d_q or d_kv, d_kv=d_kv,
        heads=heads, kv_heads=kv_heads, head_dim=head_dim, cross=cross,
        block_q=block_q, block_kv=block_kv,
        fuse_kv=resolved == ExecutionMode.TILE_STREAM,
        keep_tokens=seq_q, hbm_bytes=0, rewrite_cycles=0)
    be = bytes_per_el if bytes_per_el is not None else hw_cfg.act_bytes
    hbm = attn_hbm_bytes(seq_q, seq_kv, d_kv, heads, kv_heads, head_dim,
                         resolved, block_q=block_q, bytes_per_el=be)
    return dataclasses.replace(
        lp, hbm_bytes=hbm,
        rewrite_cycles=_predict_rewrites(lp, resolved, hw_cfg,
                                         act_bytes=be))
