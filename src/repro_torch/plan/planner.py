"""``plan_model``: one compile→plan step for the kernels and the serving
engine (copy of ``repro/plan/planner.py``).

An ``ExecutionPlan`` records StreamDCIM's reconfiguration decision for one
(model, shape, hardware) triple: per-attention-layer execution mode, block
tiling, fuse/prune decisions, and the predicted per-layer HBM bytes and
CIM rewrite cycles.  The port consumes it in
``kernels.ops.attention_by_plan`` (via ``models.transformer.prefill``) and
``serve.engine.Engine``.  Layer enumeration reuses the workload lowering
(``sim.workload``), as in the JAX package.

Left out: the record/replay hooks (``KernelTrace`` attachment,
``attach_traces``, ``traced_ops``) and ``plan_attention``; record/replay
is ROADMAP Queue 1 item 8.  The ``trace`` field stays, always None, so
that plans serialize exactly as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Mapping, Optional, Tuple, Union

from repro_torch.configs.hardware import HW_PRESETS, HardwareConfig
from repro_torch.core.types import (ExecutionMode, ModelConfig, ShapeConfig,
                                    SHAPES)
from repro_torch.plan.heuristics import (DEFAULT_BLOCK, attn_hbm_bytes,
                                         resolve_layer_mode)

PLAN_VERSION = 1


def _decode_record(rec: Mapping[str, object]) -> Dict[str, object]:
    rec = dict(rec)
    rec["mode"] = ExecutionMode(rec["mode"])
    if rec.get("trace") is not None:
        raise NotImplementedError(
            "plans with recorded kernel traces: record/replay is not ported "
            "(ROADMAP Queue 1 item 8)")
    return rec


def _encode_record(obj) -> Dict[str, object]:
    d = dataclasses.asdict(obj)
    d["mode"] = obj.mode.value
    return d


# ---------------------------------------------------------------------------
# Plan dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """The resolved decision record for one attention layer (paper-sense:
    one attention op, including its Q projection and KV generation)."""

    op_index: int          # position in the lowered op stream
    layer_index: int       # model layer this op belongs to
    name: str              # op tag (e.g. "l3_self") — stable across paths
    mode: ExecutionMode    # resolved mode (NOT the requested one)
    seq_q: int
    seq_kv: int
    d_q: int               # width of the query-side activations
    d_kv: int              # width of the KV-source activations
    heads: int
    kv_heads: int
    head_dim: int
    cross: bool            # K/V generated from the *other* stream
    block_q: int           # q-tile edge handed to the kernels
    block_kv: int          # kv-tile edge
    fuse_kv: bool          # generation-fusion on (== mode is TILE_STREAM)
    keep_tokens: int       # DTPU prune decision: kept q tokens
    hbm_bytes: int         # predicted streamed HBM bytes for this layer
    rewrite_cycles: int    # predicted CIM write-port cycles for this layer
    trace: None = None     # recorded kernel timing: not ported, always None


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A plain weight-stationary GEMM (FFN matmul, output projection).
    ``mode`` is the enclosing layer's resolved mode."""

    op_index: int
    layer_index: int
    name: str
    m: int
    k: int
    n: int
    mode: ExecutionMode
    trace: None = None     # not ported, always None (see LayerPlan)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The compile→plan artifact for one (model, shape, hw) triple."""

    model: str
    shape: str             # shape-cell name, or "seq<N>" / "default"
    hw: str                # HardwareConfig name (preset or ad-hoc)
    seq_len: int           # requested sequence length (0 = model default)
    layers: Tuple[LayerPlan, ...]
    gemms: Tuple[GemmPlan, ...] = ()
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
        return sum(lp.hbm_bytes for lp in self.layers)

    @property
    def total_rewrite_cycles(self) -> int:
        return sum(lp.rewrite_cycles for lp in self.layers)

    # ---------- heterogeneous re-planning ----------

    def with_layer_modes(
            self, overrides: Mapping[Union[int, str], ExecutionMode]
    ) -> "ExecutionPlan":
        """A new plan with some layers forced to different modes.

        Keys are op names (``"l0_self"``) or model layer indices (all
        attention ops of that layer).  Predicted bytes / rewrite cycles are
        recomputed for the affected layers; each gemm follows the nearest
        *preceding* attention op of its layer (``plan_model``'s rule).
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
                lp = dataclasses.replace(
                    lp, mode=mode,
                    fuse_kv=mode == ExecutionMode.TILE_STREAM,
                    hbm_bytes=_predict_bytes(lp, mode, hw),
                    rewrite_cycles=_predict_rewrites(lp, mode, hw))
            new_layers.append(lp)
        attn_by_layer: Dict[int, list] = {}
        for lp in new_layers:                    # op order is preserved
            attn_by_layer.setdefault(lp.layer_index, []).append(lp)

        def regem(g: GemmPlan) -> GemmPlan:
            preceding = [lp.mode for lp in attn_by_layer.get(g.layer_index, [])
                         if lp.op_index < g.op_index]
            m = preceding[-1] if preceding else g.mode
            return g if m == g.mode else dataclasses.replace(g, mode=m)

        return dataclasses.replace(self, layers=tuple(new_layers),
                                   gemms=tuple(regem(g) for g in self.gemms))

    # ---------- serialization ----------

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": PLAN_VERSION,
            "model": self.model, "shape": self.shape, "hw": self.hw,
            "hw_params": dict(self.hw_params),
            "seq_len": self.seq_len,
            "layers": [_encode_record(lp) for lp in self.layers],
            "gemms": [_encode_record(g) for g in self.gemms],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "ExecutionPlan":
        if d.get("version") != PLAN_VERSION:
            raise ValueError(f"unsupported plan version {d.get('version')!r}")
        layers = tuple(LayerPlan(**_decode_record(lp)) for lp in d["layers"])
        gemms = tuple(GemmPlan(**_decode_record(g))
                      for g in d.get("gemms", []))
        return cls(model=d["model"], shape=d["shape"], hw=d["hw"],
                   hw_params=dict(d.get("hw_params", {})),
                   seq_len=int(d["seq_len"]), layers=layers, gemms=gemms)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Prediction helpers (the simulator's scheduler arithmetic)
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
                      hw: HardwareConfig) -> int:
    """CIM write-port cycles spent rewriting K/V for this layer: streaming
    modes rewrite one KV tile per (q-block, kv-tile) pair; NON_STREAM
    rewrites K and V whole."""
    rbpc = hw.rewrite_bytes_per_cycle
    ab = hw.act_bytes
    if mode == ExecutionMode.NON_STREAM:
        k_bytes = lp.seq_kv * lp.kv_heads * lp.head_dim * ab
        return 2 * math.ceil(k_bytes / rbpc)
    nqb = math.ceil(lp.seq_q / lp.block_q)
    nkb = math.ceil(lp.seq_kv / lp.block_kv)
    kv_tile_bytes = 2 * lp.block_kv * lp.kv_heads * lp.head_dim * ab
    return nqb * nkb * math.ceil(kv_tile_bytes / rbpc)


# ---------------------------------------------------------------------------
# plan_model
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
      is used unless an explicit ``seq_len`` is given.
    * ``mode`` — the requested execution mode (default:
      ``cfg.execution_mode``), subject to the per-layer rules
      (``plan.heuristics``) unless ``force_mode=True``.
    * ``layer_modes`` — per-layer overrides ({op name | layer index:
      mode}) applied after resolution: the heterogeneous-plan entry point.
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
