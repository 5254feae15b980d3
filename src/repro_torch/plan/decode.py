"""``plan_decode_step``: the decode-side half of the compile→plan API
(DESIGN.md §11).

A prefill ``ExecutionPlan`` describes one *shape*; serving traffic is a
timeline of *steps*, each advancing a set of slots whose KV caches have
different lengths.  ``plan_decode_step`` compiles one such step into a
``DecodePlan``: per attention layer, the resolved execution mode (the same
TBR-CIM hybrid/normal reconfiguration decision the prefill planner makes),
the per-slot KV length the layer actually attends over after DTPU pruning
(``PruningConfig.kept_tokens`` — the ``LayerPlan.keep_tokens`` decision,
now *load-bearing*: it shrinks ``seq_kv`` layer by layer), and the
predicted HBM bytes + CIM rewrite cycles for the step.

Like ``ExecutionPlan``, one ``DecodePlan`` object drives the port's paths:

* ``kernels.ops.decode_attention_by_plan`` and
  ``batched_decode_attention_by_plan`` — the decode attention kernel
  (records ``KernelTrace``s under ``sim.replay``), and
* ``serve.Engine``                       — the live engine, which compiles
  one per decode step from its active slots' cache lengths, and
* ``sim.simulate_serve``                 — the serving-timeline simulator.

Plans serialize (``to_json``) alongside ``ExecutionPlan`` with the same
versioned-dict discipline, traces included.

Copy of ``repro/plan/decode.py``: the same code, its imports pointed at the
port's copies (``repro_torch``).  The port's kernels record traces through
``repro_torch.kernels.ops`` and ``repro_torch.sim.replay``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple, TYPE_CHECKING, Union)

from repro_torch.core.types import (AttnKind, ExecutionMode, Family,
                                    ModelConfig, pad_to)
from repro_torch.configs.hardware import HW_PRESETS, HardwareConfig
from repro_torch.plan.heuristics import (DEFAULT_BLOCK, decode_attn_hbm_bytes,
                                         decode_rewrite_cycles,
                                         resolve_layer_mode)
from repro_torch.plan.planner import GemmPlan, resolve_hw

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.sim.replay import KernelTrace

DECODE_PLAN_VERSION = 1

#: suffix distinguishing decode-step ops from their prefill counterparts,
#: so a prefill ``KernelTrace`` can never attach to a decode op (and vice
#: versa) by name collision.
DECODE_SUFFIX = ".decode"


@dataclasses.dataclass(frozen=True)
class DecodeLayerPlan:
    """The resolved decision record for one attention layer of one decode
    step, across all active slots."""

    op_index: int          # position in the lowered op stream
    layer_index: int       # model layer this op belongs to
    name: str              # prefill op tag + ``.decode`` (e.g. "l3_self.decode")
    mode: ExecutionMode    # resolved macro mode for this step's layer
    seq_kv: Tuple[int, ...]  # per-slot KV length *attended* (post-pruning,
                             # post window clamp, incl. the new token); the
                             # unpruned lengths live on DecodePlan.context
    d_q: int
    d_kv: int
    heads: int
    kv_heads: int
    head_dim: int
    cross: bool            # static KV (enc-dec cross-attn: no append)
    block_kv: int          # kv-tile edge the rewrite schedule iterates with
    hbm_bytes: int         # predicted streamed HBM bytes, summed over slots
    rewrite_cycles: int    # predicted CIM write-port cycles, summed
    trace: Optional["KernelTrace"] = None   # recorded decode kernel timing

    @property
    def kv_width(self) -> int:
        return 2 * self.kv_heads * self.head_dim

    @property
    def keep_tokens(self) -> Tuple[int, ...]:
        """Per-slot kept KV tokens — ``seq_kv`` IS the DTPU prune decision
        (named to echo ``LayerPlan.keep_tokens``)."""
        return self.seq_kv

    def attach_trace(self, trace: Optional["KernelTrace"]
                     ) -> "DecodeLayerPlan":
        if trace is not None and trace.op != self.name:
            raise ValueError(f"trace for op {trace.op!r} cannot attach to "
                             f"DecodeLayerPlan {self.name!r}")
        return dataclasses.replace(self, trace=trace)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The compile→plan artifact for one decode step of a slot batch."""

    model: str
    hw: str
    context: Tuple[int, ...]   # per-slot cache length incl. the new token
    layers: Tuple[DecodeLayerPlan, ...]
    gemms: Tuple[GemmPlan, ...] = ()
    hw_params: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def hw_config(self) -> HardwareConfig:
        if self.hw_params:
            return HardwareConfig(**self.hw_params)
        return HW_PRESETS[self.hw]

    # ---------- inspection ----------

    @property
    def slots(self) -> int:
        return len(self.context)

    @property
    def modes(self) -> Tuple[ExecutionMode, ...]:
        seen: List[ExecutionMode] = []
        for lp in self.layers:
            if lp.mode not in seen:
                seen.append(lp.mode)
        return tuple(seen)

    @property
    def uniform_mode(self) -> Optional[ExecutionMode]:
        ms = self.modes
        return ms[0] if len(ms) == 1 else None

    @property
    def heterogeneous(self) -> bool:
        return len(self.modes) > 1

    @property
    def total_hbm_bytes(self) -> int:
        """Predicted attention HBM traffic for the whole step (the number
        ``sim.simulate_serve`` cross-asserts against)."""
        return sum(lp.hbm_bytes for lp in self.layers)

    @property
    def total_rewrite_cycles(self) -> int:
        return sum(lp.rewrite_cycles for lp in self.layers)

    @property
    def traced_ops(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.layers + self.gemms
                     if p.trace is not None)

    def layer(self, key: Union[int, str]) -> DecodeLayerPlan:
        """Look up by op name, or by position in ``self.layers``."""
        if isinstance(key, str):
            for lp in self.layers:
                if lp.name == key:
                    return lp
            raise KeyError(key)
        return self.layers[key]

    def summary(self) -> Dict[str, object]:
        counts: Dict[str, int] = {}
        for lp in self.layers:
            counts[lp.mode.value] = counts.get(lp.mode.value, 0) + 1
        return {
            "model": self.model, "hw": self.hw,
            "slots": self.slots, "context": list(self.context),
            "attention_layers": len(self.layers), "modes": counts,
            "heterogeneous": self.heterogeneous,
            "total_hbm_bytes": self.total_hbm_bytes,
            "total_rewrite_cycles": self.total_rewrite_cycles,
            "traced_ops": len(self.traced_ops),
        }

    # ---------- trace attachment (repro.sim.replay) ----------

    def attach_traces(self, traces: Union[Mapping[str, object],
                                          Iterable[object]]) -> "DecodePlan":
        """Attach recorded ``KernelTrace``s to the decode ops they name —
        same contract as ``ExecutionPlan.attach_traces`` (records naming
        no plan op are ignored)."""
        if isinstance(traces, Mapping):
            by_op = dict(traces)
        else:
            by_op = {t.op: t for t in traces}
        layers = tuple(lp.attach_trace(by_op[lp.name])
                       if lp.name in by_op else lp for lp in self.layers)
        gemms = tuple(g.attach_trace(by_op[g.name])
                      if g.name in by_op else g for g in self.gemms)
        return dataclasses.replace(self, layers=layers, gemms=gemms)

    def without_traces(self) -> "DecodePlan":
        return dataclasses.replace(
            self,
            layers=tuple(lp.attach_trace(None) for lp in self.layers),
            gemms=tuple(g.attach_trace(None) for g in self.gemms))

    # ---------- serialization ----------

    def to_dict(self) -> Dict[str, object]:
        def enc(obj):
            d = dataclasses.asdict(obj)
            d["mode"] = obj.mode.value
            d["trace"] = obj.trace.to_dict() if obj.trace else None
            if "seq_kv" in d:
                d["seq_kv"] = list(d["seq_kv"])
            return d
        return {
            "version": DECODE_PLAN_VERSION,
            "model": self.model, "hw": self.hw,
            "hw_params": dict(self.hw_params),
            "context": list(self.context),
            "layers": [enc(lp) for lp in self.layers],
            "gemms": [enc(g) for g in self.gemms],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "DecodePlan":
        if d.get("version") != DECODE_PLAN_VERSION:
            raise ValueError(
                f"unsupported decode-plan version {d.get('version')!r}")

        def dec(rec):
            rec = dict(rec)
            rec["mode"] = ExecutionMode(rec["mode"])
            tr = rec.get("trace")
            if tr is not None:
                from repro_torch.sim.replay import KernelTrace
                rec["trace"] = KernelTrace.from_dict(tr)
            if "seq_kv" in rec:
                rec["seq_kv"] = tuple(rec["seq_kv"])
            return rec

        layers = tuple(DecodeLayerPlan(**dec(lp)) for lp in d["layers"])
        gemms = tuple(GemmPlan(**dec(g)) for g in d.get("gemms", []))
        return cls(model=d["model"], hw=d["hw"],
                   hw_params=dict(d.get("hw_params", {})),
                   context=tuple(d["context"]), layers=layers, gemms=gemms)

    @classmethod
    def from_json(cls, s: str) -> "DecodePlan":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Decode-op enumeration (mirrors sim.workload's prefill naming)
# ---------------------------------------------------------------------------

def _decode_attn_specs(cfg: ModelConfig) -> List[Dict[str, object]]:
    """The attention ops one decode step runs, in op order, named after
    their ``sim.workload`` prefill counterparts.  Decoder families run one
    self-attention per layer; enc-dec decoders add the static-KV
    cross-attention.  Attention-free and encoder-only families have no
    decode step — same contract as ``registry.cell_supported``."""
    if cfg.num_heads == 0 or cfg.attn_kind == AttnKind.NONE:
        raise ValueError(f"{cfg.name}: attention-free families have no "
                         "decode attention to plan")
    if cfg.family == Family.CROSSMODAL:
        raise ValueError(f"{cfg.name}: encoder-only (crossmodal) families "
                         "have no decode step")
    d = cfg.d_model
    hd = cfg.head_dim or d // cfg.num_heads
    specs: List[Dict[str, object]] = []
    if cfg.family == Family.ENCDEC:
        se = pad_to(cfg.encoder_seq, DEFAULT_BLOCK)
        for i in range(cfg.num_layers):
            specs.append(dict(tag=f"dec{i}_self", layer=i, cross=False,
                              d_q=d, d_kv=d, heads=cfg.num_heads,
                              kv_heads=cfg.num_kv_heads, hd=hd,
                              static_kv=0))
            specs.append(dict(tag=f"dec{i}_cross", layer=i, cross=True,
                              d_q=d, d_kv=d, heads=cfg.num_heads,
                              kv_heads=cfg.num_kv_heads, hd=hd,
                              static_kv=se))
        return specs
    for i in range(cfg.num_layers):
        specs.append(dict(tag=f"l{i}_self", layer=i, cross=False,
                          d_q=d, d_kv=d, heads=cfg.num_heads,
                          kv_heads=cfg.num_kv_heads, hd=hd, static_kv=0))
    return specs


def plan_decode_step(cfg: ModelConfig,
                     context: Union[int, Sequence[int]], *,
                     hw: Union[str, HardwareConfig, None] = None,
                     mode: Optional[ExecutionMode] = None,
                     force_mode: bool = False,
                     block_kv: int = DEFAULT_BLOCK) -> DecodePlan:
    """Compile one decode step into a ``DecodePlan``.

    ``context`` — per-active-slot KV length the step attends over
    *including* the token being decoded (i.e. ``prompt_len +
    tokens_generated_so_far + 1``); a bare int plans a single slot.

    Per layer, the plan records:

    * the resolved execution mode — same per-layer rule as ``plan_model``
      (``force_mode=True`` pins the requested mode verbatim);
    * ``seq_kv`` per slot: the context clamped by the sliding window
      (ring-buffer caches never exceed ``cfg.sliding_window``) and then by
      the DTPU prune decision ``PruningConfig.kept_tokens(layer, ...)`` —
      the ``LayerPlan.keep_tokens`` schedule applied to the KV cache, so
      deeper layers attend over monotonically fewer tokens;
    * predicted HBM bytes (``decode_attn_hbm_bytes``) and CIM rewrite
      cycles (``decode_rewrite_cycles``), summed over slots — the numbers
      ``sim.simulate_serve`` cross-asserts per step.

    The step's weight-stationary GEMMs (output projection + FFN, one token
    per slot) ride along as ``GemmPlan``s so the plan lowers
    self-contained, exactly like ``ExecutionPlan.gemms``.
    """
    hw_cfg = resolve_hw(hw)
    ctxs = (context,) if isinstance(context, int) else tuple(context)
    if not ctxs or any(c < 1 for c in ctxs):
        raise ValueError(f"context lengths must be >= 1, got {ctxs!r}")
    requested = mode or cfg.execution_mode
    specs = _decode_attn_specs(cfg)
    n_layers = max(s["layer"] for s in specs) + 1
    nslots = len(ctxs)

    layers: List[DecodeLayerPlan] = []
    gemms: List[GemmPlan] = []
    op_index = 0
    specs_of: Dict[int, List[Dict[str, object]]] = {}
    for s in specs:
        specs_of.setdefault(s["layer"], []).append(s)
    d, d_ff = cfg.d_model, cfg.d_ff
    for li in sorted(specs_of):
        cur_mode = requested
        for s in specs_of[li]:
            if force_mode:
                resolved = requested
            else:
                resolved = resolve_layer_mode(
                    requested, d_kv=s["d_kv"], num_kv_heads=s["kv_heads"],
                    head_dim=s["hd"], attn_kind=cfg.attn_kind,
                    fuse_kv_generation=cfg.fuse_kv_generation)
            cur_mode = resolved
            per_slot: List[int] = []
            for c in ctxs:
                kv = c if not s["static_kv"] else int(s["static_kv"])
                if not s["static_kv"] and cfg.attn_kind == AttnKind.SLIDING:
                    kv = min(kv, cfg.sliding_window)
                if cfg.pruning.enabled:
                    kv = min(kv, max(1, cfg.pruning.kept_tokens(
                        s["layer"], n_layers, kv)))
                per_slot.append(kv)
            append = not s["cross"]
            hbm = sum(decode_attn_hbm_bytes(
                kv, s["heads"], s["kv_heads"], s["hd"], resolved,
                append=append, bytes_per_el=hw_cfg.act_bytes)
                for kv in per_slot)
            rw = sum(decode_rewrite_cycles(
                kv, s["kv_heads"], s["hd"], resolved, block_kv=block_kv,
                rewrite_bytes_per_cycle=hw_cfg.rewrite_bytes_per_cycle,
                bytes_per_el=hw_cfg.act_bytes) for kv in per_slot)
            layers.append(DecodeLayerPlan(
                op_index=op_index, layer_index=s["layer"],
                name=s["tag"] + DECODE_SUFFIX, mode=resolved,
                seq_kv=tuple(per_slot),
                d_q=s["d_q"], d_kv=s["d_kv"], heads=s["heads"],
                kv_heads=s["kv_heads"], head_dim=s["hd"], cross=s["cross"],
                block_kv=block_kv, hbm_bytes=hbm, rewrite_cycles=rw))
            op_index += 1
            gemms.append(GemmPlan(
                op_index=op_index, layer_index=s["layer"],
                name=f"{s['tag']}_oproj" + DECODE_SUFFIX,
                m=nslots, k=s["heads"] * s["hd"], n=s["d_q"], mode=resolved))
            op_index += 1
        # FFN stack per model layer (gated MLPs carry the extra gate
        # matmul, matching sim.workload._ffn_ops).
        prefix = f"dec{li}" if cfg.family == Family.ENCDEC else f"l{li}"
        ffn = [("ffn_up", d, d_ff)]
        if cfg.act == "silu":
            ffn.append(("ffn_gate", d, d_ff))
        ffn.append(("ffn_down", d_ff, d))
        for t, k, n in ffn:
            gemms.append(GemmPlan(
                op_index=op_index, layer_index=li,
                name=f"{prefix}_{t}" + DECODE_SUFFIX,
                m=nslots, k=k, n=n, mode=cur_mode))
            op_index += 1

    return DecodePlan(model=cfg.name, hw=hw_cfg.name,
                      hw_params=dataclasses.asdict(hw_cfg),
                      context=ctxs, layers=tuple(layers),
                      gemms=tuple(gemms))


def plan_decode_buckets(cfg: ModelConfig,
                        context: Sequence[int], *,
                        hw: Union[str, HardwareConfig, None] = None,
                        mode: Optional[ExecutionMode] = None,
                        force_mode: bool = False,
                        block_kv: int = DEFAULT_BLOCK
                        ) -> List[Tuple[Tuple[int, ...], DecodePlan]]:
    """Plan one decode step as per-shape-bucket ``DecodePlan``s.

    Slots with equal KV length share cache shape and position counter, so
    the batched engine advances each such *bucket* with one
    ``decode_step`` call.  Returns ``[(slot_positions, plan), ...]`` —
    positions index into ``context``, buckets appear in order of their
    first member — where each ``plan`` is ``plan_decode_step`` of that
    bucket's (uniform) context.

    Per-layer attention bytes/cycles and GEMM shapes are per-slot
    additive (the planner never couples slots), so bucket plans are exact
    slices of the whole-step plan: summed over buckets they reproduce
    ``plan_decode_step(cfg, context, ...)``'s ``total_hbm_bytes`` —
    ``sim.simulate_serve`` keeps cross-asserting the whole-step number,
    coarse lowering accounts it bucket-by-bucket.
    """
    ctxs = tuple(context)
    if not ctxs:
        raise ValueError("context must name at least one active slot")
    order: List[int] = []
    members: Dict[int, List[int]] = {}
    for i, c in enumerate(ctxs):
        c = int(c)
        if c not in members:
            members[c] = []
            order.append(c)
        members[c].append(i)
    return [(tuple(members[c]),
             plan_decode_step(cfg, (c,) * len(members[c]), hw=hw, mode=mode,
                              force_mode=force_mode, block_kv=block_kv))
            for c in order]
