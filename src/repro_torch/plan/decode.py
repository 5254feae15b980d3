"""``plan_decode_step``: the decode-side half of the compile→plan API
(copy of ``repro/plan/decode.py``).

A ``DecodePlan`` compiles one serving step whose active slots attend KV
caches of different lengths: per attention layer the resolved execution
mode, the per-slot KV length the layer attends over after DTPU pruning,
and the predicted HBM bytes and CIM rewrite cycles of the step.  The
port's ``serve.engine.Engine`` compiles one per decode step, as the JAX
engine does.  Left out, as in ``planner.py``: the record/replay hooks
(``trace`` stays, always None) and ``plan_decode_buckets``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.configs.hardware import HardwareConfig
from repro_torch.core.types import (AttnKind, ExecutionMode, Family,
                                    ModelConfig, pad_to)
from repro_torch.plan.heuristics import (DEFAULT_BLOCK, decode_attn_hbm_bytes,
                                         decode_rewrite_cycles,
                                         resolve_layer_mode)
from repro_torch.plan.planner import (GemmPlan, _decode_record,
                                      _encode_record, resolve_hw)

DECODE_PLAN_VERSION = 1

#: suffix distinguishing decode-step ops from their prefill counterparts.
DECODE_SUFFIX = ".decode"


@dataclasses.dataclass(frozen=True)
class DecodeLayerPlan:
    """The resolved decision record for one attention layer of one decode
    step, across all active slots."""

    op_index: int
    layer_index: int
    name: str              # prefill op tag + ``.decode`` (e.g. "l3_self.decode")
    mode: ExecutionMode
    seq_kv: Tuple[int, ...]  # per-slot KV length attended (post-pruning,
                             # post window clamp, incl. the new token)
    d_q: int
    d_kv: int
    heads: int
    kv_heads: int
    head_dim: int
    cross: bool            # static KV (enc-dec cross-attn: no append)
    block_kv: int
    hbm_bytes: int         # predicted streamed HBM bytes, summed over slots
    rewrite_cycles: int    # predicted CIM write-port cycles, summed
    trace: None = None     # recorded kernel timing: not ported, always None


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The compile→plan artifact for one decode step of a slot batch."""

    model: str
    hw: str
    context: Tuple[int, ...]   # per-slot cache length incl. the new token
    layers: Tuple[DecodeLayerPlan, ...]
    gemms: Tuple[GemmPlan, ...] = ()
    hw_params: Mapping[str, object] = dataclasses.field(default_factory=dict)

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
    def total_hbm_bytes(self) -> int:
        return sum(lp.hbm_bytes for lp in self.layers)

    @property
    def total_rewrite_cycles(self) -> int:
        return sum(lp.rewrite_cycles for lp in self.layers)

    def to_dict(self) -> Dict[str, object]:
        def enc(obj):
            d = _encode_record(obj)
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
            rec = _decode_record(rec)
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


def _decode_attn_specs(cfg: ModelConfig) -> List[Dict[str, object]]:
    """The attention ops one decode step runs, in op order, named after
    their ``sim.workload`` prefill counterparts."""
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
    *including* the token being decoded; a bare int plans a single slot.
    Per layer: the resolved mode (``force_mode=True`` pins the requested
    one), ``seq_kv`` per slot (context clamped by the sliding window, then
    by the DTPU prune decision), and predicted HBM bytes and rewrite
    cycles summed over slots.  The step's GEMMs (output projection + FFN,
    one token per slot) ride along as ``GemmPlan``s.
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
