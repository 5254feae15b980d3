"""``repro_torch.plan``: the compile→plan API (counterpart of
``repro/plan/__init__.py``).  ``plan_model`` compiles one (model, shape,
hardware) triple into an ``ExecutionPlan`` of per-layer modes and tilings;
``plan_decode_step`` compiles one serving step into a ``DecodePlan``.
"""
from repro_torch.plan.decode import (DECODE_PLAN_VERSION, DecodeLayerPlan,
                                     DecodePlan, plan_decode_step)
from repro_torch.plan.heuristics import (DEFAULT_BLOCK, attn_hbm_bytes,
                                         decode_attn_hbm_bytes,
                                         decode_rewrite_cycles,
                                         resolve_layer_mode,
                                         tile_stream_profitable)
from repro_torch.plan.planner import (PLAN_VERSION, ExecutionPlan, GemmPlan,
                                      LayerPlan, plan_model, resolve_hw)

__all__ = [
    "DEFAULT_BLOCK", "attn_hbm_bytes", "decode_attn_hbm_bytes",
    "decode_rewrite_cycles", "resolve_layer_mode", "tile_stream_profitable",
    "ExecutionPlan", "LayerPlan", "GemmPlan", "PLAN_VERSION", "plan_model",
    "resolve_hw", "DecodePlan", "DecodeLayerPlan", "DECODE_PLAN_VERSION",
    "plan_decode_step",
]
