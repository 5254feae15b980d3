"""Legacy mode-selection entry points — deprecation shims over
``repro_torch.plan`` (copy of ``repro/core/streaming.py``, DESIGN.md §8).

The reconfiguration decision (per-layer mode selection, tiling,
traffic prediction) lives in the planner: build an ``ExecutionPlan`` with
``repro_torch.plan.plan_model`` and hand it to the kernels
(``kernels.ops.attention_by_plan``), the simulator
(``repro_torch.sim.simulate_plan``) and the serving engine
(``repro_torch.serve.Engine(plan=...)``).  The functions below keep the older
call sites working and are held (by ``tests/test_torch_obs.py``) to agree
with the planner; new code should call ``repro_torch.plan`` directly.

The decision itself — the TBR-CIM *mode_config* bit (hybrid vs normal
reconfiguration, paper §II-A) reborn as an analytic dataflow choice per
attention layer — is documented in ``repro_torch.plan.heuristics`` and
DESIGN.md §2: fusing KV-generation into attention (TILE_STREAM) wins for
MHA models (the paper's ViLBERT targets) and is traffic-negative for
aggressively-GQA LMs, which fall back to LAYER_STREAM.
"""
from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.core.types import ExecutionMode, ModelConfig
# Planner internals re-exported for back-compat
# (``repro_torch.plan.heuristics`` is the canonical home; this import is
# intentionally light — it does not pull in the planner or simulator).
from repro_torch.plan.heuristics import attn_hbm_bytes, resolve_layer_mode
from repro_torch.plan.heuristics import tile_stream_profitable  # noqa: F401

__all__ = ["tile_stream_profitable", "choose_mode",
           "streamed_bytes_per_layer"]


def _deprecated(old: str, new: str) -> None:
    # stacklevel=3: point past this helper and the shim at the caller.
    warnings.warn(
        f"repro_torch.core.streaming.{old} is deprecated; "
        f"migrate to {new}", DeprecationWarning, stacklevel=3)


def choose_mode(cfg: ModelConfig, *, d_model: Optional[int] = None,
                num_kv_heads: Optional[int] = None,
                head_dim: Optional[int] = None) -> ExecutionMode:
    """Resolve the execution mode for one attention layer.

    .. deprecated:: use ``repro_torch.plan.plan_model`` (whole-model
       resolution) or ``repro_torch.plan.resolve_layer_mode`` (one layer).
       Emits ``DeprecationWarning`` (test-pinned in
       ``tests/test_torch_obs.py``).
    """
    _deprecated("choose_mode",
                "repro_torch.plan.plan_model (whole model) or "
                "repro_torch.plan.heuristics.resolve_layer_mode (one layer)")
    return resolve_layer_mode(
        cfg.execution_mode,
        d_kv=d_model or cfg.d_model,
        num_kv_heads=num_kv_heads or cfg.num_kv_heads,
        head_dim=head_dim or cfg.head_dim,
        attn_kind=cfg.attn_kind,
        fuse_kv_generation=cfg.fuse_kv_generation)


def streamed_bytes_per_layer(seq_q: int, seq_kv: int, d_model: int,
                             num_heads: int, num_kv_heads: int, head_dim: int,
                             mode: ExecutionMode, *, block_q: int = 256,
                             bytes_per_el: int = 2) -> int:
    """Analytic HBM-traffic model for one attention layer (DESIGN.md §6).

    .. deprecated:: the planner records this prediction per layer
       in ``LayerPlan.hbm_bytes``; use ``repro_torch.plan.attn_hbm_bytes`` for
       raw-geometry queries.  Emits ``DeprecationWarning`` (test-pinned
       in ``tests/test_torch_obs.py``).
    """
    _deprecated("streamed_bytes_per_layer",
                "repro_torch.plan.heuristics.attn_hbm_bytes (raw geometry) or "
                "LayerPlan.hbm_bytes (planned layers)")
    return attn_hbm_bytes(seq_q, seq_kv, d_model, num_heads, num_kv_heads,
                          head_dim, mode, block_q=block_q,
                          bytes_per_el=bytes_per_el)
