"""Per-layer execution-mode rule (copy of ``repro/plan/heuristics.py:36-64``).

Fusing K/V generation into attention (TILE_STREAM) reduces streamed bytes
iff streaming the raw activations ``x_kv`` (width ``d_kv``) beats streaming
materialized K/V (width ``2·Hkv·hd``).
"""
from __future__ import annotations

from repro_torch.core.types import AttnKind, ExecutionMode


def tile_stream_profitable(d_model: int, num_kv_heads: int,
                           head_dim: int) -> bool:
    """True iff fused KV-generation reduces streamed HBM bytes.

    ``d_model`` is the width of the KV-*source* activations (the other
    modality's width for cross-attention).
    """
    return 2 * num_kv_heads * head_dim >= d_model


def resolve_layer_mode(requested: ExecutionMode, *, d_kv: int,
                       num_kv_heads: int, head_dim: int,
                       attn_kind: AttnKind = AttnKind.FULL,
                       fuse_kv_generation: bool = True) -> ExecutionMode:
    """Honors an explicit NON_STREAM / LAYER_STREAM request; for
    TILE_STREAM applies the profitability rule unless the layer is MLA
    (always fuse) or ``fuse_kv_generation`` is off."""
    if requested != ExecutionMode.TILE_STREAM:
        return requested
    if attn_kind == AttnKind.MLA:
        return ExecutionMode.TILE_STREAM
    if fuse_kv_generation and tile_stream_profitable(d_kv, num_kv_heads,
                                                     head_dim):
        return ExecutionMode.TILE_STREAM
    return ExecutionMode.LAYER_STREAM
