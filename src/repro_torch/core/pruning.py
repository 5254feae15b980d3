"""DTPU dynamic token pruning (counterpart of ``repro/core/pruning.py``).

Token importance is the column mean of the attention probabilities: how
much attention mass flows into each token.  Kept counts are static per
layer; which tokens are kept is decided at run time.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import PruningConfig
from repro_torch.kernels import ref


def attention_column_scores(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = False,
                            sample_stride: int = 1) -> torch.Tensor:
    """Column mean of softmax(QK^T) over heads and (strided) queries.
    q: (B,Hq,Sq,hd), k: (B,Hkv,Sk,hd) -> scores (B, Sk)."""
    if sample_stride > 1:
        q = q[:, :, ::sample_stride]
    B, Hq, Sq, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // max(Hkv, 1)
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * hd ** -0.5
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] * sample_stride
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full_like(s, ref.NEG_INF))
    p = torch.softmax(s, dim=-1)
    return p.mean(dim=(1, 2, 3))                        # (B, Sk)


def select_tokens(scores: torch.Tensor, keep: int, *,
                  keep_order: bool = True) -> torch.Tensor:
    """Top-``keep`` token indices per row, ascending when ``keep_order``.
    Ties go to the lower index, as with ``jax.lax.top_k`` (a stable sort)."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = idx[:, :keep]
    if keep_order:
        idx = torch.sort(idx, dim=-1).values
    return idx


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D), idx: (B, keep) -> (B, keep, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def prune_stream(x: torch.Tensor, scores: torch.Tensor, keep: int,
                 positions: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Compact one stream to its ``keep`` most-attended tokens; returns
    (x_kept, kept_idx, positions_kept)."""
    idx = select_tokens(scores, keep)
    pos_kept = None if positions is None else torch.gather(positions, 1, idx)
    return gather_tokens(x, idx), idx, pos_kept


def keep_plan(pruning: PruningConfig, num_layers: int,
              seq_len: int) -> Tuple[int, ...]:
    """Static per-layer kept-token counts (monotone non-increasing)."""
    plan, prev = [], seq_len
    for layer in range(num_layers):
        n = min(pruning.kept_tokens(layer, num_layers, seq_len), prev)
        plan.append(n)
        prev = n
    return tuple(plan)


def pruning_compute_savings(plan: Tuple[int, ...], seq_len: int) -> float:
    """Fraction of attention FLOPs retained vs no pruning (quadratic term)."""
    full = len(plan) * seq_len * seq_len
    kept = sum(n * n for n in plan)
    return kept / full
