"""Plain PyTorch oracles (counterpart of ``repro/kernels/ref.py``).

They define the numerics the kernels must match and are the NON_STREAM path
(every intermediate materialized).  Layouts are the JAX package's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # large-negative instead of -inf: a query that attends to
                 # zero keys gets a finite row, not NaN.


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE.  x: (..., seq, head_dim); sin/cos: (seq, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    shape = (1,) * (x.dim() - 2) + tuple(sin.shape)
    sin = sin.reshape(shape).to(x.dtype)
    cos = cos.reshape(shape).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_tables(seq_len: int, head_dim: int, theta: float = 10_000.0,
                offset: int = 0, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half))
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * freqs[None, :]
    return torch.sin(ang), torch.cos(ang)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gamma.to(x.dtype)


def _attn_mask(sq: int, sk: int, causal: bool, window: int, q_offset: int,
               device) -> Optional[torch.Tensor]:
    """(sq, sk) boolean mask, True = attend.  q_offset aligns decode steps."""
    if not causal and window <= 0:
        return None
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    return mask


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: int = 0, q_offset: int = 0,
                  scale: Optional[float] = None,
                  return_scores: bool = False):
    """Multi-head attention with GQA.

    q: (B, Hq, Sq, hd); k: (B, Hkv, Sk, hd); v: (B, Hkv, Sk, hdv).
    Returns (B, Hq, Sq, hdv) and, optionally, token-importance scores
    (B, Sk): the column mean of the probabilities over heads and queries.
    """
    B, Hq, Sq, hd = q.shape
    Hkv, Sk, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = hd ** -0.5
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    mask = _attn_mask(Sq, Sk, causal, window, q_offset, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = o.reshape(B, Hq, Sq, hdv).to(q.dtype)
    if return_scores:
        scores = p.sum(dim=(1, 2, 3)) / (Hq * Sq)   # (B, Sk) column mean
        return o, scores
    return o


def ref_stream_attention(q: torch.Tensor, x_kv: torch.Tensor,
                         wk: torch.Tensor, wv: torch.Tensor, *,
                         sin: Optional[torch.Tensor] = None,
                         cos: Optional[torch.Tensor] = None,
                         k_gamma: Optional[torch.Tensor] = None,
                         causal: bool = False, window: int = 0,
                         q_offset: int = 0,
                         return_scores: bool = False):
    """Oracle of the fused K/V-generation + attention kernel; it
    materializes K = rope(qknorm(x_kv @ wk)) and V = x_kv @ wv.

    q: (B, Hq, Sq, hd) already projected; x_kv: (B, Sk, D); wk/wv: (D, Hkv, hd).
    """
    k = torch.einsum("bsd,dhe->bhse", x_kv.float(), wk.float())
    v = torch.einsum("bsd,dhe->bhse", x_kv.float(), wv.float())
    if k_gamma is not None:
        k = rms_norm(k, k_gamma.float())
    if sin is not None:
        k = apply_rope(k, sin, cos)
    return ref_attention(q, k.to(q.dtype), v.to(q.dtype), causal=causal,
                         window=window, q_offset=q_offset,
                         return_scores=return_scores)


def ref_tile_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) with f32 accumulation, output in x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def ref_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, *,
                         window: int = 0) -> torch.Tensor:
    """Single-token decode attention oracle (ref.py:168).

    q: (B, Hq, 1, hd); caches: (B, Hkv, Smax, hd); cache_len: () or (B,)
    int, the number of valid cache entries (new token's K/V already
    written).  A row with no valid entry softmaxes over all-masked scores
    (a uniform average of V), as the JAX oracle does.
    """
    B, Hq, _, hd = q.shape
    Hkv, Smax = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float()) * hd ** -0.5
    pos = torch.arange(Smax, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos < clen
    if window > 0:
        valid = valid & (pos > clen - 1 - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, hd).to(q.dtype)


def ref_ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, *,
            initial_state: Optional[torch.Tensor] = None,
            return_final_state: bool = False):
    """Mamba-2 SSD oracle, the sequential scan (ref.py:127).

    x (B, S, H, P) per-head inputs; dt (B, S, H) step sizes (already
    positive); a (H,) negative decay rates; b/c (B, S, N) input and output
    projections, shared by the heads.  Per step, in f32:
    state = exp(dt·a)·state + (x·dt) bᵀ and y = state · c.  Returns y
    (B, S, H, P) in x's dtype and, if asked, the final state (B, H, P, N).
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    decay = torch.exp(dtf * a.float()[None, None, :])          # (B, S, H)
    state = (torch.zeros((B, H, P, N), device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, state) if return_final_state else y
