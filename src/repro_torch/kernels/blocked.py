"""Plain PyTorch versions of the kernels (counterpart of
``repro/kernels/jnp_blocked.py`` and the forward passes of ``flash_vjp.py``).

Each follows its JAX mirror: an online softmax over kv blocks, and for the
stream version the K/V tile generated from ``x_kv`` inside the block loop;
the SSD scan's dense per-chunk products with the state carried in a loop
over chunks.
The kernel wrappers take these for CPU tensors; the CPU tests and the
kernel-against-plain checks on the card use them too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import NEG_INF, ref_tile_gemm


def _pad_axis(x: torch.Tensor, axis: int, multiple: int
              ) -> Tuple[torch.Tensor, int]:
    """Zero-pad ``axis`` of x up to a multiple; returns (x, original size)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - axis) + 1] = target - size
    return F.pad(x, pad), size


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, kv_len: int, causal: bool,
          window: int) -> torch.Tensor:
    mask = (kpos[None, :] < kv_len).expand(qpos.shape[0], -1)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An f32 tensor as two bf16 values, t ~ hi + lo with lo = bf16(t - hi),
    returned in f32: the tensor-core kernels' operands for an f32 value
    (about 16 bits of it)."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _qk(qf, k_j):
    return torch.einsum("bhgqd,bhkd->bhgqk", qf, k_j)


def _pv(p, v_j):
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v_j)


def _split_products(rounding: str, round_kv: bool, scale: float):
    """The (qk, pv) products of the tensor-core kernels' operands: P (and
    with ``round_kv`` K and V) enter as [hi, lo] ("split", leaving out
    lo x lo) or as [bf16(t)] ("bf16"); the scores are (Q K^T) * scale."""
    ops = _operands(rounding)

    def qk(qf, k_j):
        return _split_sum("bhgqd,bhkd->bhgqk", [qf],
                          ops(k_j) if round_kv else [k_j]) * scale

    def pv(p, v_j):
        return _split_sum("bhgqk,bhkd->bhgqd", ops(p),
                          ops(v_j) if round_kv else [v_j])

    return qk, pv


def _operands(rounding: str):
    """The tensor-core kernels' operands for an f32 tensor: [hi, lo]
    ("split") or [bf16(t)] ("bf16", what bf16 operands alone give)."""
    if rounding not in ("split", "bf16"):
        raise ValueError(f"rounding {rounding!r}: 'split' or 'bf16'")
    if rounding == "split":
        return lambda t: list(split_bf16(t))
    return lambda t: [t.bfloat16().float()]


def _split_sum(eq, a_ops, b_ops):
    """Σ einsum(eq, a_i, b_j) over the operand pairs with i + j < 2 (the
    kernels leave out lo x lo)."""
    return sum(torch.einsum(eq, a, b) for i, a in enumerate(a_ops)
               for j, b in enumerate(b_ops) if i + j < 2)


def _online_softmax(qf, kv_blocks, qpos, bk, sk, kv_len, causal, window,
                    out_shape, dtype, qk=_qk, pv=_pv, return_lse=False):
    """Shared block loop.  qf: (B,Hkv,G,Sq,hd) f32; kv_blocks yields (j,
    k_j (B,Hkv,bk,hd), v_j (B,Hkv,bk,hdv)) in f32, zero-padded past ``sk``
    keys; qk(qf, k_j) gives the scaled scores, pv(p, v_j) the products with
    V.  A row with no live key takes the softmax of equal -1e30 scores: the
    mean of V over the ``sk`` keys (padding weighs nothing).

    With ``return_lse`` also lse = m + log l per query row, (B, Hq, Sq) f32:
    the backward's residual (-1e30 for a row with no live key)."""
    B, Hkv, G, Sq, _ = qf.shape
    m = l = acc = None
    for j, k_j, v_j in kv_blocks:
        if acc is None:
            m = torch.full((B, Hkv, G, Sq), NEG_INF, device=qf.device)
            l = torch.zeros((B, Hkv, G, Sq), device=qf.device)
            acc = torch.zeros((B, Hkv, G, Sq, v_j.shape[-1]), device=qf.device)
        s = qk(qf, k_j)
        kpos = j * bk + torch.arange(bk, device=qf.device)
        s = torch.where(_mask(qpos, kpos, kv_len, causal, window), s,
                        torch.full_like(s, NEG_INF))
        s = torch.where(kpos < sk, s, torch.full_like(s, -torch.inf))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + pv(p, v_j)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe[..., None]).reshape(out_shape).to(dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l_safe)).reshape(B, Hkv * G, Sq)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False, window: int = 0,
                          q_offset: int = 0, scale: Optional[float] = None,
                          kv_len: Optional[int] = None,
                          block_k: int = 512, return_lse: bool = False):
    """GQA flash attention: q (B,Hq,Sq,hd), k (B,Hkv,Sk,hd), v (B,Hkv,Sk,hdv)
    -> (B,Hq,Sq,hdv), and with ``return_lse`` the rows' m + log l
    (B,Hq,Sq) f32.  Keys at or past ``kv_len`` are masked."""
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  scale=scale, kv_len=kv_len, block_k=block_k,
                  return_lse=return_lse)


def flash_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, rounding: str = "split", block_k: int = 64,
                          **kw) -> torch.Tensor:
    """``flash_attention_plain`` with the tensor-core kernel's operands: P
    enters P V as P_hi + P_lo ("split") or as bf16(P) ("bf16", what a
    product of bf16 P would give).  Q, K, V are the bf16 inputs."""
    return _flash(q, k, v, block_k=block_k,
                  products=lambda scale: _split_products(rounding, False,
                                                         scale), **kw)


def _flash(q, k, v, *, causal=False, window=0, q_offset=0, scale=None,
           kv_len=None, block_k=512, products=None, return_lse=False):
    B, Hq, Sq, hd = q.shape
    Hkv, Sk, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    bk = min(block_k, Sk)
    k, _ = _pad_axis(k, 2, bk)
    v, _ = _pad_axis(v, 2, bk)
    nkb = k.shape[2] // bk
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    blocks = ((j, k[:, :, j * bk:(j + 1) * bk].float(),
               v[:, :, j * bk:(j + 1) * bk].float()) for j in range(nkb))
    if products is None:
        return _online_softmax(qf * scale, blocks, qpos, bk, Sk, kv_len,
                               causal, window, (B, Hq, Sq, hdv), q.dtype,
                               return_lse=return_lse)
    return _online_softmax(qf, blocks, qpos, bk, Sk, kv_len, causal, window,
                           (B, Hq, Sq, hdv), q.dtype, *products(scale),
                           return_lse=return_lse)


def live_kv_tiles(r0: int, r1: int, Sq: int, *, sk: int, kv_len: int,
                  causal: bool = False, window: int = 0, q_offset: int = 0,
                  bk: int = 64) -> Tuple[int, int]:
    """The kv tiles [lo, hi) of ``bk`` keys that hold a live key for some
    row of the flattened (G x Sq) query rows [r0, r1) of a kv head: the
    range the CUDA kernels walk (``live_kv_tiles`` in attention_tc.cuh;
    ``flash_attention.live_tiles`` reads that one).  A span that crosses
    from one head's rows into the next holds both ends of the query range.
    A span that holds a row with no live key walks all ``sk`` keys' tiles:
    that row's output is the mean of V over them."""
    if r1 <= r0:
        return 0, 0
    if r0 // Sq == (r1 - 1) // Sq:
        qmin, qmax = r0 % Sq + q_offset, (r1 - 1) % Sq + q_offset
    else:
        qmin, qmax = q_offset, Sq - 1 + q_offset

    def live_keys(qpos):   # both ends grow with qpos
        return (max(0, qpos - window + 1) if window > 0 else 0,
                min(kv_len, qpos + 1) if causal else kv_len)

    (beg0, end0), (beg1, end1) = live_keys(qmin), live_keys(qmax)
    if end0 <= beg0 or end1 <= beg1:
        return 0, -(-sk // bk)
    return beg0 // bk, -(-end1 // bk)


FLASH_ROUTES = ("simt", "tc", "wide")   # flash_attention.cu's route codes


def flash_route(dtype: torch.dtype, hd: int, hdv: int,
                kv_aligned: bool = True, q_aligned: bool = True) -> str:
    """The route ``flash_attention.cu`` takes (``tc::dispatch``): f32 on
    the SIMT kernel; bf16 with hd and hdv multiples of 8 and k, v 16-byte
    aligned (``kv_aligned``) on ``tc`` up to 128 wide, and on ``wide`` for
    a head over 128 wide if q is 16-byte aligned too (``q_aligned``: the
    wide kernel reads Q by TMA); other bf16 shapes on the SIMT kernel."""
    if dtype != torch.bfloat16 or hd % 8 or hdv % 8 or not kv_aligned:
        return "simt"
    if hd > 128 or hdv > 128:
        return "wide" if q_aligned else "simt"
    return "tc"


def flash_attention_live(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False, window: int = 0,
                         q_offset: int = 0, scale: Optional[float] = None,
                         kv_len: Optional[int] = None, rows: int = 128,
                         bk: int = 64) -> torch.Tensor:
    """``flash_attention_plain`` walked as the CUDA kernel walks it: each
    block of ``rows`` flattened query rows of a kv head runs the online
    softmax over its ``live_kv_tiles`` only (a block with none gives 0)."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    k, _ = _pad_axis(k, 2, bk)
    v, _ = _pad_axis(v, 2, bk)
    qf = q.float().reshape(B, Hkv, G * Sq, hd) * scale
    out = torch.zeros((B, Hkv, G * Sq, hdv), device=q.device)
    for r0 in range(0, G * Sq, rows):
        r1 = min(r0 + rows, G * Sq)
        lo, hi = live_kv_tiles(r0, r1, Sq, sk=Sk, kv_len=kv_len,
                               causal=causal, window=window,
                               q_offset=q_offset, bk=bk)
        if hi <= lo:
            continue
        qpos = torch.arange(r0, r1, device=q.device) % Sq + q_offset
        blocks = ((j, k[:, :, j * bk:(j + 1) * bk].float(),
                   v[:, :, j * bk:(j + 1) * bk].float())
                  for j in range(lo, hi))
        out[:, :, r0:r1] = _online_softmax(
            qf[:, :, None, r0:r1], blocks, qpos, bk, Sk, kv_len, causal,
            window, (B, Hkv, r1 - r0, hdv), torch.float32)
    return out.reshape(B, Hq, Sq, hdv).to(q.dtype)


def stream_attention_plain(q: torch.Tensor, x_kv: torch.Tensor,
                           wk: torch.Tensor, wv: torch.Tensor, *,
                           sin: Optional[torch.Tensor] = None,
                           cos: Optional[torch.Tensor] = None,
                           k_gamma: Optional[torch.Tensor] = None,
                           causal: bool = False, window: int = 0,
                           q_offset: int = 0, scale: Optional[float] = None,
                           norm_eps: float = 1e-6,
                           kv_len: Optional[int] = None,
                           block_k: int = 512, return_lse: bool = False):
    """TILE_STREAM: K/V tiles generated from x_kv inside the block loop
    (never at full length), fed straight into the online softmax.

    q (B,Hq,Sq,hd), x_kv (B,Sk,D), wk/wv (D,Hkv,hd), sin/cos (Sk,hd//2),
    k_gamma (hd,) -> (B,Hq,Sq,hd), and with ``return_lse`` the rows'
    m + log l (B,Hq,Sq) f32."""
    return _stream(q, x_kv, wk, wv, sin=sin, cos=cos, k_gamma=k_gamma,
                   causal=causal, window=window, q_offset=q_offset,
                   scale=scale, norm_eps=norm_eps, kv_len=kv_len,
                   block_k=block_k, return_lse=return_lse)


def stream_attention_split(q: torch.Tensor, x_kv: torch.Tensor,
                           wk: torch.Tensor, wv: torch.Tensor, *,
                           rounding: str = "split", block_k: int = 64,
                           **kw) -> torch.Tensor:
    """``stream_attention_plain`` with the tensor-core kernel's operands:
    the generated (f32) K and V and the softmax's P enter the products as
    hi + lo bf16 pairs ("split"; Q K_hi^T + Q K_lo^T and P_hi V_hi +
    P_hi V_lo + P_lo V_hi) or rounded to bf16 ("bf16")."""
    return _stream(q, x_kv, wk, wv, block_k=block_k,
                   products=lambda scale: _split_products(rounding, True,
                                                          scale), **kw)


def _gen_tile(x_j, wkf, wvf, k_gamma, sin_j, cos_j, norm_eps):
    """One K/V tile from x_j (B, bk, D) f32 and f32 weights (D, Hkv, hd):
    projection, qk-norm (``k_gamma``), rotate-half RoPE (``sin_j``/``cos_j``
    (bk, hd//2)) -> k_j, v_j (B, Hkv, bk, hd) f32 (flash_vjp.py:222)."""
    k_j = torch.einsum("btd,dhe->bthe", x_j, wkf)
    v_j = torch.einsum("btd,dhe->bthe", x_j, wvf)
    k_j = _norm_rope(k_j, k_gamma, sin_j, cos_j, norm_eps)
    return k_j.transpose(1, 2), v_j.transpose(1, 2)


def _norm_rope(k_j, k_gamma, sin_j, cos_j, norm_eps):
    """qk-norm and rotate-half RoPE of generated keys (B, bk, Hkv, hd)."""
    if k_gamma is not None:
        var = (k_j * k_j).mean(dim=-1, keepdim=True)
        k_j = k_j * torch.rsqrt(var + norm_eps) * k_gamma.float()
    if sin_j is not None:
        half = k_j.shape[-1] // 2
        s_ = sin_j.float()[None, :, None]
        c_ = cos_j.float()[None, :, None]
        k1, k2 = k_j[..., :half], k_j[..., half:]
        k_j = torch.cat([k1 * c_ - k2 * s_, k2 * c_ + k1 * s_], dim=-1)
    return k_j


def _stream(q, x_kv, wk, wv, *, sin=None, cos=None, k_gamma=None,
            causal=False, window=0, q_offset=0, scale=None, norm_eps=1e-6,
            kv_len=None, block_k=512, products=None, return_lse=False):
    B, Hq, Sq, hd = q.shape
    Sk, D = x_kv.shape[1], x_kv.shape[2]
    Hkv = wk.shape[1]
    G = Hq // Hkv
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    bk = min(block_k, Sk)
    x_kv, _ = _pad_axis(x_kv, 1, bk)
    if sin is not None:
        sin, _ = _pad_axis(sin, 0, bk)
        cos, _ = _pad_axis(cos, 0, bk)
    nkb = x_kv.shape[1] // bk
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    wkf, wvf = wk.float(), wv.float()

    def gen(j):
        rows = slice(j * bk, (j + 1) * bk)
        return (j, *_gen_tile(x_kv[:, rows].float(), wkf, wvf, k_gamma,
                              None if sin is None else sin[rows],
                              None if cos is None else cos[rows], norm_eps))

    blocks = (gen(j) for j in range(nkb))
    if products is None:
        return _online_softmax(qf * scale, blocks, qpos, bk, Sk, kv_len,
                               causal, window, (B, Hq, Sq, hd), q.dtype,
                               return_lse=return_lse)
    return _online_softmax(qf, blocks, qpos, bk, Sk, kv_len, causal, window,
                           (B, Hq, Sq, hd), q.dtype, *products(scale),
                           return_lse=return_lse)


# ---------------------------------------------------------------------------
# Backward of flash and stream attention (flash_vjp.py:114, :267)
# ---------------------------------------------------------------------------

#: lse at or below this marks a row with no live key (its lse is -1e30).
DEAD_LSE = -1e29


def _tile_grads(qf, dof, lse, delta, k_j, v_j, kpos, qpos, sk, kv_len,
                causal, window, scale, ops=None, split_kv=False):
    """One kv tile of the two-pass flash backward: (dq_j, dk_j, dv_j) in
    f32 from qf/dof (B,Hkv,G,Sq,hd/hdv), lse/delta (B,Hkv,G,Sq) and the
    tile's k_j/v_j (B,Hkv,bk,hd/hdv).  P = exp(S*scale - lse) on live
    pairs, 0 on masked ones.  A row with no live key (lse -1e30) had the
    mean of V over the ``sk`` keys as its output: its P is 1/sk on those
    keys and no score gets a gradient.

    With ``ops`` (see ``_operands``) the products take the tensor-core
    route's operands: P and dS as ops(P), ops(dS), and with ``split_kv``
    K and V as ops(K), ops(V) (the stream kernel's generated tiles)."""
    if ops is not None:
        return _tile_grads_split(qf, dof, lse, delta, k_j, v_j, kpos, qpos,
                                 sk, kv_len, causal, window, scale, ops,
                                 split_kv)
    mask = _mask(qpos, kpos, kv_len, causal, window)        # (Sq, bk)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_j) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dead = (lse <= DEAD_LSE)[..., None]
    mean = (kpos < sk).to(p.dtype) / max(sk, 1)
    p = torch.where(dead, mean.expand_as(p), p)
    dv_j = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v_j)
    ds = torch.where(mask & ~dead, p * (dp - delta[..., None]) * scale,
                     torch.zeros_like(p))
    dq_j = torch.einsum("bhgqk,bhkd->bhgqd", ds, k_j)
    dk_j = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return dq_j, dk_j, dv_j


def _tile_grads_split(qf, dof, lse, delta, k_j, v_j, kpos, qpos, sk, kv_len,
                      causal, window, scale, ops, split_kv):
    kops = ops(k_j) if split_kv else [k_j]
    vops = ops(v_j) if split_kv else [v_j]
    mask = _mask(qpos, kpos, kv_len, causal, window)
    s = _split_sum("bhgqd,bhkd->bhgqk", [qf], kops) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dead = (lse <= DEAD_LSE)[..., None]
    mean = (kpos < sk).to(p.dtype) / max(sk, 1)
    p = torch.where(dead, mean.expand_as(p), p)
    dp = _split_sum("bhgqd,bhkd->bhgqk", [dof], vops)
    ds = torch.where(mask & ~dead, p * (dp - delta[..., None]) * scale,
                     torch.zeros_like(p))
    dv_j = _split_sum("bhgqk,bhgqd->bhkd", ops(p), [dof])
    dk_j = _split_sum("bhgqk,bhgqd->bhkd", ops(ds), [qf])
    dq_j = _split_sum("bhgqk,bhkd->bhgqd", ops(ds), kops)
    return dq_j, dk_j, dv_j


def _bwd_rows(q, out, lse, dout, Hkv):
    """qf, dof (B,Hkv,G,Sq,·) f32, lse and delta = rowsum(dO*O)
    (B,Hkv,G,Sq) f32."""
    B, Hq, Sq, hd = q.shape
    G, hdv = Hq // Hkv, dout.shape[-1]
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    dof = dout.float().reshape(B, Hkv, G, Sq, hdv)
    delta = (dof * out.float().reshape(B, Hkv, G, Sq, hdv)).sum(-1)
    return qf, dof, lse.float().reshape(B, Hkv, G, Sq), delta


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = False, window: int = 0,
                              q_offset: int = 0,
                              scale: Optional[float] = None,
                              kv_len: Optional[int] = None,
                              block_k: int = 512
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Two-pass flash backward (flash_vjp.py:114), blocked by ``block_k``:
    from the forward's inputs, its output and lse (B,Hq,Sq) f32, and dout,
    the gradients (dq, dk, dv) in the inputs' dtypes; dk and dv sum over
    the G query heads of each kv head."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    bk = max(min(block_k, Sk), 1)
    kp, _ = _pad_axis(k, 2, bk)
    vp, _ = _pad_axis(v, 2, bk)
    qf, dof, lsef, delta = _bwd_rows(q, out, lse, dout, Hkv)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(kp.shape[2] // bk):
        rows = slice(j * bk, (j + 1) * bk)
        kpos = j * bk + torch.arange(bk, device=q.device)
        dq_j, dk_j, dv_j = _tile_grads(
            qf, dof, lsef, delta, kp[:, :, rows].float(),
            vp[:, :, rows].float(), kpos, qpos, Sk, kv_len, causal, window,
            scale)
        dq += dq_j
        dks.append(dk_j)
        dvs.append(dv_j)
    dk = torch.cat(dks, 2)[:, :, :Sk] if dks else torch.zeros_like(k.float())
    dv = torch.cat(dvs, 2)[:, :, :Sk] if dvs else torch.zeros_like(v.float())
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_split(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              rounding: str = "split", causal: bool = False,
                              window: int = 0, q_offset: int = 0,
                              scale: Optional[float] = None,
                              kv_len: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``flash_attention_bwd_plain`` with the tc route's operands, in kv
    tiles of 64 keys: P (in dV = P^T dO) and dS (in dK = dS^T Q and
    dQ = dS K) enter as hi + lo ("split") or as bf16 alone ("bf16"); Q, K,
    V and dO are the bf16 inputs."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    bk, ops = BWD_BK, _operands(rounding)
    kp, _ = _pad_axis(k, 2, bk)
    vp, _ = _pad_axis(v, 2, bk)
    qf, dof, lsef, delta = _bwd_rows(q, out, lse, dout, Hkv)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(kp.shape[2] // bk):
        rows = slice(j * bk, (j + 1) * bk)
        kpos = j * bk + torch.arange(bk, device=q.device)
        dq_j, dk_j, dv_j = _tile_grads(
            qf, dof, lsef, delta, kp[:, :, rows].float(),
            vp[:, :, rows].float(), kpos, qpos, Sk, kv_len, causal, window,
            scale, ops=ops)
        dq += dq_j
        dks.append(dk_j)
        dvs.append(dv_j)
    dk = torch.cat(dks, 2)[:, :, :Sk] if dks else torch.zeros_like(k.float())
    dv = torch.cat(dvs, 2)[:, :, :Sk] if dvs else torch.zeros_like(v.float())
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def stream_attention_bwd_plain(q: torch.Tensor, x_kv: torch.Tensor,
                               wk: torch.Tensor, wv: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor,
                               dout: torch.Tensor, *,
                               sin: Optional[torch.Tensor] = None,
                               cos: Optional[torch.Tensor] = None,
                               k_gamma: Optional[torch.Tensor] = None,
                               causal: bool = False, window: int = 0,
                               q_offset: int = 0,
                               scale: Optional[float] = None,
                               norm_eps: float = 1e-6,
                               kv_len: Optional[int] = None,
                               block_k: int = 512):
    """TILE_STREAM backward (flash_vjp.py:267), blocked by ``block_k``: each
    K/V tile is generated again from x_kv, its dK/dV computed as in the
    flash backward, and the generator's vector-Jacobian product (autograd
    of ``_gen_tile``, as ``jax.vjp`` there) gives the tile's dx_kv and its
    share of dW_K, dW_V and dγ.  Returns (dq, dx_kv, dwk, dwv, dγ or
    None) in the inputs' dtypes."""
    B, Hq, Sq, hd = q.shape
    Sk, D = x_kv.shape[1], x_kv.shape[2]
    Hkv = wk.shape[1]
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    bk = max(min(block_k, Sk), 1)
    xp, _ = _pad_axis(x_kv, 1, bk)
    if sin is not None:
        sin, _ = _pad_axis(sin, 0, bk)
        cos, _ = _pad_axis(cos, 0, bk)
    qf, dof, lsef, delta = _bwd_rows(q, out, lse, dout, Hkv)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    wkf = wk.detach().float().requires_grad_()
    wvf = wv.detach().float().requires_grad_()
    gf = (None if k_gamma is None
          else k_gamma.detach().float().requires_grad_())
    dq = torch.zeros_like(qf)
    dwk, dwv = torch.zeros_like(wkf), torch.zeros_like(wvf)
    dg = None if gf is None else torch.zeros_like(gf)
    dxs = []
    for j in range(xp.shape[1] // bk):
        rows = slice(j * bk, (j + 1) * bk)
        x_j = xp[:, rows].detach().float().requires_grad_()
        with torch.enable_grad():
            k_j, v_j = _gen_tile(x_j, wkf, wvf, gf,
                                 None if sin is None else sin[rows],
                                 None if cos is None else cos[rows],
                                 norm_eps)
        kpos = j * bk + torch.arange(bk, device=q.device)
        dq_j, dk_j, dv_j = _tile_grads(
            qf, dof, lsef, delta, k_j.detach(), v_j.detach(), kpos, qpos,
            Sk, kv_len, causal, window, scale)
        dq += dq_j
        inputs = [x_j, wkf, wvf] + ([] if gf is None else [gf])
        grads = torch.autograd.grad((k_j, v_j), inputs, (dk_j, dv_j))
        dxs.append(grads[0])
        dwk += grads[1]
        dwv += grads[2]
        if gf is not None:
            dg += grads[3]
    dx = torch.cat(dxs, 1)[:, :Sk] if dxs else torch.zeros_like(
        x_kv.float())
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dx.to(x_kv.dtype),
            dwk.to(wk.dtype), dwv.to(wv.dtype),
            None if dg is None else dg.to(k_gamma.dtype))


def stream_attention_bwd_split(q: torch.Tensor, x_kv: torch.Tensor,
                               wk: torch.Tensor, wv: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor,
                               dout: torch.Tensor, *, rounding: str = "split",
                               sin: Optional[torch.Tensor] = None,
                               cos: Optional[torch.Tensor] = None,
                               k_gamma: Optional[torch.Tensor] = None,
                               causal: bool = False, window: int = 0,
                               q_offset: int = 0,
                               scale: Optional[float] = None,
                               norm_eps: float = 1e-6,
                               kv_len: Optional[int] = None):
    """``stream_attention_bwd_plain`` with the tc route's operands and its
    order of the dW sums, in kv tiles of 64 keys.  The generated K and V,
    P and dS enter the attention products as hi + lo ("split") or as bf16
    alone ("bf16"), and so do dK before the norm and dV in dx = dK W_K^T +
    dV W_V^T and dW = x^T dK; x and W are the bf16 inputs.  Each tile's
    dW partial goes to the slot of its batch row and tile group
    (``stream_bwd_slots``: tiles g, g + NG, ... in order), and the slots
    are summed in order (``reduce_in_order``), as the kernels do."""
    B, Hq, Sq, hd = q.shape
    Sk, D = x_kv.shape[1], x_kv.shape[2]
    Hkv = wk.shape[1]
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    bk, ops = BWD_BK, _operands(rounding)
    xp, _ = _pad_axis(x_kv, 1, bk)
    if sin is not None:
        sin, _ = _pad_axis(sin, 0, bk)
        cos, _ = _pad_axis(cos, 0, bk)
    qf, dof, lsef, delta = _bwd_rows(q, out, lse, dout, Hkv)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    wkf, wvf = wk.float(), wv.float()
    gf = (None if k_gamma is None
          else k_gamma.detach().float().requires_grad_())
    ntiles = xp.shape[1] // bk
    _, _, _, groups = stream_bwd_slots("tc", B, Sk, Hkv, hd)
    dq = torch.zeros_like(qf)
    dw_slots = torch.zeros((2, B, max(groups, 1), D, Hkv, hd),
                           device=q.device)
    dg = None if gf is None else torch.zeros_like(gf)
    dxs = []
    for j in range(ntiles):
        rows = slice(j * bk, (j + 1) * bk)
        x_j = xp[:, rows].float()
        k_pre = torch.einsum("btd,dhe->bthe", x_j, wkf).requires_grad_()
        v_j = torch.einsum("btd,dhe->bthe", x_j, wvf)
        with torch.enable_grad():
            k_n = _norm_rope(k_pre, gf, None if sin is None else sin[rows],
                             None if cos is None else cos[rows], norm_eps)
        kpos = j * bk + torch.arange(bk, device=q.device)
        dq_j, dk_j, dv_j = _tile_grads(
            qf, dof, lsef, delta, k_n.detach().transpose(1, 2),
            v_j.transpose(1, 2), kpos, qpos, Sk, kv_len, causal, window,
            scale, ops=ops, split_kv=True)
        dq += dq_j
        grads = torch.autograd.grad(
            k_n, [k_pre] + ([] if gf is None else [gf]),
            dk_j.transpose(1, 2))
        if gf is not None:
            dg += grads[1]
        dkp, dvt = grads[0], dv_j.transpose(1, 2)   # (B, bk, Hkv, hd)
        dxs.append(sum(torch.einsum("bthe,dhe->btd", a, wkf)
                       for a in ops(dkp))
                   + sum(torch.einsum("bthe,dhe->btd", a, wvf)
                         for a in ops(dvt)))
        g = j % groups
        dw_slots[0, :, g] += sum(torch.einsum("btd,bthe->bdhe", x_j, a)
                                 for a in ops(dkp))
        dw_slots[1, :, g] += sum(torch.einsum("btd,bthe->bdhe", x_j, a)
                                 for a in ops(dvt))
    dx = torch.cat(dxs, 1)[:, :Sk] if dxs else torch.zeros_like(
        x_kv.float())
    dwk = reduce_in_order(dw_slots[0].reshape(-1, D, Hkv, hd))
    dwv = reduce_in_order(dw_slots[1].reshape(-1, D, Hkv, hd))
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dx.to(x_kv.dtype),
            dwk.to(wk.dtype), dwv.to(wv.dtype),
            None if dg is None else dg.to(k_gamma.dtype))


# The backward kernels' routes (csrc/{flash,stream}_attention_bwd.cu, which
# export their rules as flash_attention_bwd_route, stream_attention_bwd_route
# and stream_attention_bwd_slots): "tc" (wgmma/TMA, bf16) and "simt" (f32,
# and shapes TMA cannot read).
BWD_ROUTES = ("simt", "tc")
BWD_BK = 64               # keys per kv tile of both routes
BWD_MAX_CLUSTER = 8       # tc: most blocks of a cluster
STREAM_BWD_GROUPS = 16    # tc: most tile groups (dW slots per batch row)


#: The flash backward's routes: the two above and "wide" (heads over 128,
#: MLA's latent widths; both dtypes; ``csrc/attention_bwd_wide.cuh``).
FLASH_BWD_ROUTES = BWD_ROUTES + ("wide",)
BWD_WIDE_QK, BWD_WIDE_V = 576, 512   # widest q/k and v heads of "wide"
#: Bytes of P and dS for the query heads the wide route takes at once.
BWD_WIDE_SCRATCH = 512 * 2 ** 20


def flash_bwd_route(dtype: torch.dtype, hd: int, hdv: int) -> str:
    """The flash backward's route for 16-byte aligned tensors: "wide" for
    a head over 128 wide (q/k up to 576, v up to 512), "tc" for bf16 with
    hd and hdv multiples of 8 up to 128 (the widths the forward's tc core
    takes), else "simt"."""
    if max(hd, hdv) > 128:
        return "wide"
    ok = (dtype == torch.bfloat16 and hd % 8 == 0 and hdv % 8 == 0
          and hd <= 128 and hdv <= 128)
    return "tc" if ok else "simt"


def flash_bwd_wide_heads(B: int, Hq: int, Hkv: int, Sq: int, Sk: int) -> int:
    """Query heads of each kv head whose P and dS (4 bytes an element each:
    f32 on the f32 kernels, bf16 hi + lo on the bf16 ones; B·Hkv·Sq rows
    of the keys padded to 64) the wide route holds at once, within
    ``BWD_WIDE_SCRATCH``: it walks the G = Hq / Hkv heads in groups of
    this many, summing dK and dV over the groups in order."""
    per_head = 2 * B * Hkv * max(Sq, 1) * (-(-max(Sk, 1) // BWD_BK) * BWD_BK) * 4
    return max(1, min(Hq // Hkv, BWD_WIDE_SCRATCH // per_head))


#: Most dK/dV blocks a key tile of the wide route's bf16 kernels.
BWD_WIDE_SPLITS = 16


def flash_bwd_wide_splits(gc: int) -> int:
    """The dK/dV blocks a key tile of the wide route's bf16 kernels for a
    group of ``gc`` query heads: slice s of ``n`` takes the group's heads
    [s·gc // n, (s + 1)·gc // n) (``dkv_splits`` in
    csrc/attention_bwd_wide_tc.cuh)."""
    return min(gc, BWD_WIDE_SPLITS)


def flash_attention_bwd_wide_split(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, dout: torch.Tensor, *,
                                   causal: bool = False, window: int = 0,
                                   q_offset: int = 0,
                                   scale: Optional[float] = None,
                                   kv_len: Optional[int] = None,
                                   heads: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """``flash_attention_bwd_plain`` in the order of sums and with the
    operands of the wide route's bf16 kernels
    (csrc/attention_bwd_wide_tc.cuh), in kv tiles and query spans of 64:
    the G query heads of each kv head go in groups of ``heads``
    (``flash_bwd_wide_heads`` by default); P and dS enter the dK, dV and dQ
    products as hi + lo; per key tile, dK and dV sum each live span
    (``live_kv_tiles`` of the span holds the tile) apart, add the spans of
    each of ``flash_bwd_wide_splits`` head slices in order, the slices in
    order, then the groups in order; dQ sums each live kv tile apart, then
    adds the tiles in order.  Q, K, V and dO enter as they are."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    gc = flash_bwd_wide_heads(B, Hq, Hkv, Sq, Sk) if heads is None else heads
    bk, ops = BWD_BK, _operands("split")
    kp, _ = _pad_axis(k, 2, bk)
    vp, _ = _pad_axis(v, 2, bk)
    qf, dof, lsef, delta = _bwd_rows(q, out, lse, dout, Hkv)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kt, nq = kp.shape[2] // bk, -(-Sq // bk)
    live = [live_kv_tiles(i * bk, min((i + 1) * bk, Sq), Sq, sk=Sk,
                          kv_len=kv_len, causal=causal, window=window,
                          q_offset=q_offset) for i in range(nq)]
    dq = torch.zeros_like(qf)
    dk = torch.zeros(B, Hkv, kt * bk, hd, device=q.device)
    dv = torch.zeros(B, Hkv, kt * bk, vp.shape[-1], device=q.device)
    for g0 in range(0, G, gc):
        n = min(gc, G - g0)
        splits = flash_bwd_wide_splits(n)
        for j in range(kt):
            keys = slice(j * bk, (j + 1) * bk)
            kpos = j * bk + torch.arange(bk, device=q.device)
            k_j, v_j = kp[:, :, keys].float(), vp[:, :, keys].float()
            mask = _mask(qpos, kpos, kv_len, causal, window)
            hs = slice(g0, g0 + n)
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, hs], k_j) * scale
            lg = lsef[:, :, hs, :, None]
            p = torch.where(mask, torch.exp(sc - lg), torch.zeros_like(sc))
            dead = lg <= DEAD_LSE
            mean = (kpos < Sk).to(p.dtype) / max(Sk, 1)
            p = torch.where(dead, mean.expand_as(p), p)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dof[:, :, hs], v_j)
            ds = torch.where(mask & ~dead,
                             p * (dp - delta[:, :, hs, :, None]) * scale,
                             torch.zeros_like(p))
            p_ops, ds_ops = ops(p), ops(ds)
            spans = [i for i in range(nq) if live[i][0] <= j < live[i][1]]
            dk_j = torch.zeros_like(dk[:, :, keys])
            dv_j = torch.zeros_like(dv[:, :, keys])
            for sp in range(splits):
                part_k, part_v = torch.zeros_like(dk_j), torch.zeros_like(dv_j)
                for gi in range(sp * n // splits, (sp + 1) * n // splits):
                    for i in spans:
                        rows = slice(i * bk, min((i + 1) * bk, Sq))
                        part_k = part_k + sum(torch.einsum(
                            "bhqk,bhqd->bhkd", t[:, :, gi, rows],
                            qf[:, :, g0 + gi, rows]) for t in ds_ops)
                        part_v = part_v + sum(torch.einsum(
                            "bhqk,bhqd->bhkd", t[:, :, gi, rows],
                            dof[:, :, g0 + gi, rows]) for t in p_ops)
                dk_j, dv_j = dk_j + part_k, dv_j + part_v
            dk[:, :, keys] += dk_j
            dv[:, :, keys] += dv_j
            for i in range(nq):
                if live[i][0] <= j < live[i][1]:
                    rows = slice(i * bk, min((i + 1) * bk, Sq))
                    dq[:, :, hs, rows] += sum(torch.einsum(
                        "bhgqk,bhkd->bhgqd", t[:, :, :, rows], k_j)
                        for t in ds_ops)
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk[:, :, :Sk].to(k.dtype),
            dv[:, :, :Sk].to(v.dtype))


def stream_bwd_cluster(Hkv: int, hd: int) -> int:
    """The tc dK/dV kernel's cluster over kv heads: the largest C <= 8
    dividing Hkv with Hkv / C heads a block and (Hkv / C) * HDP <= 128
    (HDP: hd padded to 64 or 128); 0 if none."""
    hdp = 64 if hd <= 64 else 128
    return next((c for c in range(BWD_MAX_CLUSTER, 0, -1)
                 if Hkv % c == 0 and Hkv // c * hdp <= 128), 0)


def stream_bwd_route(dtype: torch.dtype, hd: int, D: int, Hkv: int) -> str:
    """The stream backward's route for 16-byte aligned tensors: "tc" for
    bf16 with hd in (32, 64, 96, 128) (the forward's tc kernel), D a
    multiple of 8 and a cluster over the kv heads, else "simt"."""
    ok = (dtype == torch.bfloat16 and hd in (32, 64, 96, 128) and D % 8 == 0
          and stream_bwd_cluster(Hkv, hd) > 0)
    return "tc" if ok else "simt"


def stream_bwd_slots(route: str, B: int, Sk: int, Hkv: int, hd: int
                     ) -> Tuple[int, int, int, int]:
    """(dW slots, dγ slots, cluster, tile groups) of a route: tc sums each
    block's tiles g, g + NG, ... into its slot (NG = min(tiles, 16) tile
    groups a batch row, a dγ slot per block of the cluster); simt writes a
    slot per kv tile.  Either way the slots are summed in order."""
    tiles = -(-Sk // BWD_BK)
    if route == "tc":
        cluster, groups = stream_bwd_cluster(Hkv, hd), min(tiles,
                                                           STREAM_BWD_GROUPS)
    else:
        cluster, groups = 1, tiles
    return B * groups, B * groups * cluster, cluster, groups


def stream_bwd_scratch_bytes(route: str, B: int, Sk: int, D: int, Hkv: int,
                             hd: int) -> int:
    """Bytes of the f32 dW_K and dW_V slots (each) of a route."""
    return stream_bwd_slots(route, B, Sk, Hkv, hd)[0] * D * Hkv * hd * 4


def reduce_in_order(slots: torch.Tensor) -> torch.Tensor:
    """Σ over the first axis in slot order, ((s_0 + s_1) + s_2) + ..., as
    the kernels' reduce_slots sums their partials."""
    out = slots[0].clone()
    for s in slots[1:]:
        out += s
    return out


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cache_len, *, window: int = 0,
                           scale: Optional[float] = None,
                           block_k: int = 512) -> torch.Tensor:
    """Batched single-query decode attention over cached K/V, the blocked
    mirror of ``jnp_blocked.decode_attention_jnp`` (jnp_blocked.py:97).

    q (B, Hq, 1, hd); k/v (B, Hkv, W, hd); ``cache_len`` () or (B,): the
    valid cache entries of each row (the new token's K/V already written).
    Online softmax over kv blocks, each row masked by its own length (and
    by ``window``: keys at or before cache_len - 1 - window drop out).
    Masked keys carry no weight (p = 0), as in the CUDA kernel, which
    skips the tiles that hold no valid key; a row with no valid key gives
    0, where the reference averages V over the masked keys.  Rows with at
    least one valid key agree with the reference.
    """
    B, Hq, Sq, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = hd ** -0.5 if scale is None else scale
    bk = min(block_k, W)
    k, _ = _pad_axis(k, 2, bk)
    v, _ = _pad_axis(v, 2, bk)
    nkb = k.shape[2] // bk
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(B)
    qf = q.float().reshape(B, Hkv, G, Sq, hd) * scale
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, hd), device=q.device)
    for j in range(nkb):
        k_j = k[:, :, j * bk:(j + 1) * bk].float()
        v_j = v[:, :, j * bk:(j + 1) * bk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_j)
        kpos = j * bk + torch.arange(bk, device=q.device)
        mask = kpos[None, :] < clen[:, None]            # (B, bk)
        if window > 0:
            mask = mask & (kpos[None, :] > clen[:, None] - 1 - window)
        mask = mask[:, None, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, v_j)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).reshape(B, Hq, Sq, hd).to(q.dtype)


# The bf16 decode kernel's geometry (csrc/decode_attention.cu, which
# exports the split rule as decode_attention_splits).
DECODE_ROUTES = ("simt", "tc")
DECODE_BK = 64               # keys per tile
DECODE_SPLIT_BLOCKS = 132    # (kv head, split) blocks a B = 1 call aims at


def decode_splits(W: int, Hkv: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the bf16 decode kernel for a cache of
    width W and Hkv kv heads: enough splits that Hkv x splits fills the
    card at B = 1, whole 64-key tiles each, none empty.  Depends on
    (W, Hkv) only, so a row's sum never depends on B."""
    tiles = -(-W // DECODE_BK)
    S = min(tiles, -(-DECODE_SPLIT_BLOCKS // Hkv))
    per = -(-tiles // S)
    return -(-tiles // per), per


# The GEMM's plain version is its oracle: (M, K) @ (K, N) accumulated in
# f32, cast to x's dtype.
tile_gemm_plain = ref_tile_gemm

# The CUDA GEMM's routes and its splitk geometry (csrc/tile_gemm.cu, which
# exports the rules as tile_gemm_route and tile_gemm_splits).
GEMM_ROUTES = ("simt", "mma", "wgmma", "splitk")
GEMM_M_SMALL = 8          # most rows of the splitk route
GEMM_SLAB = 256           # splitk: N columns per block
GEMM_KT = 64              # splitk: a split's K range is a multiple of this
GEMM_KMAX = 1024          # splitk: most K rows per split
GEMM_SPLIT_BLOCKS = 1024  # splitk: blocks a call aims at


def gemm_route(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The route the CUDA GEMM takes for (M, K) @ (K, N) in ``dtype``:
    "splitk" for M <= GEMM_M_SMALL, else "wgmma" (bf16, K > 0, K and N
    multiples of 8; the wrapper also needs 16-byte aligned x and w),
    "mma" (other bf16) or "simt" (f32)."""
    if M <= GEMM_M_SMALL:
        return "splitk"
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if K > 0 and K % 8 == 0 and N % 8 == 0 else "mma"


def gemm_splits(K: int, N: int) -> int:
    """S, the K splits of the splitk route: enough blocks of GEMM_SLAB
    columns to fill the card, at most GEMM_KMAX rows a split, none empty.
    Depends on (K, N) only, so a row's sum never depends on M."""
    slabs, ktiles = -(-N // GEMM_SLAB), -(-K // GEMM_KT)
    if ktiles <= 1:
        return 1
    S = max(-(-GEMM_SPLIT_BLOCKS // slabs),
            -(-ktiles // (GEMM_KMAX // GEMM_KT)))
    per = -(-ktiles // min(S, ktiles))
    return -(-ktiles // per)


def ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba-2 SSD, the mirror of ``jnp_blocked.ssd_chunked_jnp``
    (jnp_blocked.py:261) and the plain version of the ``ssd_scan`` kernel.
    Shapes as ``ref.ref_ssd``; returns (y in x's dtype, final state
    (B, H, P, N) f32).

    The sequence is zero-padded to a chunk multiple and ``dt`` zeroed past
    S, so that a padded step has decay 1 and no input.  Per chunk, in f32:
    LD = cumsum(dt·a), M = where(t >= s, exp(LD_t - LD_s)·(C·Bᵀ), 0),
    y = M·(dt·x) + exp(LD)·(C·stateᵀ), and the state moves on by
    exp(LD_last)·state + Σ_s exp(LD_last - LD_s)·dt_s·x_s b_sᵀ.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    ch = min(chunk, S)
    x, _ = _pad_axis(x, 1, ch)
    dt, _ = _pad_axis(dt, 1, ch)
    b, _ = _pad_axis(b, 1, ch)
    c, _ = _pad_axis(c, 1, ch)
    nc = x.shape[1] // ch
    xf = x.float().reshape(B, nc, ch, H, P)
    dtf = dt.float().reshape(B, nc, ch, H)
    bf = b.float().reshape(B, nc, ch, N)
    cf = c.float().reshape(B, nc, ch, N)
    af = a.float()
    valid = (torch.arange(nc * ch, device=x.device) < S).reshape(nc, ch)
    dtf = dtf * valid[None, :, :, None]
    tri = (torch.arange(ch, device=x.device)[:, None]
           >= torch.arange(ch, device=x.device)[None, :])
    state = torch.zeros((B, H, P, N), device=x.device)
    ys = []
    for j in range(nc):
        x_c, dt_c, b_c, c_c = xf[:, j], dtf[:, j], bf[:, j], cf[:, j]
        ld = torch.cumsum(dt_c * af[None, None, :], dim=1)     # (B, ch, H)
        gamma = ld[:, :, None, :] - ld[:, None, :, :]          # (B, ch, ch, H)
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)
        m = torch.where(tri[None, :, :, None],
                        torch.exp(gamma) * cb[..., None],
                        torch.zeros((), device=x.device))
        u = x_c * dt_c[..., None]                              # (B, ch, H, P)
        y = (torch.einsum("bijh,bjhp->bihp", m, u)
             + torch.exp(ld)[..., None]
             * torch.einsum("bin,bhpn->bihp", c_c, state))
        ld_last = ld[:, -1]                                    # (B, H)
        w = torch.exp(ld_last[:, None] - ld)[..., None] * u
        state = (torch.exp(ld_last)[..., None, None] * state
                 + torch.einsum("bjhp,bjn->bhpn", w, b_c))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, nc * ch, H, P)[:, :S]
    return y.to(x.dtype), state


SSD_ROUTES = ("simt", "tc")
SSD_CHUNK = 64        # rows per chunk of the bf16 SSD kernel
SSD_BWD_TC_MAX = 128  # widest P and N of the SSD backward's tc route


def ssd_bwd_route(dtype: torch.dtype, P: int, N: int) -> str:
    """The SSD backward's route for 16-byte aligned x, b, c and dy: "tc"
    (tensor cores) for bf16 with P and N multiples of 8 up to
    ``SSD_BWD_TC_MAX``, else "simt" (the f32 SIMT kernels)."""
    ok = (dtype == torch.bfloat16 and P % 8 == 0 and N % 8 == 0
          and 8 <= P <= SSD_BWD_TC_MAX and 8 <= N <= SSD_BWD_TC_MAX)
    return "tc" if ok else "simt"


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                       dstate: Optional[torch.Tensor] = None, *,
                       chunk: int = SSD_CHUNK
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_chunked_plain`` (the counterpart of XLA's
    autodiff of ``jnp_blocked.ssd_chunked_jnp``, jnp_blocked.py:261) with
    respect to x, dt, a, b and c, from dy (B, S, H, P) and d(final state)
    (B, H, P, N) f32 (None: zeros), in the stages of the ``ssd_scan_bwd``
    kernel, each over every chunk at once but the second.  Returns (dx in
    x's dtype, ddt f32, da f32, db in b's dtype, dc in c's dtype).

    Per chunk, with LD = cumsum(dt·a), u = dt·x, dS_out the gradient of
    the state leaving the chunk and S_in the state entering it:

    1. contributions: the chunk's own Σ_s exp(LD_last - LD_s) u_s b_sᵀ
       (forward) and Σ_t exp(LD_t) dy_t c_tᵀ (backward), and its decay
       exp(LD_last);
    2. along the chunks: S_in forward, dS_out in reverse
       (dS_in = exp(LD_last) dS_out + Σ_t exp(LD_t) dy_t c_tᵀ);
    3. per chunk: du_s = Σ_{t≥s} exp(LD_t - LD_s)(c_t·b_s) dy_t
       + exp(LD_last - LD_s) dS_out b_s; dc and db (per head) from
       Q_ts = exp(LD_t - LD_s)(dy_t·u_s) on t ≥ s and the state terms;
       dLD from the exponentials, then ddt and da through the reverse
       cumsum, dx = du·dt and ddt += Σ_p du·x;
    4. db and dc summed over the heads, da over the rows and chunks.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = min(chunk, S)
    x, _ = _pad_axis(x, 1, L)
    dtp, _ = _pad_axis(dt, 1, L)
    bp, _ = _pad_axis(b, 1, L)
    cp, _ = _pad_axis(c, 1, L)
    dyp, _ = _pad_axis(dy, 1, L)
    nc = x.shape[1] // L
    valid = (torch.arange(nc * L, device=x.device) < S).reshape(nc, L)
    xf = x.float().reshape(B, nc, L, H, P)
    dtf = dtp.float().reshape(B, nc, L, H) * valid[None, :, :, None]
    bf = bp.float().reshape(B, nc, L, N)
    cf = cp.float().reshape(B, nc, L, N)
    dyf = dyp.float().reshape(B, nc, L, H, P)
    af = a.float()
    # 1
    ld = torch.cumsum(dtf * af, dim=2)                        # (B, nc, L, H)
    ld_last = ld[:, :, -1]                                    # (B, nc, H)
    el = torch.exp(ld)
    wl = torch.exp(ld_last[:, :, None] - ld)                  # exp(LD_last - LD_s)
    u = xf * dtf[..., None]
    contrib = torch.einsum("bcshp,bcsn->bchpn", wl[..., None] * u, bf)
    dcontrib = torch.einsum("bcthp,bctn->bchpn", el[..., None] * dyf, cf)
    decay = torch.exp(ld_last)
    # 2
    state = torch.zeros((B, H, P, N), device=x.device)
    entering = []
    for j in range(nc):
        entering.append(state)
        state = decay[:, j, :, None, None] * state + contrib[:, j]
    entering = torch.stack(entering, dim=1)                   # (B, nc, H, P, N)
    ds = (torch.zeros((B, H, P, N), device=x.device) if dstate is None
          else dstate.float())
    leaving = [None] * nc
    for j in range(nc - 1, -1, -1):
        leaving[j] = ds
        ds = decay[:, j, :, None, None] * ds + dcontrib[:, j]
    leaving = torch.stack(leaving, dim=1)                     # dS_out
    # 3
    tri = (torch.arange(L, device=x.device)[:, None]
           >= torch.arange(L, device=x.device)[None, :])[..., None]
    e = torch.where(tri, torch.exp(ld[:, :, :, None, :] - ld[:, :, None, :, :]),
                    torch.zeros((), device=x.device))         # (B, nc, t, s, H)
    cb = torch.einsum("bctn,bcsn->bcts", cf, bf)
    q = e * torch.einsum("bcthp,bcshp->bctsh", dyf, u)
    v2 = torch.einsum("bchpn,bcsn->bcshp", leaving, bf)       # dS_out b_s
    du = (torch.einsum("bctsh,bcthp->bcshp", e * cb[..., None], dyf)
          + wl[..., None] * v2)
    dc = (torch.einsum("bctsh,bcsn->bctn", q, bf)
          + torch.einsum("bcth,bchpn,bcthp->bctn", el, entering, dyf))
    db = (torch.einsum("bctsh,bctn->bcsn", q, cf)
          + torch.einsum("bcsh,bchpn,bcshp->bcsn", wl, leaving, u))
    g = q * cb[..., None]
    k = wl * (u * v2).sum(-1)
    dld = (g.sum(3) - g.sum(2) - k
           + el * torch.einsum("bcthp,bchpn,bctn->bcth", dyf, entering, cf))
    last = decay * (leaving * entering).sum((-1, -2)) + k.sum(2)
    dld = torch.cat([dld[:, :, :-1], dld[:, :, -1:] + last[:, :, None]], 2)
    rev = torch.flip(torch.cumsum(torch.flip(dld, [2]), 2), [2])
    ddt = (du * xf).sum(-1) + af * rev
    da = (dtf * rev).sum((0, 1, 2))
    dx = du * dtf[..., None]

    def rows(t):
        return t.reshape(B, nc * L, *t.shape[3:])[:, :S]

    return (rows(dx).to(x.dtype), rows(ddt), da, rows(db).to(b.dtype),
            rows(dc).to(c.dtype))


def ssd_scan_bwd_split(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                       dstate: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """``ssd_scan_bwd_plain`` in the products and operands of the
    backward's tc route (csrc/ssd_scan_bwd_tc.cuh), in chunks of 64: x,
    dy, b and c enter as they are, every f32 operand as its bf16 hi + lo
    pair (``split_bf16``; lo x lo left out).  Per chunk, with E =
    exp(LD_t - LD_s) on t >= s, wl = exp(LD_last - LD_s), el = exp(LD_t):

    1. CB = C Bᵀ, once for all heads;
    2. the contributions (wl·dt·x)ᵀ B and (el·dy)ᵀ C, the chunk decays;
    3. the pass: S_in forward, dS_out in reverse (f32);
    4. Q = E·dt_s·(dY Xᵀ); du = (E·CB)ᵀ dY + wl·(B dS_outᵀ); db = Qᵀ C +
       wl·dt·(X dS_out) and dc = Q B + el·(dY S_in) per head, then summed
       over the heads; y2 = rowsum((dY S_in)·C), k = wl·dt·rowsum(x·v2);
       dLD, ddt, da and dx as the plain version.
    Returns what ``ssd_scan_bwd_plain`` returns."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = SSD_CHUNK
    ops = _operands("split")

    def mm(eq, a_, b_, split_a=False, split_b=False):
        return _split_sum(eq, ops(a_) if split_a else [a_],
                          ops(b_) if split_b else [b_])

    xp, _ = _pad_axis(x, 1, L)
    dtp, _ = _pad_axis(dt, 1, L)
    bp, _ = _pad_axis(b, 1, L)
    cp, _ = _pad_axis(c, 1, L)
    dyp, _ = _pad_axis(dy, 1, L)
    nc = xp.shape[1] // L
    valid = (torch.arange(nc * L, device=x.device) < S).reshape(nc, L)
    xf = xp.float().reshape(B, nc, L, H, P)
    dtf = dtp.float().reshape(B, nc, L, H) * valid[None, :, :, None]
    bf = bp.float().reshape(B, nc, L, N)
    cf = cp.float().reshape(B, nc, L, N)
    dyf = dyp.float().reshape(B, nc, L, H, P)
    af = a.float()
    ld = torch.cumsum(dtf * af, dim=2)                        # (B, nc, L, H)
    el = torch.exp(ld)
    wl = torch.exp(ld[:, :, -1:] - ld)
    decay = torch.exp(ld[:, :, -1])
    cb = torch.einsum("bctn,bcsn->bcts", cf, bf)              # 1
    contrib = mm("bcshp,bcsn->bchpn", (wl * dtf)[..., None] * xf, bf,
                 split_a=True)                                # 2
    dcontrib = mm("bcthp,bctn->bchpn", el[..., None] * dyf, cf, split_a=True)
    state = torch.zeros((B, H, P, N), device=x.device)        # 3
    entering = []
    for j in range(nc):
        entering.append(state)
        state = decay[:, j, :, None, None] * state + contrib[:, j]
    entering = torch.stack(entering, dim=1)
    ds = (torch.zeros((B, H, P, N), device=x.device) if dstate is None
          else dstate.float())
    leaving = [None] * nc
    for j in range(nc - 1, -1, -1):
        leaving[j] = ds
        ds = decay[:, j, :, None, None] * ds + dcontrib[:, j]
    leaving = torch.stack(leaving, dim=1)
    tri = (torch.arange(L, device=x.device)[:, None]
           >= torch.arange(L, device=x.device)[None, :])[..., None]
    e = torch.where(tri, torch.exp(ld[:, :, :, None, :] - ld[:, :, None, :, :]),
                    torch.zeros((), device=x.device))         # (B, nc, t, s, H)
    q = e * dtf[:, :, None] * torch.einsum("bcthp,bcshp->bctsh", dyf, xf)
    v2 = mm("bcsn,bchpn->bcshp", bf, leaving, split_b=True)   # dS_out b_s
    du = (mm("bctsh,bcthp->bcshp", e * cb[..., None], dyf, split_a=True)
          + wl[..., None] * v2)
    db = (mm("bctsh,bctn->bcsn", q, cf, split_a=True)
          + torch.einsum("bcsh,bcshn->bcsn", wl * dtf,
                         mm("bcshp,bchpn->bcshn", xf, leaving, split_b=True)))
    dys_in = mm("bcthp,bchpn->bcthn", dyf, entering, split_b=True)
    dc = (mm("bctsh,bcsn->bctn", q, bf, split_a=True)
          + torch.einsum("bcth,bcthn->bctn", el, dys_in))
    g = q * cb[..., None]
    k = wl * dtf * (xf * v2).sum(-1)
    dld = (g.sum(3) - g.sum(2) - k
           + el * torch.einsum("bcthn,bctn->bcth", dys_in, cf))
    last = decay * (leaving * entering).sum((-1, -2)) + k.sum(2)
    dld = torch.cat([dld[:, :, :-1], dld[:, :, -1:] + last[:, :, None]], 2)
    rev = torch.flip(torch.cumsum(torch.flip(dld, [2]), 2), [2])
    ddt = (du * xf).sum(-1) + af * rev
    da = (dtf * rev).sum((0, 1, 2))
    dx = du * dtf[..., None]

    def rows(t):
        return t.reshape(B, nc * L, *t.shape[3:])[:, :S]

    return (rows(dx).to(x.dtype), rows(ddt), da, rows(db).to(b.dtype),
            rows(dc).to(c.dtype))


def ssd_four_stage_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, *,
                         chunk: int = SSD_CHUNK
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD in the four stages of the bf16 ``ssd_scan`` kernel
    (arXiv:2405.21060, section 6), each over every chunk at once but the
    third.  Shapes and results as ``ssd_chunked_plain``.

    1. per (row, chunk): CB = C Bᵀ, once for all heads;
    2. per (row, chunk, head): LD = cumsum(dt·a), the chunk's decay
       exp(LD_last) and its own contribution to the state,
       Σ_s exp(LD_last - LD_s)·dt_s·x_s b_sᵀ (P x N);
    3. per (row, head), along the chunks: the state entering chunk c,
       state_c = exp(LD_last,c-1)·state_c-1 + contribution_c-1, and the
       final state;
    4. per (row, chunk, head): y = (tril ⊙ exp(LD_t - LD_s) ⊙ CB)·(dt·x)
       + exp(LD_t)·C·state_cᵀ.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = min(chunk, S)
    x, _ = _pad_axis(x, 1, L)
    dt, _ = _pad_axis(dt, 1, L)
    b, _ = _pad_axis(b, 1, L)
    c, _ = _pad_axis(c, 1, L)
    nc = x.shape[1] // L
    valid = (torch.arange(nc * L, device=x.device) < S).reshape(nc, L)
    xf = x.float().reshape(B, nc, L, H, P)
    dtf = dt.float().reshape(B, nc, L, H) * valid[None, :, :, None]
    bf = b.float().reshape(B, nc, L, N)
    cf = c.float().reshape(B, nc, L, N)
    # 1
    cb = torch.einsum("bctn,bcsn->bcts", cf, bf)
    # 2
    ld = torch.cumsum(dtf * a.float(), dim=2)                 # (B, nc, L, H)
    ld_last = ld[:, :, -1]                                    # (B, nc, H)
    u = xf * dtf[..., None]                                   # (B, nc, L, H, P)
    w = torch.exp(ld_last[:, :, None] - ld)[..., None] * u
    contrib = torch.einsum("bcshp,bcsn->bchpn", w, bf)
    decay = torch.exp(ld_last)
    # 3
    state = torch.zeros((B, H, P, N), device=x.device)
    entering = []
    for j in range(nc):
        entering.append(state)
        state = decay[:, j, :, None, None] * state + contrib[:, j]
    entering = torch.stack(entering, dim=1)                   # (B, nc, H, P, N)
    # 4
    tri = (torch.arange(L, device=x.device)[:, None]
           >= torch.arange(L, device=x.device)[None, :])[..., None]
    gamma = ld[:, :, :, None, :] - ld[:, :, None, :, :]       # (B, nc, t, s, H)
    m = torch.where(tri, torch.exp(gamma) * cb[..., None],
                    torch.zeros((), device=x.device))
    y = (torch.einsum("bctsh,bcshp->bcthp", m, u)
         + torch.exp(ld)[..., None]
         * torch.einsum("bctn,bchpn->bcthp", cf, entering))
    y = y.reshape(B, nc * L, H, P)[:, :S]
    return y.to(x.dtype), state
