"""Public attention/projection/SSD entry points and the paper's three
execution modes (counterpart of ``repro/kernels/ops.py``):

* ``NON_STREAM``   materializes Q, K, V, S and P (``ref.ref_attention``);
* ``LAYER_STREAM`` materializes K/V once, then runs flash attention;
* ``TILE_STREAM``  fuses K/V generation into attention: K/V never reach
  device memory.

The JAX package's ``use_pallas`` switch becomes the device of the tensors:
CUDA tensors go through the CUDA kernels, CPU tensors through their plain
versions.  Padding helpers are not needed here: the kernels mask ragged
edges themselves, and the plain versions pad on their own
(``blocked._pad_axis``).  Eager PyTorch materializes every NON_STREAM
intermediate without an ``optimization_barrier``.

Inside a ``sim.replay.recording()`` block, ``attention_by_plan``,
``decode_attention_by_plan`` and ``batched_decode_attention_by_plan`` time
each call and emit one op-level ``KernelTrace``: its grid and tiles are
those the kernel's library noted at its latest launch
(``_build.launch_hook``), or on the CPU and in NON_STREAM the JAX
package's rule (``_pick_block``); bytes and FLOPs are the JAX package's
formulas (``ops.py:247-269``).

Under autograd (an input that requires grad, grad mode on) the attention
entry points go through the autograd Functions of ``flash_vjp`` (the
forward kernels then also emit lse, and the backward kernels run), and
``projection`` through ``ProjectionFn``; NON_STREAM stays plain PyTorch,
which autograd differentiates.  Without grad they launch exactly what the
serving paths launch.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import runtime
from repro_torch.core.types import ExecutionMode
from repro_torch.kernels import ref
from repro_torch.kernels._build import (launch_hook, needs_grad,
                                       replay_recorder)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_vjp import FlashAttentionFn, StreamAttentionFn
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.stream_attention import stream_attention
from repro_torch.kernels.tile_gemm import tile_gemm
from repro_torch.plan.heuristics import DEFAULT_BLOCK


def _pick_block(seq: int, preferred: int) -> int:
    """The JAX package's Pallas block for ``seq`` (ops.py:63): the largest
    power of two <= ``preferred`` that keeps the padding sane.  Read only
    for the grids of recorded traces."""
    b = preferred
    while b > 128 and seq % b and seq < b:
        b //= 2
    return max(min(b, preferred), 8 if seq < 128 else 128)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False, window: int = 0,
                         q_offset: int = 0,
                         block_k: int = 256) -> torch.Tensor:
    """GQA attention: q (B,Hq,Sq,hd), k/v (B,Hkv,Sk,hd) -> (B,Hq,Sq,hd)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    block_k = runtime.get("block_k", block_k)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      block_k)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, block_k=block_k)


def mla_latent_attention(q_cat: torch.Tensor, k_cat: torch.Tensor,
                         c: torch.Tensor, *, causal: bool = True,
                         block_k: int = 512) -> torch.Tensor:
    """MLA's absorbed-form attention, MQA over the shared latent
    (ops.py:134): q_cat (B, H, Sq, kvr + dr) pre-scaled queries, k_cat
    (B, 1, Sk, kvr + dr), c (B, 1, Sk, kvr) the latent values -> the latent
    context (B, H, Sq, kvr).  Flash attention at the unpadded widths with
    scale dqk^-0.5, dqk = kvr + dr (the Pallas path pads the widths to 128
    and passes the same scale): on CUDA tensors the kernel (bf16 on its
    wide route, 576/512 at deepseek-v3), on CPU tensors its plain version
    blocked by ``block_k``.  Under autograd it goes through
    ``FlashAttentionFn``, whose default scale is the same and whose
    backward takes the flash backward's wide route at these widths."""
    q_cat, k_cat, c = q_cat.contiguous(), k_cat.contiguous(), c.contiguous()
    block_k = runtime.get("block_k", block_k)
    if needs_grad(q_cat, k_cat, c):
        return FlashAttentionFn.apply(q_cat, k_cat, c, causal, 0, 0, block_k)
    return flash_attention(q_cat, k_cat, c, causal=causal,
                           scale=q_cat.shape[-1] ** -0.5, block_k=block_k)


def streaming_attention(q: torch.Tensor, x_kv: torch.Tensor,
                        wk: torch.Tensor, wv: torch.Tensor, *,
                        sin: Optional[torch.Tensor] = None,
                        cos: Optional[torch.Tensor] = None,
                        k_gamma: Optional[torch.Tensor] = None,
                        causal: bool = False, window: int = 0,
                        q_offset: int = 0, norm_eps: float = 1e-6,
                        block_k: int = 256) -> torch.Tensor:
    """TILE_STREAM fused K/V generation + attention (stream_attention.py)."""
    q, x_kv = q.contiguous(), x_kv.contiguous()
    wk, wv = wk.to(q.dtype).contiguous(), wv.to(q.dtype).contiguous()
    block_k = runtime.get("block_k", block_k)
    if needs_grad(q, x_kv, wk, wv, k_gamma):
        return StreamAttentionFn.apply(q, x_kv, wk, wv, k_gamma, sin, cos,
                                       causal, window, q_offset, norm_eps,
                                       block_k)
    return stream_attention(
        q, x_kv, wk, wv, sin=sin, cos=cos, k_gamma=k_gamma, causal=causal,
        window=window, q_offset=q_offset, norm_eps=norm_eps,
        block_k=block_k)


class ProjectionFn(torch.autograd.Function):
    """x (M, K) @ w (K, N) through ``tile_gemm``.  The backward products
    dX = dY W^T and dW = X^T dY are ``torch.matmul``: the JAX training path
    computes them as XLA dots outside any Pallas kernel (its loss runs with
    ``use_pallas=False``, train/loop.py:36)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return tile_gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ dy if ctx.needs_input_grad[1] else None
        return dx, dw


def projection(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) with f32 accumulation, output in x's dtype."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2, w2 = x.reshape(-1, K).contiguous(), w.to(x.dtype).contiguous()
    out = (ProjectionFn.apply(x2, w2) if needs_grad(x2, w2)
           else tile_gemm(x2, w2))
    return out.reshape(*lead, w.shape[1])


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan -> (y, final state) (ops.py:190): the ``ssd_scan``
    kernel on CUDA tensors, its plain version, chunked by ``chunk``, on CPU
    tensors; under autograd through ``SSDScanFn``, whose backward is the
    ``ssd_scan_bwd`` kernel (the JAX training path differentiates
    ``ssd_chunked_jnp``).  Nothing is padded here: the kernels mask the
    ragged last chunk, the plain versions pad themselves."""
    return ssd_scan(x.contiguous(), dt.contiguous(), a.contiguous(),
                    b.contiguous(), c.contiguous(), chunk=chunk)


def attention_by_plan(layer_plan, q: torch.Tensor, x_kv: torch.Tensor,
                      wk: torch.Tensor, wv: torch.Tensor, *,
                      sin: Optional[torch.Tensor] = None,
                      cos: Optional[torch.Tensor] = None,
                      k_gamma: Optional[torch.Tensor] = None,
                      causal: bool = False, window: int = 0,
                      q_offset: int = 0, norm_eps: float = 1e-6,
                      kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """Run one attention layer as a plan says: any object with ``.mode``,
    ``.block_q`` and ``.block_kv`` (the JAX package's ``LayerPlan`` works).
    ``mode`` picks the dispatch; ``block_kv`` blocks the plain versions (the
    CUDA kernels fix their own tiles, so ``block_q`` is not read).

    ``kv``: an already materialized (K, V) pair, which the NON/LAYER
    branches consume instead of projecting ``x_kv``; TILE_STREAM ignores it.
    """
    mode = ExecutionMode(getattr(layer_plan.mode, "value", layer_plan.mode))
    call = functools.partial(
        _attention_dispatch, mode, q, x_kv, wk, wv, sin=sin, cos=cos,
        k_gamma=k_gamma, causal=causal, window=window, q_offset=q_offset,
        norm_eps=norm_eps, block_k=layer_plan.block_kv, kv=kv)
    rec = replay_recorder(q, x_kv, wk, wv)
    if rec is None:
        return call()
    from repro_torch.plan.heuristics import attn_hbm_bytes
    B, Hq, Sq, hd = q.shape
    Skv, d_kv = x_kv.shape[1], x_kv.shape[2]
    Hkv = wk.shape[1]
    bq = _pick_block(Sq, layer_plan.block_q)
    bk = _pick_block(Skv, layer_plan.block_kv)
    nbytes = B * attn_hbm_bytes(Sq, Skv, d_kv, Hq, Hkv, hd, mode,
                                block_q=bq, bytes_per_el=q.element_size())
    # QK^T + PV and the K/V generation (fused or materialized); Q arrives
    # projected, so no Q-projection term.
    flops = B * (4 * Hq * Sq * Skv * hd + 4 * Skv * d_kv * Hkv * hd)
    kernel = {ExecutionMode.TILE_STREAM: stream_attention,
              ExecutionMode.LAYER_STREAM: flash_attention}.get(mode)
    return rec.measure(
        call, op=layer_plan.name, kind="attention", mode=mode.value,
        grid=(B, -(-Sq // bq), -(-Skv // bk)), block_q=bq, block_kv=bk,
        hbm_bytes=nbytes, flops=flops, device=q.device,
        launched=None if kernel is None else launch_hook(kernel))


def attention_by_mode(mode: ExecutionMode, q: torch.Tensor,
                      x_kv: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                      *, sin: Optional[torch.Tensor] = None,
                      cos: Optional[torch.Tensor] = None,
                      k_gamma: Optional[torch.Tensor] = None,
                      causal: bool = False, window: int = 0,
                      q_offset: int = 0,
                      norm_eps: float = 1e-6) -> torch.Tensor:
    """Dispatch one attention layer by bare mode, default blocking."""
    return _attention_dispatch(
        mode, q, x_kv, wk, wv, sin=sin, cos=cos, k_gamma=k_gamma,
        causal=causal, window=window, q_offset=q_offset, norm_eps=norm_eps)


def _attention_dispatch(mode: ExecutionMode, q: torch.Tensor,
                        x_kv: torch.Tensor, wk: torch.Tensor,
                        wv: torch.Tensor, *,
                        sin: Optional[torch.Tensor],
                        cos: Optional[torch.Tensor],
                        k_gamma: Optional[torch.Tensor], causal: bool,
                        window: int, q_offset: int, norm_eps: float,
                        block_k: int = 256,
                        kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> torch.Tensor:
    if mode == ExecutionMode.TILE_STREAM:
        return streaming_attention(
            q, x_kv, wk, wv, sin=sin, cos=cos, k_gamma=k_gamma,
            causal=causal, window=window, q_offset=q_offset,
            norm_eps=norm_eps, block_k=block_k)

    if kv is not None:
        k, v = kv           # the caller materialized them (normed + roped)
    else:
        # Materialize K, V: the rewriting both baselines pay.
        k = torch.einsum("bsd,dhe->bhse", x_kv, wk.to(x_kv.dtype))
        v = torch.einsum("bsd,dhe->bhse", x_kv, wv.to(x_kv.dtype))
        if k_gamma is not None:
            k = ref.rms_norm(k, k_gamma, eps=norm_eps)
        if sin is not None:
            k = ref.apply_rope(k, sin, cos)

    if mode == ExecutionMode.NON_STREAM:
        return ref.ref_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)

    # LAYER_STREAM: flash attention over the materialized K/V.
    return multi_head_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, block_k=block_k)


def decode_attention_by_plan(decode_layer_plan, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor, *,
                             window: int = 0,
                             q_offset: int = 0) -> torch.Tensor:
    """One decode-step attention of one slot under its ``DecodeLayerPlan``
    (ops.py:271): q (B, Hq, 1, hd) against the cached k/v (B, Hkv, S, hd),
    S the slot's attended length, through ``multi_head_attention`` (the
    flash kernel on CUDA tensors) blocked by the plan's ``block_kv``.  The
    serving path decodes through ``batched_decode_attention_by_plan``;
    this entry records per-slot traces, as the JAX one does."""
    call = functools.partial(
        multi_head_attention, q, k, v, causal=False, window=window,
        q_offset=q_offset, block_k=decode_layer_plan.block_kv)
    rec = replay_recorder(q, k, v)
    if rec is None:
        return call()
    from repro_torch.plan.heuristics import decode_attn_hbm_bytes
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    bk = _pick_block(Skv, decode_layer_plan.block_kv)
    mode = ExecutionMode(getattr(decode_layer_plan.mode, "value",
                                 decode_layer_plan.mode))
    nbytes = B * decode_attn_hbm_bytes(
        Skv, Hq, Hkv, hd, mode, append=not decode_layer_plan.cross,
        bytes_per_el=q.element_size())
    return rec.measure(
        call, op=decode_layer_plan.name, kind="decode", mode=mode.value,
        grid=(B, 1, -(-Skv // bk)), block_q=Sq, block_kv=bk,
        hbm_bytes=nbytes, flops=B * 4 * Hq * Sq * Skv * hd,
        device=q.device, launched=launch_hook(flash_attention))


def batched_decode_attention_by_plan(decode_layer_plan, q: torch.Tensor,
                                     k: torch.Tensor, v: torch.Tensor,
                                     cache_len, *,
                                     window: int = 0) -> torch.Tensor:
    """One decode-step attention layer for a bucket of slots at once
    (ops.py:311), the only decode attention entry of the port: q
    (B, Hq, 1, hd), one query row per slot; k/v (B, Hkv, W, hd) the slots'
    caches; ``cache_len`` () or (B,) valid entries per row.  CUDA tensors
    launch the ``decode_attention`` kernel; CPU tensors take its plain
    version, blocked by the plan's ``block_kv`` (``DEFAULT_BLOCK`` without
    a plan; ``runtime.flags(block_k=...)`` overrides both).

    Under a recording, and given a plan, the call emits one op-level
    ``KernelTrace`` of kind "decode" whose bytes and FLOPs are summed over
    the plan's per-slot ``seq_kv``, which must have one entry per row, as
    in JAX (ops.py:343-362)."""
    block = (DEFAULT_BLOCK if decode_layer_plan is None
             else decode_layer_plan.block_kv)
    call = functools.partial(
        decode_attention, q.contiguous(), k.contiguous(), v.contiguous(),
        cache_len, window=window, block_k=runtime.get("block_k", block))
    rec = (None if decode_layer_plan is None
           else replay_recorder(q, k, v))
    if rec is None:
        return call()
    from repro_torch.plan.heuristics import decode_attn_hbm_bytes
    B, Hq, Sq, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    bk = _pick_block(W, decode_layer_plan.block_kv)
    seq_kv = decode_layer_plan.seq_kv
    if len(seq_kv) != B:
        raise ValueError(
            f"bucket batch {B} != plan slots {len(seq_kv)} for "
            f"{decode_layer_plan.name}")
    mode = ExecutionMode(getattr(decode_layer_plan.mode, "value",
                                 decode_layer_plan.mode))
    nbytes = sum(decode_attn_hbm_bytes(
        kv, Hq, Hkv, hd, mode, append=not decode_layer_plan.cross,
        bytes_per_el=q.element_size()) for kv in seq_kv)
    return rec.measure(
        call, op=decode_layer_plan.name, kind="decode", mode=mode.value,
        grid=(B, 1, -(-W // bk)), block_q=Sq, block_kv=bk,
        hbm_bytes=nbytes, flops=sum(4 * Hq * Sq * kv * hd for kv in seq_kv),
        device=q.device, launched=launch_hook(decode_attention))
