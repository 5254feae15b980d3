"""Memory-efficient attention backward as autograd Functions (counterpart
of ``repro/kernels/flash_vjp.py``).

The forward saves only its inputs, its output and lse = m + log l per
query row (f32, (B, Hq, Sq)); the backward generates each K/V tile again,
recomputes the probabilities from lse and accumulates the gradients.  It
never holds the probabilities; the stream backward never holds K, V or
their gradients for the sequence, and its f32 partials of dW_K and dW_V
take at most 16 slots a batch row on the tc route (one a kv tile on
simt; see ``stream_attention_bwd``):

* ``FlashAttentionFn``: q, k, v -> out, LAYER_STREAM's flash attention;
  dk and dv sum over the G query heads of each kv head (GQA).
* ``StreamAttentionFn``: q, x_kv, wk, wv, k_gamma -> out, TILE_STREAM; its
  backward regenerates each K/V tile from x_kv (projection, qk-norm,
  RoPE) and gives dq, dx_kv, dW_K, dW_V and dγ, so the cross-forwarding
  dataflow carries into the gradient.  sin/cos are constants.

CUDA tensors launch the backward kernels ``csrc/flash_attention_bwd.cu``
and ``csrc/stream_attention_bwd.cu``, each with two routes: ``tc`` (bf16,
wgmma/TMA, ``csrc/attention_bwd_tc.cuh``; the rule
``blocked.flash_bwd_route`` / ``stream_bwd_route`` and 16-byte aligned
tensors) and ``simt`` (every other call: f32 SIMT, the first port's
kernels); the flash backward has a third, ``wide`` (heads over 128, MLA's
576/512 latent widths: bf16 on the wgmma/TMA kernels of
``csrc/attention_bwd_wide_tc.cuh``, widths multiples of 8, P and dS in
scratch as bf16 hi + lo, the dK/dV contraction split over
``blocked.flash_bwd_wide_splits`` blocks a key tile, mirrored by
``blocked.flash_attention_bwd_wide_split``; f32 on the SIMT kernels of
``csrc/attention_bwd_wide.cuh``);
``.routes`` counts the launches of each.  CPU tensors take the
plain versions ``blocked.flash_attention_bwd_plain`` and
``blocked.stream_attention_bwd_plain``.

A row with no live key: the forward gives it the mean of V over the Sk
keys (``ref_attention``'s result), and its gradient here is that of its
own forward (dV gets dO / Sk; nothing else).  The JAX ``_flash_fwd`` gives
such a row 0 and its backward differs there; the training paths have no
such rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import (BWD_ROUTES, BWD_WIDE_QK, BWD_WIDE_V,
                                         FLASH_BWD_ROUTES,
                                         flash_attention_bwd_plain,
                                         flash_bwd_route,
                                         flash_bwd_wide_heads,
                                         stream_attention_bwd_plain,
                                         stream_bwd_route)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.stream_attention import stream_attention

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    fn.argtypes, fn.restype = argtypes, _I
    return fn


@functools.lru_cache(maxsize=1)
def _flash_lib():
    return _fn("flash_attention_bwd", "flash_attention_bwd_launch",
               [_P] * 11 + [_I] * 9 + [_F] + [_I] * 5 + [_P])


@functools.lru_cache(maxsize=1024)
def wide_scratch_floats(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, hd: int,
                        hdv: int, gc: int) -> int:
    """f32 scratch of the flash backward's wide route, in floats: P and dS
    of ``gc`` query heads of each kv head (and, for more than one group,
    the f32 sums of dK and dV), read from its library."""
    fn = getattr(_build.load("flash_attention_bwd"),
                 "flash_attention_bwd_wide_scratch")
    fn.argtypes, fn.restype = [_I] * 8, ctypes.c_longlong
    return fn(B, Hq, Hkv, Sq, Sk, hd, hdv, gc)


@functools.lru_cache(maxsize=1024)
def wide_splits(gc: int) -> int:
    """The wide route's dK/dV blocks a key tile for a group of ``gc`` query
    heads, read from its library (``blocked.flash_bwd_wide_splits``
    mirrors it)."""
    return _fn("flash_attention_bwd", "flash_attention_bwd_wide_splits",
               [_I])(gc)


@functools.lru_cache(maxsize=1)
def _stream_lib():
    return _fn("stream_attention_bwd", "stream_attention_bwd_launch",
               [_P] * 19 + [_I] * 9 + [_F] + [_I] * 6 + [_F, _P])


@functools.lru_cache(maxsize=1024)
def stream_slots(route: str, B: int, Sk: int, Hkv: int, hd: int
                 ) -> Tuple[int, int, int, int]:
    """The library's (dW slots, dγ slots, cluster, tile groups) of a route
    (``blocked.stream_bwd_slots`` mirrors it)."""
    out = [_I() for _ in range(4)]
    _fn("stream_attention_bwd", "stream_attention_bwd_slots",
        [_I] * 5 + [ctypes.POINTER(_I)] * 4)(
        BWD_ROUTES.index(route), B, Sk, Hkv, hd, *map(ctypes.byref, out))
    return tuple(o.value for o in out)


@functools.lru_cache(maxsize=1024)
def library_route(kernel: str, *shape: int) -> str:
    """The library's route rule for 16-byte aligned tensors: kernel
    "flash" with (dtype code, hd, hdv) or "stream" with (dtype code, hd, D,
    Hkv)."""
    name = f"{kernel}_attention_bwd"
    routes = FLASH_BWD_ROUTES if kernel == "flash" else BWD_ROUTES
    return routes[_fn(name, f"{name}_route", [_I] * len(shape))(*shape)]


def stream_config(G: int, Sq: int) -> Tuple[int, int, int, int]:
    """(query rows per block, cluster size of the dQ kernel for the G*Sq
    flattened query rows of a kv head, and the clusters of 8 blocks at
    hd 128 resident at once of the dQ and of the dK/dV kernel) of the
    stream backward's tc route, read from its library."""
    out = [_I() for _ in range(4)]
    _fn("stream_attention_bwd", "stream_attention_bwd_config",
        [_I] + [ctypes.POINTER(_I)] * 4)(G * Sq, *map(ctypes.byref, out))
    return tuple(o.value for o in out)


def regeneration(G: int, Sq: int) -> int:
    """How many times the tc route's dQ kernel generates each K/V tile of a
    kv head: once per cluster of consecutive blocks over the G*Sq rows
    (the SIMT route: once per 64 query rows of each query head)."""
    rows, cluster, _, _ = stream_config(G, Sq)
    row_tiles = -(-G * Sq // rows)
    return -(-row_tiles // cluster)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_lse(kernel: str, lse: torch.Tensor, q: torch.Tensor) -> None:
    if (lse.dtype != torch.float32 or lse.device != q.device
            or tuple(lse.shape) != tuple(q.shape[:3])
            or not lse.is_contiguous()):
        raise ValueError(f"{kernel}: lse must be contiguous float32 "
                         f"{tuple(q.shape[:3])} on {q.device}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = False,
                        window: int = 0, q_offset: int = 0,
                        scale: Optional[float] = None,
                        kv_len: Optional[int] = None, block_k: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` from its inputs, output, lse and
    dout.  CPU tensors take the plain version, blocked by ``block_k``;
    CUDA tensors launch the kernel (kv tiles of 64 keys) on its route:
    "wide" for heads over 128 (q/k up to 576, v up to 512: MLA's latent
    attention), with scratch for P and dS of ``flash_bwd_wide_heads``
    query heads at a time."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         block_k=block_k, **kw)
    code = _build.check_cuda("flash_attention_bwd", q=q, k=k, v=v, out=out,
                             dout=dout)
    _check_lse("flash_attention_bwd", lse, q)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk, hdv = k.shape[1], k.shape[2], v.shape[3]
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    route = flash_bwd_route(q.dtype, hd, hdv)
    if route == "wide" and (hd > BWD_WIDE_QK or hdv > BWD_WIDE_V):
        raise ValueError(f"flash_attention_bwd: head widths {hd}/{hdv} over "
                         f"the widest the kernels take, {BWD_WIDE_QK}/"
                         f"{BWD_WIDE_V}")
    if route == "tc" and not _aligned(q, k, v, dout):
        route = "simt"
    if route == "wide" and q.dtype == torch.bfloat16:
        if hd % 8 or hdv % 8:
            raise ValueError(f"flash_attention_bwd: the wide route takes bf16 "
                             f"head widths that are multiples of 8, not "
                             f"{hd}/{hdv}")
        # its tensor-core kernels load 16-byte rows
        q, k, v, dout = (t if _aligned(t) else t.clone()
                         for t in (q, k, v, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    gc, scratch = 0, None
    if route == "wide":
        gc = flash_bwd_wide_heads(B, Hq, Hkv, Sq, Sk)
        scratch = torch.empty(wide_scratch_floats(B, Hq, Hkv, Sq, Sk, hd,
                                                  hdv, gc),
                              dtype=torch.float32, device=q.device)
    _build.raise_on(f"flash_attention_bwd ({route} route)", _flash_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        FLASH_BWD_ROUTES.index(route), code, B, Hq, Hkv, Sq, Sk, hd, hdv,
        scale, int(causal), window, q_offset, kv_len, gc,
        _build.stream_ptr(q.device)))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = dict.fromkeys(FLASH_BWD_ROUTES, 0)


def stream_attention_bwd(q: torch.Tensor, x_kv: torch.Tensor,
                         wk: torch.Tensor, wv: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, *,
                         sin: Optional[torch.Tensor] = None,
                         cos: Optional[torch.Tensor] = None,
                         k_gamma: Optional[torch.Tensor] = None,
                         causal: bool = False, window: int = 0,
                         q_offset: int = 0, scale: Optional[float] = None,
                         norm_eps: float = 1e-6,
                         kv_len: Optional[int] = None, block_k: int = 256):
    """(dq, dx_kv, dwk, dwv, dγ or None) of ``stream_attention``.  CPU
    tensors take the plain version, blocked by ``block_k``; CUDA tensors
    launch the kernel on its route, which sums its f32 partials of dW_K,
    dW_V and dγ in a fixed order itself (bitwise reproducible).  Its
    scratch (``blocked.stream_bwd_scratch_bytes``) holds B·NG slots of
    D·Hkv·hd f32 each for dW_K and for dW_V: tc NG = min(ceil(Sk/64), 16),
    134 MB each at vilbert-base's vision self-attention (B = 2, Sk = 4096,
    D = 1024, 8 heads of 128) and 336 MB each at qwen3-32b's widths
    (B = 1, Sk = 4096, D = 5120, 8 kv heads of 128); simt NG = ceil(Sk/64),
    537 MB and 1.34 GB."""
    kw = dict(sin=sin, cos=cos, k_gamma=k_gamma, causal=causal,
              window=window, q_offset=q_offset, scale=scale,
              norm_eps=norm_eps, kv_len=kv_len)
    if q.device.type == "cpu":
        return stream_attention_bwd_plain(q, x_kv, wk, wv, out, lse, dout,
                                          block_k=block_k, **kw)
    code = _build.check_cuda("stream_attention_bwd", q=q, x_kv=x_kv, wk=wk,
                             wv=wv, out=out, dout=dout)
    _check_lse("stream_attention_bwd", lse, q)
    B, Hq, Sq, hd = q.shape
    Sk, D = x_kv.shape[1], x_kv.shape[2]
    Hkv = wk.shape[1]
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    if sin is not None:
        sin, cos = sin.float().contiguous(), cos.float().contiguous()
    gamma = None if k_gamma is None else k_gamma.float().contiguous()
    route = ("tc" if stream_bwd_route(q.dtype, hd, D, Hkv) == "tc"
             and _aligned(q, x_kv, wk, wv, dout) else "simt")
    n_dw, n_dg, _, _ = stream_slots(route, B, Sk, Hkv, hd)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    dx = torch.empty((B, Sk, D), **f32)
    dwk_s, dwv_s = (torch.empty((max(n_dw, 1), D, Hkv, hd), **f32)
                    for _ in range(2))
    dg_s = torch.empty((max(n_dg, 1), hd), **f32)
    dwk, dwv = (torch.empty((D, Hkv, hd), **f32) for _ in range(2))
    dg = torch.empty((hd,), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.raise_on(f"stream_attention_bwd ({route} route)", _stream_lib()(
        q.data_ptr(), x_kv.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        ptr(sin), ptr(cos), ptr(gamma), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dx.data_ptr(),
        dwk_s.data_ptr(), dwv_s.data_ptr(), dg_s.data_ptr(), dwk.data_ptr(),
        dwv.data_ptr(), dg.data_ptr(), BWD_ROUTES.index(route), code, B, Hq,
        Hkv, Sq, Sk, D, hd, scale, int(causal), window, q_offset, kv_len,
        int(sin is not None), int(gamma is not None), norm_eps,
        _build.stream_ptr(q.device)))
    stream_attention_bwd.launches += 1
    stream_attention_bwd.routes[route] += 1
    dgamma = None if gamma is None else dg.to(k_gamma.dtype)
    return (dq, dx.to(x_kv.dtype), dwk.to(wk.dtype), dwv.to(wv.dtype),
            dgamma)


stream_attention_bwd.launches = 0
stream_attention_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """out = flash_attention(q, k, v) with the two-pass backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int,
                block_k: int):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, block_k=block_k,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


class StreamAttentionFn(torch.autograd.Function):
    """out = stream_attention(q, x_kv, wk, wv, k_gamma) with the backward
    that regenerates K/V tiles from x_kv; sin/cos (or None) are constants."""

    @staticmethod
    def forward(ctx, q, x_kv, wk, wv, k_gamma, sin, cos, causal: bool,
                window: int, q_offset: int, norm_eps: float, block_k: int):
        out, lse = stream_attention(
            q, x_kv, wk, wv, sin=sin, cos=cos, k_gamma=k_gamma,
            causal=causal, window=window, q_offset=q_offset,
            norm_eps=norm_eps, block_k=block_k, return_lse=True)
        ctx.save_for_backward(q, x_kv, wk, wv, k_gamma, sin, cos, out, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      norm_eps=norm_eps, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, x_kv, wk, wv, k_gamma, sin, cos, out, lse = ctx.saved_tensors
        dq, dx, dwk, dwv, dg = stream_attention_bwd(
            q, x_kv, wk, wv, out, lse, dout.contiguous(), sin=sin, cos=cos,
            k_gamma=k_gamma, **ctx.kw)
        return (dq, dx, dwk, dwv, dg) + (None,) * 7
