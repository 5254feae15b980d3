"""Fused K/V generation + attention, the TILE_STREAM path and the paper's
core (counterpart of ``repro/kernels/stream_attention.py``).

CUDA kernel: ``csrc/stream_attention.cu``; K and V exist only in its shared
memory.  Plain version: ``blocked.stream_attention_plain``.

Inside a ``sim.replay`` recording a launch on the card is timed and
recorded as a kernel-level ``KernelTrace`` (JAX
``stream_attention.py:191-196``) with the grid and tile the library notes
where it launches (``_build.launch_hook``); the plain version, like the
JAX package's jnp path, records nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import stream_attention_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_HEAD_DIM = 128


def _lib():
    fn = _build.load("stream_attention").stream_attention_launch
    fn.argtypes = [_P] * 8 + [_I] * 8 + [_F] + [_I] * 6 + [_F, _P, _P]
    fn.restype = _I
    return fn


def config(G: int, Sq: int) -> Tuple[int, int, int]:
    """(query rows per block, cluster size, clusters of the largest size
    resident at once) of the bf16 tensor-core kernel for the G*Sq
    flattened query rows of a kv head, read from its library (built on
    first use)."""
    fn = _build.load("stream_attention").stream_attention_config
    fn.argtypes, fn.restype = [_I] + [ctypes.POINTER(_I)] * 3, _I
    rows, cluster, resident = _I(), _I(), _I()
    fn(G * Sq, ctypes.byref(rows), ctypes.byref(cluster),
       ctypes.byref(resident))
    return rows.value, cluster.value, resident.value


def regeneration(G: int, Sq: int) -> int:
    """How many times the bf16 kernel generates each K/V tile of a kv head:
    once per cluster of consecutive blocks over the G*Sq query rows."""
    rows, cluster, _ = config(G, Sq)
    row_tiles = -(-G * Sq // rows)
    return -(-row_tiles // cluster)


def stream_attention(q: torch.Tensor, x_kv: torch.Tensor, wk: torch.Tensor,
                     wv: torch.Tensor, *,
                     sin: Optional[torch.Tensor] = None,
                     cos: Optional[torch.Tensor] = None,
                     k_gamma: Optional[torch.Tensor] = None,
                     causal: bool = False, window: int = 0,
                     q_offset: int = 0, scale: Optional[float] = None,
                     norm_eps: float = 1e-6, kv_len: Optional[int] = None,
                     block_k: int = 256, return_lse: bool = False):
    """q (B, Hq, Sq, hd) pre-projected; x_kv (B, Sk, D); wk/wv (D, Hkv, hd);
    sin/cos (Sk, hd//2) RoPE tables for the keys or None; k_gamma (hd,)
    qk-norm gain of K or None -> (B, Hq, Sq, hd) in q's dtype.  With
    ``return_lse`` also each query row's m + log l (B, Hq, Sq) f32, the
    residual of the backward (``flash_vjp``).

    CPU tensors take the plain version, blocked by ``block_k``; CUDA tensors
    launch the kernel, whose kv tile is fixed at 64 keys."""
    if q.device.type == "cpu":
        return stream_attention_plain(
            q, x_kv, wk, wv, sin=sin, cos=cos, k_gamma=k_gamma,
            causal=causal, window=window, q_offset=q_offset, scale=scale,
            norm_eps=norm_eps, kv_len=kv_len, block_k=block_k,
            return_lse=return_lse)
    code = _build.check_cuda("stream_attention", q=q, x_kv=x_kv, wk=wk,
                             wv=wv)
    B, Hq, Sq, hd = q.shape
    Sk, D = x_kv.shape[1], x_kv.shape[2]
    Hkv = wk.shape[1]
    if (x_kv.shape[0] != B or wk.shape != (D, Hkv, hd)
            or wv.shape != (D, Hkv, hd) or Hq % Hkv):
        raise ValueError(
            f"stream_attention: shapes q {tuple(q.shape)}, x_kv "
            f"{tuple(x_kv.shape)}, wk {tuple(wk.shape)}, wv "
            f"{tuple(wv.shape)} do not match")
    if hd > MAX_HEAD_DIM or hd % 2:
        raise ValueError(f"stream_attention: head width {hd} must be even "
                         f"and at most {MAX_HEAD_DIM}")
    if (sin is None) != (cos is None):
        raise ValueError("stream_attention: pass both sin and cos, or neither")
    if sin is not None:
        sin, cos = sin.float().contiguous(), cos.float().contiguous()
        if sin.shape != (Sk, hd // 2) or cos.shape != (Sk, hd // 2):
            raise ValueError(f"stream_attention: sin/cos must be "
                             f"{(Sk, hd // 2)}, got {tuple(sin.shape)}")
    if k_gamma is not None:
        k_gamma = k_gamma.float().contiguous()
        if k_gamma.shape != (hd,):
            raise ValueError(f"stream_attention: k_gamma must be ({hd},)")
    for side in (sin, cos, k_gamma):
        if side is not None and side.device != q.device:
            raise ValueError(f"stream_attention: sin/cos/k_gamma on "
                             f"{side.device}, expected {q.device}")
    kv_len = Sk if kv_len is None else kv_len
    if not 0 <= kv_len <= Sk:
        raise ValueError(f"stream_attention: kv_len {kv_len} outside "
                         f"[0, {Sk}]")
    scale = hd ** -0.5 if scale is None else scale

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if not out.numel():
        return (out, lse) if return_lse else out
    args = (q.data_ptr(), x_kv.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            ptr(sin), ptr(cos), ptr(k_gamma), out.data_ptr(), code,
            B, Hq, Hkv, Sq, Sk, D, hd, scale, int(causal), window, q_offset,
            kv_len, int(sin is not None), int(k_gamma is not None),
            norm_eps, ptr(lse), _build.stream_ptr(q.device))
    rec = _build.replay_recorder(q, x_kv, wk, wv)
    if rec is None:
        _launch(args)
    else:
        # JAX's byte count: q in and out once, x_kv streamed once per
        # block of min(256, Sq) query rows, the weights once.
        nqb = -(-Sq // min(256, Sq))
        rec.measure(
            functools.partial(_launch, args),
            op=rec.current_label("stream_attention"), kind="attention",
            mode="tile_stream",
            hbm_bytes=(2 * q.numel() + nqb * x_kv.numel() + wk.numel()
                       + wv.numel()) * q.element_size(),
            flops=B * (4 * Hq * Sq * Sk * hd + 4 * Sk * D * Hkv * hd),
            device=q.device, launched=_build.launch_hook(stream_attention))
    return (out, lse) if return_lse else out


def _launch(args: tuple) -> None:
    _build.raise_on("stream_attention", _lib()(*args))
    stream_attention.launches += 1


stream_attention.launches = 0
