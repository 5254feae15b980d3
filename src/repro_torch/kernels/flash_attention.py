"""Flash attention over materialized K/V, the LAYER_STREAM path
(counterpart of ``repro/kernels/flash_attention.py``).

CUDA kernel: ``csrc/flash_attention.cu``, three routes picked by dtype,
width and alignment (``blocked.flash_route`` mirrors the library's
``tc::dispatch``): ``tc`` (bf16 heads up to 128), ``wide`` (bf16 heads over
128: MLA's, ``csrc/attention_wide.cuh``) and ``simt`` (f32, and bf16
shapes TMA cannot read).  ``flash_attention.routes`` counts launches per
route.  Plain version: ``blocked.flash_attention_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import (FLASH_ROUTES, flash_attention_plain,
                                         flash_route)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: The widest q/k and v heads the kernel takes: MLA's absorbed widths at
#: deepseek-v3 (kv_lora_rank + qk_rope_head_dim = 576, kv_lora_rank = 512),
#: bf16 on its wide route (``csrc/attention_wide.cuh``), f32 on its SIMT
#: route.  bf16 heads up to 128 take the other tensor-core route.
MAX_HEAD_DIM = 576
MAX_V_HEAD_DIM = 512


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P] + [_I] * 8 + [_F] + [_I] * 4 + [_P, _P]
    fn.restype = _I
    return fn


def live_tiles(r0: int, r1: int, Sq: int, *, sk: int, kv_len: int,
               causal: bool = False, window: int = 0,
               q_offset: int = 0) -> Tuple[int, int]:
    """The kv tiles [lo, hi) of 64 keys that the bf16 kernels walk for the
    flattened query rows [r0, r1) of a kv head, read from the library
    (built on first use): the rule ``blocked.live_kv_tiles`` mirrors."""
    fn = _build.load("flash_attention").flash_attention_live_tiles
    fn.argtypes, fn.restype = [_I] * 8 + [ctypes.POINTER(_I)] * 2, _I
    lo, hi = _I(), _I()
    fn(r0, r1, Sq, sk, kv_len, int(causal), window, q_offset,
       ctypes.byref(lo), ctypes.byref(hi))
    return lo.value, hi.value


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    block_k: int = 256, return_lse: bool = False):
    """q (B, Hq, Sq, hd), k (B, Hkv, Sk, hd), v (B, Hkv, Sk, hdv)
    -> (B, Hq, Sq, hdv) in q's dtype.  Keys at or past ``kv_len`` (default
    Sk) are masked.  With ``return_lse`` also each query row's m + log l
    (B, Hq, Sq) f32, the residual of the backward (``flash_vjp``).

    CPU tensors take the plain version, blocked by ``block_k``; CUDA tensors
    launch the kernel, whose kv tile is fixed at 64 keys.  bf16 heads over
    128 wide (up to q/k ``MAX_HEAD_DIM``, v ``MAX_V_HEAD_DIM``) take its
    wide route."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale,
                                     kv_len=kv_len, block_k=block_k,
                                     return_lse=return_lse)
    code = _build.check_cuda("flash_attention", q=q, k=k, v=v)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk, hdv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (B, Hkv, Sk, hd) or v.shape[:3] != (B, Hkv, Sk)
            or Hq % Hkv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hd > MAX_HEAD_DIM or hdv > MAX_V_HEAD_DIM:
        raise ValueError(f"flash_attention: head widths {hd}/{hdv} over "
                         f"{MAX_HEAD_DIM}/{MAX_V_HEAD_DIM}")
    kv_len = Sk if kv_len is None else kv_len
    if not 0 <= kv_len <= Sk:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [0, {Sk}]")
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((B, Hq, Sq, hdv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        route = flash_route(q.dtype, hd, hdv,
                            kv_aligned=not (k.data_ptr() % 16
                                            or v.data_ptr() % 16),
                            q_aligned=not q.data_ptr() % 16)
        _build.raise_on(f"flash_attention ({route} route)", _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
            B, Hq, Hkv, Sq, Sk, hd, hdv, scale, int(causal), window,
            q_offset, kv_len, None if lse is None else lse.data_ptr(),
            _build.stream_ptr(q.device)))
        flash_attention.launches += 1
        flash_attention.routes[route] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(FLASH_ROUTES, 0)
