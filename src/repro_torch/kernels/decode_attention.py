"""Batched single-query decode attention over cached K/V (counterpart of
``repro/kernels/decode_attention.py``).

One serving step advances a bucket of equal-shape slots at once: q holds
one query row per slot, K/V are the slots' cache buffers gathered from
the paged pool, and ``cache_len`` the valid entries of each row.

CUDA kernel: ``csrc/decode_attention.cu``.  Plain version:
``blocked.decode_attention_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import decode_attention_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_HEAD_DIM = 128
MAX_GROUP = 64        # query heads per kv head that the shared memory holds


def _lib():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_F, _I, _P]
    fn.restype = _I
    return fn


def _splits(W: int) -> int:
    fn = _build.load("decode_attention").decode_attention_splits
    fn.argtypes, fn.restype = [_I], _I
    return fn(W)


def _row_lengths(cache_len: Union[int, torch.Tensor], B: int,
                 device: torch.device) -> torch.Tensor:
    """``cache_len`` (an int, a () or a (B,) tensor) as a contiguous (B,)
    int32 tensor on ``device``."""
    if isinstance(cache_len, torch.Tensor):
        if cache_len.device != device:
            raise ValueError(f"decode_attention: cache_len on "
                             f"{cache_len.device}, expected {device}")
        if cache_len.dim() > 1 or cache_len.numel() not in (1, B):
            raise ValueError(f"decode_attention: cache_len must be () or "
                             f"({B},), got {tuple(cache_len.shape)}")
        return cache_len.to(torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(cache_len), dtype=torch.int32, device=device)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], *,
                     window: int = 0, scale: Optional[float] = None,
                     block_k: int = 256) -> torch.Tensor:
    """q (B, Hq, 1, hd), k/v (B, Hkv, W, hd), ``cache_len`` () or (B,)
    valid entries per row -> (B, Hq, 1, hd) in q's dtype.

    CPU tensors take the plain version, blocked by ``block_k``; CUDA tensors
    launch the kernel (64-key tiles, W split in 256-key chunks), whose
    rows are bitwise independent of B."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cache_len, window=window,
                                      scale=scale, block_k=block_k)
    code = _build.check_cuda("decode_attention", q=q, k=k, v=v)
    B, Hq, Sq, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    if Sq != 1:
        raise ValueError(f"decode_attention is single-query (Sq == 1), got "
                         f"q shape {tuple(q.shape)}")
    if (k.shape != (B, Hkv, W, hd) or v.shape != k.shape or Hq % Hkv
            or W < 1):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"decode_attention: head width {hd} must be a "
                         f"multiple of 8 and at most {MAX_HEAD_DIM}")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {Hq // Hkv} query heads per kv "
                         f"head, at most {MAX_GROUP}")
    clen = _row_lengths(cache_len, B, q.device)
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    nsplit = _splits(W)
    part = torch.empty((B * Hq * nsplit * (2 + hd),) if nsplit > 1 else (1,),
                       dtype=torch.float32, device=q.device)
    if out.numel():
        _build.raise_on("decode_attention", _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), clen.data_ptr(),
            out.data_ptr(), part.data_ptr(), code, B, Hq, Hkv, W, hd, scale,
            window, _build.stream_ptr(q.device)))
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
