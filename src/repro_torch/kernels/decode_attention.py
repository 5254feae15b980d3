"""Batched single-query decode attention over cached K/V (counterpart of
``repro/kernels/decode_attention.py``).

One serving step advances a bucket of equal-shape slots at once: q holds
one query row per slot, K/V are the slots' cache buffers gathered from
the paged pool, and ``cache_len`` the valid entries of each row.

CUDA kernel: ``csrc/decode_attention.cu``, two routes: ``tc`` (bf16, at
most 16 query heads per kv head, 16-byte aligned q, k, v; one launch,
mma.sync, W in ``blocked.decode_splits`` splits merged in split order) and
``simt`` (every other call; the first port's kernel).  Plain version:
``blocked.decode_attention_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import DECODE_ROUTES, decode_attention_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_HEAD_DIM = 128
MAX_GROUP = 64        # query heads per kv head that the simt route holds
# Per (device, stream): the f32 partials and the int32 tickets of the
# kernels, grown on demand.  The tickets are zero between calls (the tc
# route's last block of a (row, kv head) resets its own).
_SCRATCH: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _fn(name: str, argtypes):
    fn = getattr(_build.load("decode_attention"), name)
    fn.argtypes, fn.restype = argtypes, _I
    return fn


@functools.lru_cache(maxsize=1)
def _lib():
    return _fn("decode_attention_launch", [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P])


@functools.lru_cache(maxsize=1024)
def splits_of(W: int, Hkv: int) -> Tuple[int, int]:
    """The library's (splits, tiles per split) of the tc route."""
    return (_fn("decode_attention_splits", [_I, _I])(W, Hkv),
            _fn("decode_attention_split_tiles", [_I, _I])(W, Hkv))


@functools.lru_cache(maxsize=1024)
def _simt_splits(W: int) -> int:
    return _fn("decode_attention_simt_splits", [_I])(W)


@functools.lru_cache(maxsize=1)
def tc_group() -> int:
    """The most query heads per kv head the library's tc route takes."""
    return _fn("decode_attention_tc_group", [])()


def _scratch(device: torch.device, stream: int, floats: int, tickets: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    part, ticket = _SCRATCH.get((device, stream), (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                           device=device)
    if ticket is None or ticket.numel() < tickets:
        ticket = torch.zeros(max(tickets, 1024), dtype=torch.int32,
                             device=device)
    _SCRATCH[(device, stream)] = part, ticket
    return part, ticket


def _row_lengths(cache_len: Union[int, torch.Tensor], B: int,
                 device: torch.device) -> Tuple[Optional[torch.Tensor], int]:
    """``cache_len`` as the kernel takes it: a contiguous (B,) int32 tensor
    on ``device`` (for a () or (B,) tensor), or None and the int."""
    if not isinstance(cache_len, torch.Tensor):
        return None, int(cache_len)
    if cache_len.device != device:
        raise ValueError(f"decode_attention: cache_len on "
                         f"{cache_len.device}, expected {device}")
    if cache_len.dim() > 1 or cache_len.numel() not in (1, B):
        raise ValueError(f"decode_attention: cache_len must be () or "
                         f"({B},), got {tuple(cache_len.shape)}")
    return cache_len.to(torch.int32).reshape(-1).expand(B).contiguous(), 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], *,
                     window: int = 0, scale: Optional[float] = None,
                     block_k: int = 256) -> torch.Tensor:
    """q (B, Hq, 1, hd), k/v (B, Hkv, W, hd), ``cache_len`` () or (B,)
    valid entries per row -> (B, Hq, 1, hd) in q's dtype.

    CPU tensors take the plain version, blocked by ``block_k``; CUDA tensors
    launch the kernel, whose rows are bitwise independent of B.  It has no
    backward: an input that requires grad under autograd raises."""
    _build.refuse_grad("decode_attention", q, k, v)
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
    clen, clen0 = _row_lengths(cache_len, B, q.device)
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if not out.numel():
        return out
    route = ("tc" if code == 1 and Hq // Hkv <= tc_group()
             and not (q.data_ptr() % 16 or k.data_ptr() % 16
                      or v.data_ptr() % 16) else "simt")
    splits = splits_of(W, Hkv)[0] if route == "tc" else _simt_splits(W)
    stream = _build.stream_ptr(q.device)
    part, ticket = _scratch(q.device, stream,
                            B * Hq * splits * (2 + hd) + 8, B * Hkv)
    _build.raise_on(f"decode_attention ({route} route)", _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if clen is None else clen.data_ptr(), out.data_ptr(),
        part.data_ptr(), ticket.data_ptr(), DECODE_ROUTES.index(route), code,
        B, Hq, Hkv, W, hd, scale, window, clen0, stream))
    decode_attention.launches += 1
    decode_attention.routes[route] += 1
    return out


decode_attention.launches = 0
decode_attention.routes = dict.fromkeys(DECODE_ROUTES, 0)
