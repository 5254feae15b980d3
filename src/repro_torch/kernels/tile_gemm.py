"""Matrix product with f32 accumulation (counterpart of
``repro/kernels/tile_gemm.py``).

CUDA kernel: ``csrc/tile_gemm.cu``, four routes picked by shape (the
library's ``tile_gemm_route``; ``blocked.gemm_route`` mirrors it): splitk
(M <= 8, the decode weight stream), wgmma (bf16 prefill), mma (other bf16
shapes, and x or w not 16-byte aligned), simt (other f32 shapes).  Plain
version: ``blocked.tile_gemm_plain``.

Inside a ``sim.replay`` recording a launch on the card is timed and
recorded as a kernel-level ``KernelTrace`` (JAX ``tile_gemm.py:70-74``)
with the grid and tile the library notes where it launches
(``_build.launch_hook``); the plain version records nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import (GEMM_ROUTES, GEMM_SLAB,
                                         tile_gemm_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
# splitk's per-slab tickets, per (device, stream): zero between calls (the
# kernel's last block of a slab resets its own), grown on demand.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _fn(name: str, argtypes):
    fn = getattr(_build.load("tile_gemm"), name)
    fn.argtypes, fn.restype = argtypes, _I
    return fn


def _lib():
    return _fn("tile_gemm_launch", [_P, _P, _P] + [_I] * 5 + [_P] * 3)


@functools.lru_cache(maxsize=4096)
def route_of(M: int, K: int, N: int, code: int) -> str:
    """The library's route for (M, K) @ (K, N), dtype code 0 f32 / 1 bf16
    (before the wrapper's alignment check)."""
    return GEMM_ROUTES[_fn("tile_gemm_route", [_I] * 4)(M, K, N, code)]


@functools.lru_cache(maxsize=4096)
def splits_of(K: int, N: int) -> int:
    """The library's K splits of the splitk route at (K, N)."""
    return _fn("tile_gemm_splits", [_I] * 2)(K, N)


def _tickets(device: torch.device, stream: int, slabs: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < slabs:
        t = torch.zeros(max(slabs, 1024), dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = t
    return t


def tile_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, f32 accumulation.

    CPU tensors take the plain version; CUDA tensors launch the library's
    route for the shape, wgmma falling back to mma when x or w is not
    16-byte aligned.  Every route masks ragged M, N and K: nothing needs
    padding."""
    if x.device.type == "cpu":
        return tile_gemm_plain(x, w)
    code = _build.check_cuda("tile_gemm", x=x, w=w)
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"tile_gemm: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if not (M and N):
        return out
    route = route_of(M, K, N, code)
    if route == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        route = "mma"
    stream = _build.stream_ptr(x.device)
    part = ticket = None
    if route == "splitk":
        S = splits_of(K, N)
        if S > 1:
            part = torch.empty(S * M * N, dtype=torch.float32,
                               device=x.device)
        ticket = _tickets(x.device, stream, -(-N // GEMM_SLAB))
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), code,
            GEMM_ROUTES.index(route), M, N, K,
            None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), stream)
    rec = _build.replay_recorder(x, w)
    if rec is None:
        _launch(route, args)
        return out
    rec.measure(
        functools.partial(_launch, route, args),
        op=rec.current_label("tile_gemm"), kind="gemm",
        hbm_bytes=(M * K + K * N + M * N) * x.element_size(),
        flops=2 * M * K * N, device=x.device,
        launched=_build.launch_hook(tile_gemm))
    return out


def _launch(route: str, args: tuple) -> None:
    _build.raise_on(f"tile_gemm ({route} route)", _lib()(*args))
    tile_gemm.launches += 1
    tile_gemm.routes[route] += 1


tile_gemm.launches = 0
tile_gemm.routes = dict.fromkeys(GEMM_ROUTES, 0)
