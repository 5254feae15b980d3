"""Tiled matrix product (counterpart of ``repro/kernels/tile_gemm.py``).

CUDA kernel: ``csrc/tile_gemm.cu``.  Plain version: ``blocked.tile_gemm_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import tile_gemm_plain

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("tile_gemm")
    fn = lib.tile_gemm_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def tile_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, f32 accumulation.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which masks ragged M, N and K (nothing needs padding)."""
    if x.device.type == "cpu":
        return tile_gemm_plain(x, w)
    code = _build.check_cuda("tile_gemm", x=x, w=w)
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"tile_gemm: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        _build.raise_on("tile_gemm", _lib()(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), code, M, N, K,
            _build.stream_ptr(x.device)))
        tile_gemm.launches += 1
    return out


tile_gemm.launches = 0
