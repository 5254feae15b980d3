"""Mamba-2 SSD chunked scan (counterpart of ``repro/kernels/ssd_scan.py``).

Prefill of every SSM mixer goes through it: per head, a (P, N) f32 state
is carried along the sequence, and within a chunk the recurrence is a
masked quadratic product (``ref.ref_ssd`` is the sequential definition).

CUDA kernel: ``csrc/ssd_scan.cu``, two routes, each in 64-row chunks
whatever ``chunk`` says (the function is the same, only the order of the
sums differs): ``tc`` (bf16 with P and N multiples of 8, at most 256, and
16-byte aligned x, b, c: the four stages of ``blocked.ssd_four_stage_plain``
on the tensor cores) and ``simt`` (every other call; the first port's
kernel).  Plain version: ``blocked.ssd_chunked_plain``, chunked as
``chunk`` says.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import SSD_ROUTES, ssd_chunked_plain

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn(name: str, argtypes, restype=_I):
    fn = getattr(_build.load("ssd_scan"), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


@functools.lru_cache(maxsize=1)
def _lib():
    return _fn("ssd_scan_launch", [_P] * 8 + [_I] * 7 + [_P])


@functools.lru_cache(maxsize=1)
def _max_state() -> int:
    return _fn("ssd_scan_max_state", [])()


@functools.lru_cache(maxsize=1)
def tc_width() -> int:
    """The largest P and N of the library's tc route."""
    return _fn("ssd_scan_tc_width", [])()


@functools.lru_cache(maxsize=1024)
def _scratch_floats(B: int, S: int, H: int, P: int, N: int) -> int:
    return _fn("ssd_scan_scratch", [_I] * 5, ctypes.c_longlong)(B, S, H, P, N)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, b/c (B, S, N) ->
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).

    CPU tensors take the plain version, chunked by ``chunk``; CUDA tensors
    launch the kernel, which masks the ragged last chunk itself.  It has no
    backward yet: an input that requires grad under autograd raises."""
    _build.refuse_grad("ssd_scan", "18", x, dt, a, b, c)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, a, b, c, chunk=chunk)
    code = _build.check_cuda("ssd_scan", x=x, b=b, c=c)
    for name, t in (("dt", dt), ("a", a)):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise TypeError(f"ssd_scan: {name} must be a contiguous float32 "
                            f"tensor on {x.device}, got {t.dtype} on "
                            f"{t.device}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if (dt.shape != (B, S, H) or a.shape != (H,) or b.shape != (B, S, N)
            or c.shape != b.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} do not match")
    if not 1 <= N <= _max_state():
        raise ValueError(f"ssd_scan: state width {N} must be in "
                         f"[1, {_max_state()}]")
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    route = ("tc" if code == 1 and P % 8 == 0 and N % 8 == 0
             and max(P, N) <= tc_width()
             and not (x.data_ptr() % 16 or b.data_ptr() % 16
                      or c.data_ptr() % 16) else "simt")
    scratch = (torch.empty(_scratch_floats(B, S, H, P, N),
                           dtype=torch.float32, device=x.device)
               if route == "tc" else None)
    _build.raise_on(f"ssd_scan ({route} route)", _lib()(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        SSD_ROUTES.index(route), code, B, S, H, P, N,
        _build.stream_ptr(x.device)))
    ssd_scan.launches += 1
    ssd_scan.routes[route] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.routes = dict.fromkeys(SSD_ROUTES, 0)
