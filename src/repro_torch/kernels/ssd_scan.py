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

Its gradient (``ssd_scan_bwd``; ``SSDScanFn``, which ``ssd_scan`` takes
under autograd) is the kernel ``csrc/ssd_scan_bwd.cu``, two routes:
``tc`` (bf16 with P and N multiples of 8 up to 128 and 16-byte aligned x,
b, c, dy: ``csrc/ssd_scan_bwd_tc.cuh``, the chunk products on the tensor
cores; the rule ``blocked.ssd_bwd_route``) and ``simt`` (every other call;
the first port's f32 kernels).  Plain version:
``blocked.ssd_scan_bwd_plain``.
The JAX training path differentiates ``jnp_blocked.ssd_chunked_jnp``
through XLA's autodiff; the backward here recomputes the chunk states
from the saved inputs rather than keeping them from the forward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked import (SSD_ROUTES, ssd_bwd_route,
                                         ssd_chunked_plain,
                                         ssd_scan_bwd_plain)

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


def _check(kernel: str, x, dt, a, b, c) -> int:
    """The host-side checks of a launch; returns x's dtype code."""
    code = _build.check_cuda(kernel, x=x, b=b, c=c)
    for name, t in (("dt", dt), ("a", a)):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise TypeError(f"{kernel}: {name} must be a contiguous float32 "
                            f"tensor on {x.device}, got {t.dtype} on "
                            f"{t.device}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if (dt.shape != (B, S, H) or a.shape != (H,) or b.shape != (B, S, N)
            or c.shape != b.shape):
        raise ValueError(f"{kernel}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} do not match")
    return code


@functools.lru_cache(maxsize=1024)
def _scratch_floats(B: int, S: int, H: int, P: int, N: int) -> int:
    return _fn("ssd_scan_scratch", [_I] * 5, ctypes.c_longlong)(B, S, H, P, N)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, b/c (B, S, N) ->
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).

    CPU tensors take the plain version, chunked by ``chunk``; CUDA tensors
    launch the kernel, which masks the ragged last chunk itself.  Where an
    input requires grad under autograd, the call goes through
    ``SSDScanFn``, whose backward is ``ssd_scan_bwd``."""
    if _build.needs_grad(x, dt, a, b, c):
        return SSDScanFn.apply(x, dt, a, b, c, chunk)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, a, b, c, chunk=chunk)
    code = _check("ssd_scan", x, dt, a, b, c)
    B, S, H, P = x.shape
    N = b.shape[-1]
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


@functools.lru_cache(maxsize=1)
def _bwd_lib():
    lib = _build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes, fn.restype = [_P] * 13 + [_I] * 7 + [_P], _I
    return fn


@functools.lru_cache(maxsize=1024)
def bwd_scratch_floats(B: int, S: int, H: int, P: int, N: int) -> int:
    """f32 scratch of ``ssd_scan_bwd`` at (B, S, H, P, N), in floats: the
    chunk states and their gradients (2 B·H·nc·P·N), the per-head partials
    of db and dc (2 B·nc·H·64·N), the decays, da's partials and the tc
    route's C Bᵀ (B·nc·64·64)."""
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_scratch
    fn.argtypes, fn.restype = [_I] * 5, ctypes.c_longlong
    return fn(B, S, H, P, N)


@functools.lru_cache(maxsize=1024)
def bwd_takes(P: int, N: int) -> bool:
    """Whether the backward's simt route takes head width P and state
    width N (its per-chunk tiles fit one block's shared memory)."""
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_takes
    fn.argtypes, fn.restype = [_I] * 2, _I
    return bool(fn(P, N))


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None, *, chunk: int = 128
                 ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, da, db, dc) of ``ssd_scan`` from its inputs, dy (B, S, H,
    P) in x's dtype and d(final state) (B, H, P, N) f32 or None (zeros):
    dx, db, dc in their inputs' dtypes, ddt and da f32.  CPU tensors take
    the plain version, chunked by ``chunk``; CUDA tensors launch the
    kernel on its route (``ssd_bwd_route``; 64-row chunks, the chunk
    states recomputed from the inputs; db and dc summed over the heads, da
    over rows and chunks, in a fixed order: bitwise reproducible)."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, a, b, c, dy, dstate, chunk=chunk)
    code = _check("ssd_scan_bwd", x, dt, a, b, c)
    _build.check_cuda("ssd_scan_bwd", x=x, dy=dy)
    B, S, H, P = x.shape
    N = b.shape[-1]
    if dy.shape != x.shape:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} is not x's "
                         f"{tuple(x.shape)}")
    if dstate is not None and (dstate.shape != (B, H, P, N)
                               or dstate.dtype != torch.float32
                               or dstate.device != x.device
                               or not dstate.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: d(final state) must be contiguous "
                         f"float32 {(B, H, P, N)} on {x.device}")
    route = ssd_bwd_route(x.dtype, P, N)
    if route == "tc" and any(t.data_ptr() % 16 for t in (x, b, c, dy)):
        route = "simt"
    if route == "simt" and not bwd_takes(P, N):
        raise ValueError(f"ssd_scan_bwd: head width {P} and state width {N} "
                         f"do not fit the kernel's shared memory")
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    ddt = torch.empty_like(dt)
    da = torch.empty_like(a)
    scratch = torch.empty(bwd_scratch_floats(B, S, H, P, N),
                          dtype=torch.float32, device=x.device)
    _build.raise_on(f"ssd_scan_bwd ({route} route)", _bwd_lib()(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        scratch.data_ptr(), SSD_ROUTES.index(route), code, B, S, H, P, N,
        _build.stream_ptr(x.device)))
    ssd_scan_bwd.launches += 1
    ssd_scan_bwd.routes[route] += 1
    return dx, ddt, da, db, dc


ssd_scan_bwd.launches = 0
ssd_scan_bwd.routes = dict.fromkeys(SSD_ROUTES, 0)


@functools.lru_cache(maxsize=1024)
def library_bwd_route(code: int, P: int, N: int) -> str:
    """The library's route rule for the SSD backward (dtype code, P, N),
    16-byte aligned tensors: what ``blocked.ssd_bwd_route`` mirrors."""
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_route
    fn.argtypes, fn.restype = [_I] * 3, _I
    return SSD_ROUTES[fn(code, P, N)]


class SSDScanFn(torch.autograd.Function):
    """(y, final state) = ssd_scan(x, dt, a, b, c) with ``ssd_scan_bwd``
    as its backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return ssd_scan(x, dt, a, b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        return ssd_scan_bwd(x, dt, a, b, c, dy, dstate,
                            chunk=ctx.chunk) + (None,)
