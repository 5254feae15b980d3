"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under the checkout's ``build/``
directory (git-ignored) and loaded with ``ctypes``.  The library's file name
carries a hash of its sources, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built when this module is imported:
the first launch of a kernel builds it, or ``build_all`` builds them all at
once, one ``nvcc`` per source, in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("tile_gemm", "flash_attention", "stream_attention",
           "decode_attention", "ssd_scan", "flash_attention_bwd",
           "stream_attention_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cu*")):     # .cu and shared .cuh headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process, temporary output, library, log file) or None."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    cmd = [_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = open(lib.with_suffix(".log"), "w")
    proc = subprocess.Popen(cmd + ["-o", str(tmp), str(CSRC / f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, lib, log


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build every named kernel, all compilers running at once; returns the
    wall seconds taken."""
    t0 = time.perf_counter()
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    try:
        for proc, tmp, lib, log in jobs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                raise RuntimeError(f"nvcc failed for {lib.name} (rc {rc}):\n"
                                   + lib.with_suffix(".log").read_text())
            os.replace(tmp, lib)   # atomic: a concurrent builder sees all or none
    finally:
        for proc, _, _, log in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) of the last
    build of ``name``, or '' if it has not been built."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


# ---- helpers of the Python wrappers ----

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(kernel: str, **tensors: torch.Tensor) -> int:
    """Check that the tensors the kernel reads lie on one CUDA device, are
    contiguous and share a dtype it takes; returns that dtype's code."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} on {t.device}, expected the "
                             f"CUDA device of the other inputs")
        if t.dtype != first.dtype or t.dtype not in DTYPE_CODES:
            raise TypeError(f"{kernel}: {name} is {t.dtype}; the kernel takes "
                            f"one dtype of {list(DTYPE_CODES)} for all inputs")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return DTYPE_CODES[first.dtype]


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the kernels' launch
    argument."""
    return torch.cuda.current_stream(device).cuda_stream


def needs_grad(*tensors) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, item: str, *tensors) -> None:
    """Raise if autograd would need a gradient through ``kernel``, which has
    no backward yet: its result would be silently detached."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel}: no backward is ported yet (ROADMAP Queue 1 "
            f"item {item}); call it under torch.no_grad()")


def raise_on(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {rc}")


def replay_recorder(*tensors):
    """The active ``sim.replay`` recorder for this kernel call, or None,
    also when the replay module was never imported (looked up in
    ``sys.modules``, so the common path costs one dict lookup; JAX
    ``kernels/ops.py:43``)."""
    replay = sys.modules.get("repro_torch.sim.replay")
    if replay is None:
        return None
    return replay.recorder_for(*tensors)


Geometry = Tuple[Tuple[int, int, int], int, int]


def last_launch(name: str) -> Tuple[int, Geometry]:
    """(route code, (grid, tile rows, tile columns)) of the latest launch of
    library ``name``, as its host code noted it where it launched
    (``csrc/launch_record.cuh``, read through ``<name>_last_launch``)."""
    fn = getattr(load(name), f"{name}_last_launch")
    r = (ctypes.c_int * 6)()
    fn(r)
    return r[0], ((r[1], r[2], r[3]), r[4], r[5])


def launch_hook(kernel) -> Callable[[], Optional[Geometry]]:
    """A ``KernelRecorder.measure`` hook for calls of the wrapper ``kernel``
    (named after its library, counting its launches in ``.launches``):
    after the timed calls it returns the geometry of the latest launch the
    library made, or None where the calls launched nothing (CPU tensors
    take the plain versions).  The library is read only then, so only
    recorded calls pay for it."""
    before = kernel.launches

    def geometry() -> Optional[Geometry]:
        if kernel.launches == before:
            return None
        return last_launch(kernel.__name__)[1]
    return geometry
