"""Runtime flags and device choice (counterpart of ``repro/core/runtime.py``).

``flags(block_k=...)`` overrides the kv block of the plain attention
versions, as in the JAX package.  It blocks only those (CPU tensors): the
CUDA kernels fix their kv tile at 64 keys and do not read it.
``quantize_proj=True`` is refused: the
int8 projection path is ROADMAP Queue 1 item 3 and not ported yet.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Optional, Union

import torch

_FLAGS: contextvars.ContextVar[Dict[str, Any]] = contextvars.ContextVar(
    "repro_torch_runtime_flags", default={})


def get(name: str, default: Any = None) -> Any:
    return _FLAGS.get().get(name, default)


@contextlib.contextmanager
def flags(**kwargs: Any):
    if kwargs.get("quantize_proj"):
        raise NotImplementedError(
            "quantize_proj: the int8 projection path is not ported yet "
            "(ROADMAP Queue 1 item 3)")
    cur = dict(_FLAGS.get())
    cur.update(kwargs)
    token = _FLAGS.set(cur)
    try:
        yield
    finally:
        _FLAGS.reset(token)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    There is no silent fallback: with no card and no explicit device this
    raises, so a run that was meant for the GPU never ends up on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    return torch.device("cuda")
