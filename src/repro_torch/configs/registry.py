"""Model registry of the port: the architectures ported so far."""
from __future__ import annotations

from repro_torch.configs import vilbert_base
from repro_torch.core.types import ModelConfig

_MODULES = {"vilbert-base": vilbert_base}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """The published configuration of ``name``, or its small ``SMOKE``
    variant for CPU tests."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
