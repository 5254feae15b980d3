"""Model registry of the port: the architectures ported so far, and the
model module that runs each family (counterpart of
``repro/configs/registry.py``)."""
from __future__ import annotations

from repro_torch.configs import (hymba_1_5b, mamba2_780m, qwen3_32b,
                                 starcoder2_7b, vilbert_base)
from typing import Dict, Tuple

from repro_torch.core.types import Family, ModelConfig, ShapeConfig

_MODULES = {"vilbert-base": vilbert_base, "qwen3-32b": qwen3_32b,
            "starcoder2-7b": starcoder2_7b, "mamba2-780m": mamba2_780m,
            "hymba-1.5b": hymba_1_5b}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """The published configuration of ``name``, or its small ``SMOKE``
    variant for CPU tests."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    mod = _MODULES[name]
    if not smoke and not hasattr(mod, "CONFIG"):
        raise NotImplementedError(f"{name}: only its smoke config is ported")
    return mod.SMOKE if smoke else mod.CONFIG


def model_module(cfg: ModelConfig):
    """The module whose model runs ``cfg``'s family."""
    if cfg.family == Family.CROSSMODAL:
        from repro_torch.models import vilbert
        return vilbert
    if cfg.family in (Family.DENSE, Family.SSM, Family.HYBRID):
        from repro_torch.models import transformer
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family.value} is not ported yet "
        f"(ROADMAP Queue 1 items 6, 10)")


ARCHS = tuple(_MODULES)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of one global batch (registry.py:116): the token batch
    (with labels, or for the crossmodal family the vision regions and VQA
    answers, when ``shape.kind`` is "train"); a decode shape has one token
    per row."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    if cfg.family == Family.CROSSMODAL:
        specs = {"regions": (B, shape.seq_len, cfg.d_model),
                 "tokens": (B, shape.seq_len)}
        if shape.kind == "train":
            specs["answers"] = (B,)
        return specs
    model_module(cfg)            # raises for the families not ported
    specs = {"tokens": (B, S)}
    if shape.kind == "train":
        specs["labels"] = (B, S)
    return specs
