"""Model registry of the port: the architectures ported so far, the model
module that runs each family, and the simulator's hardware and energy
design points (counterpart of ``repro/configs/registry.py``)."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, grok1_314b,
                                 h2o_danube3_4b, hymba_1_5b, mamba2_780m,
                                 minitron_4b, qwen2_vl_2b, qwen3_32b,
                                 starcoder2_7b, vilbert_base, vilbert_large,
                                 whisper_base)
from typing import Dict, Tuple

from repro_torch.configs.hardware import HW_PRESETS, HardwareConfig
from repro_torch.core.types import Family, ModelConfig, ShapeConfig
from repro_torch.sim.energy import ENERGY_PRESETS, EnergyModel

_MODULES = {"vilbert-base": vilbert_base, "vilbert-large": vilbert_large,
            "qwen3-32b": qwen3_32b, "starcoder2-7b": starcoder2_7b,
            "mamba2-780m": mamba2_780m, "hymba-1.5b": hymba_1_5b,
            "whisper-base": whisper_base, "qwen2-vl-2b": qwen2_vl_2b,
            "grok-1-314b": grok1_314b, "deepseek-v3-671b": deepseek_v3_671b,
            "minitron-4b": minitron_4b, "h2o-danube3-4b": h2o_danube3_4b}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """The published configuration of ``name``, or its small ``SMOKE``
    variant for CPU tests."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


# CIM design points of the simulator and their energy-cost tables: the
# same objects as ``configs.hardware.HW_PRESETS`` and
# ``sim.energy.ENERGY_PRESETS`` (``repro/configs/registry.py:36-78``
# gives each one's provenance).
HW_CONFIGS: Dict[str, HardwareConfig] = HW_PRESETS
ENERGY_CONFIGS: Dict[str, EnergyModel] = ENERGY_PRESETS


def get_hw_config(name: str) -> HardwareConfig:
    return HW_CONFIGS[name]


def get_energy_model(name: str) -> EnergyModel:
    return ENERGY_CONFIGS[name]


def model_module(cfg: ModelConfig):
    """The module whose model runs ``cfg``'s family (registry.py:98)."""
    if cfg.family == Family.ENCDEC:
        from repro_torch.models import encdec
        return encdec
    if cfg.family == Family.CROSSMODAL:
        from repro_torch.models import vilbert
        return vilbert
    from repro_torch.models import transformer
    return transformer


ARCHS = tuple(_MODULES)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of one global batch (registry.py:116): the token batch
    (with labels when ``shape.kind`` is "train"); a decode shape has one
    token per row (the MoE family's too, as the dense one's).  The
    encoder-decoder family adds the stub frontend's
    frames (B, encoder_seq, d_model), a VLM's prefill or train batch its
    M-RoPE position streams (3, B, S), and the crossmodal family has the
    vision regions and, to train, VQA answers instead of labels."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    if cfg.family == Family.CROSSMODAL:
        specs = {"regions": (B, shape.seq_len, cfg.d_model),
                 "tokens": (B, shape.seq_len)}
        if shape.kind == "train":
            specs["answers"] = (B,)
        return specs
    specs = {"tokens": (B, S)}
    if cfg.family == Family.ENCDEC:
        specs = {"frames": (B, cfg.encoder_seq, cfg.d_model), **specs}
    if shape.kind == "train":
        specs["labels"] = (B, S)
    if cfg.family == Family.VLM and not shape.is_decode:
        specs["positions"] = (3, B, S)
    return specs
