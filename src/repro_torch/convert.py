"""Parameter conversion from the JAX package's trees (as numpy arrays).

The port's modules name their parameters after the JAX tree's keys, so a
tree flattens to the module's ``state_dict`` names.  The layer stacks that
the JAX init builds with ``vmap`` (a leading layer axis) become
``ModuleList`` entries.  ``vilbert_from_jax``, ``transformer_from_jax``
and ``encdec_from_jax`` load a ``repro.models.vilbert.init``, a
``repro.models.transformer.init`` and a ``repro.models.encdec.init`` tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import Transformer
from repro_torch.models.vilbert import ViLBERT


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = np.asarray(val)
    return flat


def _load(model: nn.Module, params_np: Dict[str, Any],
          stacked: Sequence[str], dropped: Sequence[str] = ()) -> None:
    """Copy a flattened JAX tree into ``model``; the leading axis of each
    ``stacked`` subtree indexes its ``ModuleList`` (an unused extra layer
    is dropped); every parameter must be covered, with its shape."""
    state = {}
    for name, arr in _flatten(params_np).items():
        if name in dropped:
            continue
        top, _, rest = name.partition(".")
        if top in stacked:
            for i in range(len(getattr(model, top))):
                state[f"{top}.{i}.{rest}"] = arr[i]
        else:
            state[name] = arr
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, arr in state.items():
            dst = own[name]
            src = torch.from_numpy(np.array(arr, dtype=np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))


def vilbert_from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> ViLBERT:
    """A ``ViLBERT`` holding the weights of a ``repro.models.vilbert.init``
    tree whose leaves were turned into numpy arrays."""
    model = ViLBERT(cfg, device=device)
    _load(model, params_np, ("text_pre", "co_x", "co_y"),
          dropped=("text_embed.unembed",))   # the encoder never unembeds
    return model


def transformer_from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Transformer:
    """A ``Transformer`` holding the weights of a
    ``repro.models.transformer.init`` tree (dense, MoE, VLM, SSM or hybrid
    family) whose leaves were turned into numpy arrays; the stacked
    ``layers`` axis (and the MoE family's ``dense_layers`` prefix) becomes
    the ``ModuleList`` of that name.  Every leaf (an SSM mixer's ``ssm.*``,
    a hybrid layer's ``mix_beta``, the expert stacks (E, d, f), a shared
    expert, the MLA tree, ``mtp_proj``) must have its parameter, with its
    shape."""
    model = Transformer(cfg, device=device)
    _load(model, params_np, ("dense_layers", "layers"))
    return model


def encdec_from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> EncDec:
    """An ``EncDec`` holding the weights of a ``repro.models.encdec.init``
    tree whose leaves were turned into numpy arrays; the stacked
    ``enc_layers`` and ``dec_layers`` axes become its ``ModuleList``s.
    Every leaf must have its parameter, with its shape."""
    model = EncDec(cfg, device=device)
    _load(model, params_np, ("enc_layers", "dec_layers"))
    return model
