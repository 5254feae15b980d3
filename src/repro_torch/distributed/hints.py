"""Activation-sharding hints (counterpart of ``repro/distributed/hints.py``).

Model code calls ``constrain(x, key)`` at the JAX package's four points:
``embed_out`` (the token-embedding gather, (B, S, D)), ``attn_q`` and
``attn_out`` ((B, H, S, hd): pinning the query sequence over 'model' makes
attention context-parallel for archs whose head count the model axis does
not divide) and ``moe_dispatch`` (the experts' dispatched tokens,
(E, G, C, D)).  Without a hint table (``runtime.flags(sharding_hints=
{key: (mesh, spec)})``) ``constrain`` returns its input unchanged.  With one, a DTensor is
redistributed to the hinted placements; a plain tensor, or a shape that
the hinted axes do not divide, is left as it is (hints.py:30-38).

No entry point installs a table yet.  The mesh train step computes on
plain tensors, the rank's blocks: its tensor parallelism over 'model'
(dense attention's heads, the MLP's d_ff, the vocabulary) is explicit,
at the ``ops`` boundary (``distributed.parallel``), and needs no hint.
The hook is where context-parallel attention, for the archs whose head
count the model axis does not divide, will pin its activations.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.core import runtime


def constrain(x: torch.Tensor, key: str) -> torch.Tensor:
    hints = runtime.get("sharding_hints")
    if not hints or key not in hints:
        return x
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(x, dtensor.DTensor):
        return x                      # a plain tensor has no placement
    from repro_torch.distributed.sharding import placements_for, spec_divides
    mesh, spec = hints[key]
    if not spec_divides(spec, tuple(x.shape), mesh):
        return x                      # not divisible: left unconstrained
    return x.redistribute(mesh, placements_for(spec, mesh))
