"""Activation-sharding hints (counterpart of ``repro/distributed/hints.py``).

Model code calls ``constrain(x, key)`` at the JAX package's four points:
``embed_out`` (the token-embedding gather, (B, S, D)), ``attn_q`` and
``attn_out`` ((B, H, S, hd): pinning the query sequence over 'model' makes
attention context-parallel for archs whose head count the model axis does
not divide) and ``moe_dispatch`` (the experts' dispatched tokens,
(E, G, C, D)).  Without a hint table (``runtime.flags(sharding_hints=
{key: (mesh, spec)})``, built by ``hint_shardings``) ``constrain`` returns
its input unchanged.  With one, a DTensor is redistributed to the hinted
placements; a plain tensor, or a shape that the hinted axes do not divide,
is left as it is (hints.py:30-38).

The dry run installs a table around its traced step (``--hints``,
``--optimized``, as dryrun.py:355 does); the launcher installs none, as
JAX's does not.  The mesh train step computes on plain tensors, the
rank's blocks, so the table acts through what the layers read from it
(``distributed.parallel``), not through ``constrain``:

* ``attn_q`` (with ``attn_out``) makes dense attention context-parallel
  where the heads do not split over 'model' (``parallel.context_split``):
  each rank projects Q for its block of query rows, attends against the
  whole K/V and gathers the rows after ``wo``;
* ``embed_out`` pins the batch-sharded (B, S, D) layout that the
  vocabulary-parallel lookup (``parallel.vocab_embed``) already gives:
  it changes nothing;
* ``moe_dispatch`` names the experts over 'model' that the rule table
  already gives the step (EP, ``layers.moe_forward``): it changes
  nothing.

Prefill and decode cells run the model replicated on every rank: there a
hint is recorded and has no effect.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import torch

from repro_torch.core import runtime


def hint_shardings(names: List[str], mesh) -> Dict[str, Tuple[object, tuple]]:
    """The hint table (dryrun.py:308-322): {name: (mesh, spec)} for the
    names among ``embed_out`` (batch over (pod, data)), ``attn_q`` /
    ``attn_out`` (the query sequence over 'model') and ``moe_dispatch``
    (experts over 'model', groups over the batch axes).  ``mesh``: a
    ``DeviceMesh`` or anything whose ``.shape`` maps axis names to
    sizes."""
    from repro_torch.distributed.sharding import batch_axes
    baxes = batch_axes(mesh)
    if len(baxes) == 1:
        baxes = baxes[0]              # as a PartitionSpec entry holds it
    table = {}
    for n in names:
        if n == "embed_out":
            table[n] = (mesh, (baxes, None, None))
        elif n in ("attn_q", "attn_out"):
            table[n] = (mesh, (baxes, None, "model", None))
        elif n == "moe_dispatch":
            table[n] = (mesh, ("model", baxes, None, None))
    return table


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
