"""Mesh-driven serving (counterpart of ``repro/shard/serve.py``, DESIGN.md
§13): not ported yet.

The JAX package's ``mesh_prefill`` and ``mesh_decode_fn`` wrap a model's
prefill and decode step in ``shard_map`` over a device mesh, behind
``serve.Engine(mesh=...)``.  Their port needs serving across cards
(``torch.distributed``), which comes with multi-GPU training, ROADMAP
Queue 1 item 13; until then both raise, as ``Engine(mesh=...)`` does.
The plan-level sharding (``shard.partition``, ``shard.sim``) is ported and
needs no mesh.
"""
from __future__ import annotations

from typing import Any, Dict

_NOT_PORTED = ("serving on a mesh is not ported yet (ROADMAP Queue 1 "
               "item 13)")


def mesh_prefill(mod, params, cfg, batch: Dict[str, Any], *, mesh,
                 max_len: int, **kwargs):
    """``mod.prefill`` across the cards of ``mesh``: not ported yet."""
    raise NotImplementedError(_NOT_PORTED)


def mesh_decode_fn(mod, cfg, mesh):
    """A decode step across the cards of ``mesh``: not ported yet."""
    raise NotImplementedError(_NOT_PORTED)
