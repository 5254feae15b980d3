"""Mesh-driven serving (counterpart of ``repro/shard/serve.py``, DESIGN.md
§13).

Over a ``torch.distributed`` ``DeviceMesh`` (``launch.mesh``: the
production grid, or ``make_host_mesh()``) every spec is replicated,
as the JAX package's ``P()`` specs are: ``replicate`` makes every rank of
the mesh hold the first rank's weights, and each rank then runs the
single-device prefill and decode -- so on the (1, 1) mesh the numerics,
the kernels and their launch counts are the single-device path's, and on
a larger mesh every rank gives the same tokens.  ``serve.Engine(mesh=...)``
calls ``replicate`` once and then the model's own prefill and decode;
``mesh_prefill`` and ``mesh_decode_fn`` are the JAX API's functions for
callers that drive a model by hand.  The plan-level sharding
lives in ``shard.partition``; parameter placements for meshes of many
devices come from ``distributed.sharding.param_shardings``.

The port serves a module (the model holds its weights), where the JAX
functions take (mod, params, cfg).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh) -> None:
    """Make every rank of ``mesh`` hold the weights of its first rank
    (a broadcast per tensor; nothing moves on a one-rank mesh)."""
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) == 1:
        return
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError("replicate: the mesh must span the process group")
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=ranks[0])


def mesh_prefill(model, batch: Dict[str, Any], *, mesh, max_len: int,
                 **kwargs):
    """``model.prefill`` on this rank of ``mesh``, every input replicated.
    ``kwargs`` (``plan=`` / ``mode=``) pass through, as the single-device
    engine passes them."""
    del mesh                      # replicated: the rank's own call
    kw = {k: v for k, v in kwargs.items() if v is not None}
    return model.prefill(batch, max_len=max_len, **kw)


def mesh_decode_fn(model, mesh) -> Callable:
    """A decode step on this rank of ``mesh``: drop-in for the engine's
    ``model.decode_step``."""
    del mesh
    return model.decode_step
