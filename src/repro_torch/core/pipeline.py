"""Compute/communication overlap primitives (counterpart of
``repro/core/pipeline.py``, DESIGN.md §5).

``ring_collective_matmul``: the all-gather <-> matmul overlap.  Instead of
all-gathering the row-sharded operand and then multiplying, each step
multiplies the *resident* shard while the next one moves around the ring
by point-to-point ops on the mesh axis: step i's send and receive are
posted before its product and waited for after it, so (g-1)/g of the
gather hides behind the products.  This is the paper's ping-pong
compute-rewriting pipeline at the inter-chip level: 'rewriting' = the
neighbour shard's transfer, 'compute' = the local partial product, which
runs through ``ops.projection`` (the ``tile_gemm`` kernel on the card).
"""
from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from repro_torch.distributed.compression import axis_ring
from repro_torch.kernels import ops


def ring_collective_matmul(x_shard: torch.Tensor, w: torch.Tensor, *, mesh,
                           axis: str) -> torch.Tensor:
    """x_shard (M/g, K) is this rank's row-shard of x along ``axis`` of
    ``mesh`` (rank i of the axis holds rows i*M/g ...); w (K, N) is
    resident.  Returns the full (M, N) = all_gather(x) @ w, with f32
    accumulation, in x's dtype, on every rank of the axis."""
    group, g, nxt, prv = axis_ring(mesh, axis)
    idx = mesh.get_local_rank(axis)
    m = x_shard.shape[0]
    out = x_shard.new_empty((g * m, w.shape[1]))
    shard = x_shard.contiguous()
    for i in range(g):
        reqs, nxt_shard = [], None
        if i < g - 1:          # post the next shard's transfer first
            nxt_shard = torch.empty_like(shard)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, shard, nxt, group),
                dist.P2POp(dist.irecv, nxt_shard, prv, group)])
        src = (idx - i) % g    # the position of ``shard`` in gathered order
        out[src * m:(src + 1) * m] = ops.projection(shard, w)
        for r in reqs:
            r.wait()
        shard = nxt_shard
    return out


def gather_matmul_overlapped(x, w: torch.Tensor, mesh, *,
                             axis: str = "model") -> torch.Tensor:
    """x (M, K) sharded on dim 0 over ``axis`` -- a DTensor, or this rank's
    row-shard as a plain tensor; w replicated.  Returns the full product on
    every rank of the axis (a plain tensor), with ring overlap."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(x, dtensor.DTensor):
        x = x.to_local()
    if isinstance(w, getattr(dtensor, "DTensor", ())):
        w = w.full_tensor()
    return ring_collective_matmul(x, w, mesh=mesh, axis=axis)


def microbatch_overlap_note() -> str:
    """The gradient accumulation of ``train/steps.py`` gives the
    batch-level overlap in the JAX package (XLA schedules each scanned
    microbatch's reductions while the next computes).  This function
    exists for documentation discoverability."""
    return "see train/steps.py make_train_step(microbatches=...)"
