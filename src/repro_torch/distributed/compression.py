"""Cross-pod gradient compression, int8 with error feedback (counterpart
of ``repro/distributed/compression.py``).

At 2+ pods the data-parallel reduction crosses the slow inter-pod network.
Reduce within the pod at full precision, then exchange int8
per-tensor-scaled gradients across pods, with an error-feedback
accumulator so that the quantization noise is unbiased over steps
(1-bit-Adam lineage).

The exchange is a ring over the mesh's ``pod`` axis: npods - 1 hops, each
sending every tensor's int8 payload and its f32 scale to the next pod and
receiving the previous pod's, by point-to-point ops
(``dist.batch_isend_irecv``), never an all-reduce -- the JAX package's
``ppermute`` ring (compression.py:40-63), in the same order of sums.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _map(fn: Callable, *trees) -> Any:
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def axis_ring(mesh, axis: str) -> Tuple[Any, int, int, int]:
    """(group, size, next rank, previous rank) of this rank's ring along
    ``axis`` of ``mesh``; the neighbours are global ranks."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n, me = len(ranks), mesh.get_local_rank(axis)
    return group, n, ranks[(me + 1) % n], ranks[(me - 1) % n]


def ring_shift(tensors: list, group, nxt: int, prv: int) -> list:
    """Send each of ``tensors`` to rank ``nxt`` and receive as many of the
    same shapes from ``prv``, in one batch of point-to-point ops."""
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def cross_pod_mean_int8(grads: Any, mesh, *, axis: str = "pod") -> Any:
    """Average a tree (dicts) of gradient tensors across ``axis`` of
    ``mesh`` with int8 payloads.  Each rank holds its pod's gradient,
    already reduced within the pod; the result, in each tensor's dtype, is
    the mean of the pods' dequantized gradients, summed in ring order (own
    first).  Without the axis, or at one pod, ``grads`` come back as they
    are."""
    names = mesh.mesh_dim_names or ()
    if axis not in names or mesh.size(names.index(axis)) == 1:
        return grads
    group, npods, nxt, prv = axis_ring(mesh, axis)
    leaves = _leaves(grads)
    qs = [_quantize(g.to(torch.float32)) for g in leaves]
    totals = [_dequantize(q, s) for q, s in qs]     # own contribution
    cur = [t for q, s in qs for t in (q, s.reshape(1))]
    for _ in range(npods - 1):
        cur = ring_shift(cur, group, nxt, prv)
        for i in range(len(leaves)):
            totals[i] = totals[i] + _dequantize(cur[2 * i], cur[2 * i + 1])
    means = iter([(t / npods).to(g.dtype) for t, g in zip(totals, leaves)])
    return _map(lambda g: next(means), grads)


class ErrorFeedback:
    """Error-feedback state: residual = (true - quantized) accumulates and
    is re-injected next step, making int8 compression unbiased over time."""

    @staticmethod
    def init(grads: Any) -> Any:
        return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)

    @staticmethod
    def apply(grads: Any, residual: Any) -> Tuple[Any, Any]:
        """Returns (corrected_grads, quantization_error_to_carry)."""
        corrected = _map(lambda g, r: g.to(torch.float32) + r, grads,
                         residual)
        quantized = _map(lambda c: _dequantize(*_quantize(c)), corrected)
        new_residual = _map(lambda c, q: c - q, corrected, quantized)
        return quantized, new_residual
