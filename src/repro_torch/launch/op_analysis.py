"""Per-device FLOPs, bytes and collective traffic of one traced step
(counterpart of ``repro/launch/hlo_analysis.py``).

The JAX dry run parses the post-SPMD HLO of a compiled step.  The port
produces no HLO, so it counts at the dispatcher over one run of the step
(on fake tensors in the dry run, on real ones in tests): ``OpCounter`` is
a ``TorchDispatchMode`` that sees every aten and collective op this rank
runs.

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the same run
  (matrix products and attention, 2 * M * N * K a product, as the HLO
  analyzer counts ``dot``s; elementwise FLOPs are not counted, as there).
* Bytes: the operand and result bytes of every op that is not a view or
  free (the spirit of ``_FREE_OPS``, hlo_analysis.py:222-225): a stand-in
  for HBM traffic with nothing fused, so an upper bound of an eager step's.
* Collectives: the ``_c10d_functional`` ops (what DTensor redistributions
  call), the ``c10d`` ones and the point-to-point sends, each with its
  group's size from the process group it runs on, and the ring traffic
  formulas of hlo_analysis.py:259-272 (``collective_traffic``); a send is
  a collective-permute of its bytes.  A group whose ranks span both halves
  of a two-pod world (mesh order (pod, data, model): pods are contiguous
  rank halves) crosses the pod boundary (hlo_analysis.py:199-219) and its
  traffic counts as ``dcn``, the rest as ``ici``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# (namespace, op name) -> (kind, which tensor's bytes are the size)
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", "out"),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", "out"),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", "out"),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", "out"),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "out"),
    ("_c10d_functional", "broadcast"): ("broadcast", "out"),
    ("c10d", "allreduce_"): ("all-reduce", "in"),
    ("c10d", "allgather_"): ("all-gather", "in"),
    ("c10d", "_allgather_base_"): ("all-gather", "in"),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", "in"),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", "in"),
    ("c10d", "alltoall_base_"): ("all-to-all", "in"),
    ("c10d", "alltoall_"): ("all-to-all", "in"),
    ("c10d", "broadcast_"): ("broadcast", "in"),
    ("c10d", "scatter_"): ("broadcast", "in"),
    ("c10d", "send"): ("collective-permute", "in"),
}
#: ops that move no data of their own (waits, receives: a send counts the
#: transfer) or only set metadata
_FREE = {"wait_tensor", "recv_", "recv_any_source_", "barrier",
         "monitored_barrier_", "detach", "alias", "lift_fresh",
         "lift_fresh_copy", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "_local_scalar_dense", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "set_",
         "resize_", "_to_copy_meta", "is_same_size", "_has_same_storage",
         "record_stream", "_record_function_enter_new",
         "_record_function_exit"}


def collective_traffic(kind: str, nbytes: float, group: int) -> float:
    """Per-device bytes a ring collective moves (hlo_analysis.py:259-272):
    ``nbytes`` is the all-reduced tensor, the gathered result, the
    scattered result, or the sent payload."""
    frac = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2 * nbytes * frac
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return nbytes * frac
    if kind == "reduce-scatter":
        return nbytes * (group - 1)
    return nbytes                              # collective-permute


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _group_ranks(args, kwargs) -> Optional[List[int]]:
    """The global ranks of the process group an op runs on: a group name
    (functional ops) or a ProcessGroup script object (c10d ops)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in list(args) + list(kwargs.values()):
        pg = None
        if isinstance(a, str):
            try:
                pg = c10d._resolve_process_group(a)
            except Exception:      # noqa: BLE001 - not a group name
                pg = None
        elif isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except Exception:      # noqa: BLE001 - another script object
                pg = None
        if pg is not None:
            return dist.get_process_group_ranks(pg)
    return None


class OpCounter(TorchDispatchMode):
    """Counts this rank's ops while active (see the module docstring).
    ``world`` and ``multi_pod`` say where the pod boundary lies."""

    def __init__(self, *, world: int, multi_pod: bool = False):
        super().__init__()
        self.world = world
        self.pod = world // 2 if multi_pod else world + 1
        self.bytes = 0.0
        self.ici = 0.0
        self.dcn = 0.0
        self.counts: Dict[str, int] = {}
        self.ops: List[Dict[str, Any]] = []
        # traffic by the rank stride of the group (a mesh axis: the
        # stride is the product of the sizes of the axes after it); a
        # send's under its peer distance
        self.by_stride: Dict[int, float] = {}

    def _collective(self, kind: str, nbytes: int, ranks: List[int],
                    peer: Optional[int] = None) -> None:
        if peer is not None:           # a send: this rank and its peer
            import torch.distributed as dist
            gs, span = 2, [dist.get_rank(), ranks[peer]]
        else:
            gs, span = len(ranks), ranks
        crosses = min(span) < self.pod <= max(span)
        traffic = collective_traffic(kind, nbytes, gs)
        stride = abs(span[1] - span[0]) if len(span) > 1 else 0
        self.by_stride[stride] = self.by_stride.get(stride, 0.0) + traffic
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.ops.append({"kind": kind, "bytes": nbytes, "group": gs,
                         "traffic": traffic, "cross_pod": crosses})
        if crosses:
            self.dcn += traffic
        else:
            self.ici += traffic

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        key = (ns, name)
        if key in _COLLECTIVES:
            kind, which = _COLLECTIVES[key]
            ranks = _group_ranks(args, kwargs) or list(range(self.world))
            # the result's bytes, else the first argument's (the tensor
            # reduced or sent, the gathered or scattered buffer, or the
            # list of gathered blocks)
            nbytes = _nbytes(out) if which == "out" else _nbytes(args[0])
            peer = args[2] if name == "send" else None
            self._collective(kind, nbytes, ranks, peer)
            return out
        if ns in ("c10d", "_c10d_functional") or name in _FREE \
                or func.is_view:
            return out
        self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out

    def result(self) -> Dict[str, Any]:
        return {"bytes": self.bytes, "ici": self.ici, "dcn": self.dcn,
                "counts": dict(self.counts), "num_ops": len(self.ops),
                "by_stride": dict(self.by_stride)}


def analyze(fn: Callable, *args, world: Optional[int] = None,
            multi_pod: bool = False, **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` once under the counters; returns (its
    result, {"flops", "bytes", "ici", "dcn", "counts", "num_ops",
    "by_stride"}), the per-device numbers of this rank
    (``hlo_analysis.analyze``'s keys, and the collective traffic by the
    rank stride of its group)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    counter = OpCounter(world=world, multi_pod=multi_pod)
    with FlopCounterMode(display=False) as fc, counter:
        out = fn(*args, **kwargs)
    res = counter.result()
    res["flops"] = float(fc.get_total_flops())
    return out, res
