"""repro_torch.shard — chiplet-mesh scale-out (counterpart of
``repro/shard/__init__.py``, DESIGN.md §13).

plan -> shard -> simulate -> serve across a StreamDCIM chiplet mesh:

* ``noc``       — ``MeshSpec`` topologies, NoC link resources, collective
  wire plans, the pipelined-multicast overlap calculus.
* ``partition`` — ``shard_plan``: tensor / sequence / group parallel
  sub-plans + explicit collectives with predicted bytes.
* ``sim``       — ``simulate_sharded_plan``: per-chip lowering through
  the existing mode schedulers + NoC collectives, byte-exactness
  asserted against the sharded plan.
* ``serve``     — prefill/decode on every rank of a ``torch.distributed``
  mesh, the model replicated (``serve.Engine(mesh=...)``).
* ``sweep``     — the chips x topology x per-chip-hardware system sweep
  (``python -m repro_torch.shard``).
"""
from repro_torch.shard.noc import (MeshSpec, collective_link_bytes,
                                   collective_streams, link_name,
                                   lower_collective, multicast_span,
                                   pipelined_multicast_wins)
from repro_torch.shard.partition import (CollectiveOp, ShardedPlan,
                                         resolve_axis, shard_plan)
from repro_torch.shard.serve import mesh_decode_fn, mesh_prefill
from repro_torch.shard.sim import ShardSimResult, simulate_sharded_plan
from repro_torch.shard.sweep import (ShardSweepResult, ShardSweepRow,
                                     run_shard_sweep)

__all__ = [
    "MeshSpec", "CollectiveOp", "ShardedPlan", "ShardSimResult",
    "ShardSweepResult", "ShardSweepRow",
    "collective_link_bytes", "collective_streams", "link_name",
    "lower_collective", "mesh_decode_fn", "mesh_prefill",
    "multicast_span", "pipelined_multicast_wins", "resolve_axis",
    "run_shard_sweep", "shard_plan", "simulate_sharded_plan",
]
