"""Sharded execution plans: one ``ExecutionPlan`` -> per-chip sub-plans +
explicit collectives (DESIGN.md §13).

``shard_plan(plan, mesh)`` extends the compile->plan pipeline with a
sharding axis, resolved per the same rule table ``distributed.sharding``
applies to real parameter trees (copy of ``repro/shard/partition.py``,
pure Python; the rule's predicates come from the port's
``distributed.sharding``):

* ``tensor``   — Megatron head/d_ff split when every attention op's heads
  AND kv-heads divide the chip count (``heads_shardable`` /
  ``kv_heads_shardable`` evaluated on a simulated ``model=chips`` mesh)
  and the FFN widths divide too.  Weights shard, activations replicate;
  each oproj / ffn_down output all-reduces.
* ``sequence`` — context-parallel fallback for non-divisible-head models
  (the starcoder2 / qwen2-vl case in the rule table): queries and FFN
  rows shard over chips, weights replicate, and each attention op
  all-gathers its KV source — choosing the cheaper of raw activations
  (``d_kv``) vs materialized K/V (``kv_width``), the same width race
  ``tile_stream_profitable`` runs for on-chip streaming.
* ``group``    — Hemlet-style group parallelism: whole layers assign to
  chips in contiguous blocks, activations forward chip-to-chip (p2p).

Every sub-plan is a real ``ExecutionPlan`` whose per-op ``hbm_bytes`` /
``rewrite_cycles`` are re-predicted from the *scaled* geometry through the
planner's own formulas, so the sharded prediction is exactly what
``sim.simulate_sharded_plan`` must reproduce per chip — the multi-chip
version of the plan/sim byte-exactness discipline.  Collective byte
predictions come from ``noc.collective_streams`` (the same wire plans the
simulator lowers).  ``ShardedPlan`` serializes like everything else.

Recorded kernel traces (DESIGN.md §10) describe full-size ops and are
dropped from sub-plans — sharded ops are analytic until re-recorded.
"""
from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.distributed.sharding import (_SimulatedMesh, heads_shardable,
                                              kv_heads_shardable)
from repro_torch.plan.planner import (ExecutionPlan, GemmPlan, LayerPlan,
                                      _predict_bytes, _predict_rewrites)
from repro_torch.shard import noc
from repro_torch.shard.noc import MeshSpec

SHARD_VERSION = 1

#: Gemm-name suffixes with a column-sharded (n/C) weight under tensor
#: parallelism; their outputs stay sharded and feed a row-parallel gemm.
_COL_SHARDED = ("_ffn_up", "_ffn_gate")
#: Row-sharded (k/C) gemms; their outputs are partial sums -> all-reduce.
_ROW_SHARDED = ("_ffn_down", "_oproj")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One inter-chip collective, anchored into the plan's op stream.

    ``after`` names the op (unprefixed) whose completion produces the
    payload ("" = the plan input: the collective may start immediately).
    The simulator gates each receiving chip's *next* op on its arrival.
    ``payload_bytes`` is the logical tensor size; ``link_bytes`` the
    predicted total crossing NoC links (from the noc wire plan — ring
    all-reduce pays ``2*(C-1)*payload``, multicast ``(C-1)*payload``...).
    """

    name: str
    kind: str              # noc.COLLECTIVE_KINDS
    after: str
    payload_bytes: int
    link_bytes: int
    root: int = 0          # multicast / p2p source chip
    dst: int = -1          # p2p destination chip

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "CollectiveOp":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """An ``ExecutionPlan`` split across a chiplet mesh."""

    base: ExecutionPlan
    mesh: MeshSpec
    axis: str                                # resolved (never "auto")
    chip_plans: Tuple[ExecutionPlan, ...]
    collectives: Tuple[CollectiveOp, ...]

    @property
    def chips(self) -> int:
        return self.mesh.chips

    @property
    def total_hbm_bytes(self) -> int:
        """Summed per-chip attention-traffic prediction (the quantity
        ``simulate_sharded_plan`` cross-asserts)."""
        return sum(p.total_hbm_bytes for p in self.chip_plans)

    @property
    def total_collective_link_bytes(self) -> int:
        return sum(c.link_bytes for c in self.collectives)

    @property
    def total_rewrite_cycles(self) -> int:
        return sum(p.total_rewrite_cycles for p in self.chip_plans)

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": SHARD_VERSION,
            "mesh": self.mesh.to_dict(),
            "axis": self.axis,
            "base": self.base.to_dict(),
            "chip_plans": [p.to_dict() for p in self.chip_plans],
            "collectives": [c.to_dict() for c in self.collectives],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "ShardedPlan":
        if d.get("version") != SHARD_VERSION:
            raise ValueError(
                f"sharded-plan version {d.get('version')!r} != "
                f"{SHARD_VERSION}; re-shard the plan")
        return cls(
            base=ExecutionPlan.from_dict(d["base"]),
            mesh=MeshSpec.from_dict(d["mesh"]),
            axis=str(d["axis"]),
            chip_plans=tuple(ExecutionPlan.from_dict(p)
                             for p in d["chip_plans"]),
            collectives=tuple(CollectiveOp.from_dict(c)
                              for c in d["collectives"]),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "ShardedPlan":
        return cls.from_dict(json.loads(s))


# --------------------------------------------------------------------------
# axis resolution


def _tensor_shardable(plan: ExecutionPlan, chips: int) -> bool:
    """Megatron split legality, via the ``distributed.sharding`` rule
    helpers on a simulated ``model=chips`` mesh (per-op: crossmodal
    streams carry different head counts)."""
    mesh = _SimulatedMesh({"model": chips, "data": 1})
    for lp in plan.layers:
        shim = SimpleNamespace(num_heads=lp.heads, num_kv_heads=lp.kv_heads)
        if not (heads_shardable(shim, mesh) and
                kv_heads_shardable(shim, mesh)):
            return False
    for g in plan.gemms:
        if g.name.endswith(_COL_SHARDED) and g.n % chips:
            return False
        if g.name.endswith(_ROW_SHARDED) and g.k % chips:
            return False
    return True


def _sequence_shardable(plan: ExecutionPlan, chips: int) -> bool:
    return (all(lp.seq_q % chips == 0 for lp in plan.layers) and
            all(g.m % chips == 0 for g in plan.gemms))


def _layer_indices(plan: ExecutionPlan) -> List[int]:
    return sorted({p.layer_index
                   for p in tuple(plan.layers) + tuple(plan.gemms)})


def resolve_axis(plan: ExecutionPlan, mesh: MeshSpec) -> str:
    """Resolve ``mesh.axis`` ("auto": tensor -> sequence -> group by
    divisibility); validate an explicit request."""
    C = mesh.chips
    if mesh.axis == "auto":
        if _tensor_shardable(plan, C):
            return "tensor"
        if _sequence_shardable(plan, C):
            return "sequence"
        if len(_layer_indices(plan)) >= C:
            return "group"
        raise ValueError(
            f"no sharding axis fits {plan.model} on {C} chips: heads/FFN "
            f"not divisible, sequence not divisible, fewer layers than "
            f"chips")
    if mesh.axis == "tensor" and not _tensor_shardable(plan, C):
        raise ValueError(f"tensor parallelism needs heads/kv-heads/d_ff "
                         f"divisible by {C} (model {plan.model})")
    if mesh.axis == "sequence" and not _sequence_shardable(plan, C):
        raise ValueError(f"sequence parallelism needs seq divisible by "
                         f"{C} (model {plan.model})")
    if mesh.axis == "group" and len(_layer_indices(plan)) < C:
        raise ValueError(f"group parallelism needs >= {C} layers "
                         f"(model {plan.model} has "
                         f"{len(_layer_indices(plan))})")
    return mesh.axis


# --------------------------------------------------------------------------
# per-chip sub-plans


def _repredict(lp: LayerPlan, hw) -> LayerPlan:
    """Re-run the planner's own byte/rewrite prediction on scaled
    geometry — sub-plan predictions stay formula-identical to what the
    schedulers will simulate."""
    return dataclasses.replace(
        lp, hbm_bytes=_predict_bytes(lp, lp.mode, hw),
        rewrite_cycles=_predict_rewrites(lp, lp.mode, hw))


def _shard_tensor(plan: ExecutionPlan, C: int) -> ExecutionPlan:
    """One chip's share under the Megatron split: heads/kv-heads divide,
    activations (d_q/d_kv/seq) replicate, column/row gemm dims divide."""
    hw = plan.hw_config()
    layers = tuple(
        _repredict(dataclasses.replace(
            lp, heads=lp.heads // C, kv_heads=lp.kv_heads // C,
            trace=None), hw)
        for lp in plan.layers)
    gemms = []
    for g in plan.gemms:
        if g.name.endswith(_COL_SHARDED):
            g = dataclasses.replace(g, n=g.n // C, trace=None)
        elif g.name.endswith(_ROW_SHARDED):
            g = dataclasses.replace(g, k=g.k // C, trace=None)
        else:
            g = dataclasses.replace(g, trace=None)
        gemms.append(g)
    return dataclasses.replace(plan, layers=layers, gemms=tuple(gemms))


def _shard_sequence(plan: ExecutionPlan, C: int) -> ExecutionPlan:
    """One chip's share under context parallelism: q tokens and gemm rows
    shard; KV stays full (gathered); weights replicate."""
    hw = plan.hw_config()
    layers = tuple(
        _repredict(dataclasses.replace(
            lp, seq_q=lp.seq_q // C,
            keep_tokens=max(1, lp.keep_tokens // C), trace=None), hw)
        for lp in plan.layers)
    gemms = tuple(dataclasses.replace(g, m=g.m // C, trace=None)
                  for g in plan.gemms)
    return dataclasses.replace(plan, layers=layers, gemms=gemms)


def _group_chunks(indices: Sequence[int], C: int) -> List[List[int]]:
    """Contiguous, balanced layer blocks (remainder to the front)."""
    n = len(indices)
    base, rem = divmod(n, C)
    out, at = [], 0
    for i in range(C):
        size = base + (1 if i < rem else 0)
        out.append(list(indices[at:at + size]))
        at += size
    return out


def _shard_group(plan: ExecutionPlan, C: int) -> List[ExecutionPlan]:
    """Hemlet-style: chip *i* owns a contiguous block of layers verbatim
    (weights stay resident per chip — no rewrite-pressure change per op,
    C-fold fewer layers' worth of rewrites per chip)."""
    chunks = _group_chunks(_layer_indices(plan), C)
    plans = []
    for chunk in chunks:
        own = set(chunk)
        layers = tuple(dataclasses.replace(lp, trace=None)
                       for lp in plan.layers if lp.layer_index in own)
        gemms = tuple(dataclasses.replace(g, trace=None)
                      for g in plan.gemms if g.layer_index in own)
        plans.append(dataclasses.replace(plan, layers=layers, gemms=gemms))
    return plans


# --------------------------------------------------------------------------
# collectives


def _ops_in_order(plan: ExecutionPlan):
    return sorted(tuple(plan.layers) + tuple(plan.gemms),
                  key=lambda p: p.op_index)


def _op_out_bytes(p, ab: int) -> int:
    if isinstance(p, LayerPlan):
        return p.seq_q * p.d_q * ab
    return p.m * p.n * ab


def _input_multicast(plan: ExecutionPlan, mesh: MeshSpec,
                     ab: int) -> Optional[CollectiveOp]:
    """Broadcast the model inputs from the host-attached chip: one
    ``seq x d`` payload per distinct stream width (crossmodal models feed
    two streams)."""
    payload, seen = 0, set()
    for lp in sorted(plan.layers, key=lambda p: p.op_index):
        if lp.d_q not in seen:
            seen.add(lp.d_q)
            payload += lp.seq_q * lp.d_q * ab
    if payload <= 0:
        return None
    return CollectiveOp(
        name="input:multicast", kind="multicast", after="",
        payload_bytes=payload,
        link_bytes=noc.collective_link_bytes(mesh, "multicast", payload),
        root=0)


def _tensor_collectives(sub: ExecutionPlan, mesh: MeshSpec,
                        ab: int) -> List[CollectiveOp]:
    colls = []
    mc = _input_multicast(sub, mesh, ab)
    if mc:
        colls.append(mc)
    for g in sub.gemms:
        if not g.name.endswith(_ROW_SHARDED):
            continue
        payload = g.m * g.n * ab          # n replicate-width on row gemms
        colls.append(CollectiveOp(
            name=f"{g.name}:allreduce", kind="all_reduce", after=g.name,
            payload_bytes=payload,
            link_bytes=noc.collective_link_bytes(
                mesh, "all_reduce", payload)))
    return colls


def _sequence_collectives(base: ExecutionPlan, sub: ExecutionPlan,
                          mesh: MeshSpec, ab: int) -> List[CollectiveOp]:
    colls = []
    mc = _input_multicast(base, mesh, ab)
    if mc:
        colls.append(mc)
    order = _ops_in_order(base)
    prev_name = {order[i].name: (order[i - 1].name if i else "")
                 for i in range(len(order))}
    for lp in base.layers:
        # Gather the cheaper KV representation: raw activations vs
        # materialized K/V — the sequence-parallel analog of the
        # tile_stream_profitable width race.
        width = min(lp.d_kv, lp.kv_width)
        payload = lp.seq_kv * width * ab
        colls.append(CollectiveOp(
            name=f"{lp.name}:kvgather", kind="all_gather",
            after=prev_name[lp.name], payload_bytes=payload,
            link_bytes=noc.collective_link_bytes(
                mesh, "all_gather", payload)))
    last = order[-1]
    payload = _op_out_bytes(last, ab)
    colls.append(CollectiveOp(
        name="output:gather", kind="all_gather", after=last.name,
        payload_bytes=payload,
        link_bytes=noc.collective_link_bytes(mesh, "all_gather", payload)))
    return colls


def shard_plan(plan: ExecutionPlan, mesh: MeshSpec, *,
               axis: Optional[str] = None) -> ShardedPlan:
    """Split ``plan`` across ``mesh``.  ``axis`` overrides ``mesh.axis``.

    1 chip is the identity: sub-plan predictions equal the base plan's
    (same formulas, same geometry) and the collective list is empty —
    the anchor for the 1-chip byte/cycle-identity tests.
    """
    if axis is not None:
        mesh = dataclasses.replace(mesh, axis=axis)
    resolved = resolve_axis(plan, mesh)
    C = mesh.chips
    ab = plan.hw_config().act_bytes

    if resolved == "group":
        chip_plans = _shard_group(plan, C)
    elif resolved == "tensor":
        chip_plans = [_shard_tensor(plan, C)] * C
    else:
        chip_plans = [_shard_sequence(plan, C)] * C

    colls: List[CollectiveOp] = []
    if C > 1:
        if resolved == "tensor":
            colls = _tensor_collectives(chip_plans[0], mesh, ab)
        elif resolved == "sequence":
            colls = _sequence_collectives(plan, chip_plans[0], mesh, ab)
        else:
            for i in range(C - 1):
                nxt = _ops_in_order(chip_plans[i + 1])
                cur = _ops_in_order(chip_plans[i])
                payload = _op_in_bytes(nxt[0], ab)
                colls.append(CollectiveOp(
                    name=f"stage{i}:fwd", kind="p2p", after=cur[-1].name,
                    payload_bytes=payload,
                    link_bytes=noc.collective_link_bytes(
                        mesh, "p2p", payload, root=i, dst=i + 1),
                    root=i, dst=i + 1))

    return ShardedPlan(base=plan, mesh=mesh, axis=resolved,
                       chip_plans=tuple(chip_plans),
                       collectives=tuple(colls))


def _op_in_bytes(p, ab: int) -> int:
    """Activation bytes entering an op (the p2p payload at a group
    boundary)."""
    if isinstance(p, LayerPlan):
        return p.seq_q * p.d_q * ab
    return p.m * p.k * ab
