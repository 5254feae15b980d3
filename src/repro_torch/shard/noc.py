"""Inter-chip NoC model for the DES simulator (copy of
``repro/shard/noc.py``, pure Python; DESIGN.md §13).

A ``MeshSpec`` describes a StreamDCIM chiplet mesh: chip count, link
topology, per-link bandwidth and per-hop latency.  Each unidirectional
link is its own engine resource (``NOC_0``, ``NOC_1``, ...), so link
contention falls out of the in-order list scheduler exactly like HBM and
macro-array contention do on one chip.

Collectives are modeled as *wire plans*: a tuple of ``Stream``s, each a
chunk of payload traversing a sequence of ``Hop``s (one link each).
``collective_streams`` is the single source of truth — ``partition.py``
sums it to *predict* collective bytes, ``sim.py`` lowers the same streams
onto the engine, and the byte-exactness assert between the two holds by
construction (and is still checked, not hoped for).

Overlap calculus (cf. the csl-experiments SUMMA streaming study,
``gemm/analyze_pipeline_benefit.py``): a store-and-forward multicast
serializes ``(C-1) x (hop + payload/bw)``; splitting the payload into n
chunks pipelines the hops, reaching the furthest chip in
``(n + C - 2) x (hop + chunk/bw)``.  Pipelining wins exactly when the
serialized broadcast term dominates the per-chunk hop overhead —
``pipelined_multicast_wins`` evaluates both closed forms.  Because link
tasks occupy ``NOC_*`` resources rather than any chip's macro arrays,
whatever multicast tail remains after a chip's own arrival overlaps that
chip's compute — the same way the ping-pong shadow sub-array hides
rewrites under attention (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

TOPOLOGIES = ("ring", "line")

COLLECTIVE_KINDS = ("multicast", "all_gather", "reduce_scatter",
                    "all_reduce", "p2p")

#: Engine resource name for unidirectional inter-chip link ``i``.
LINK_PREFIX = "NOC_"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A chiplet mesh: every chip is a full StreamDCIM accelerator
    (its own macro arrays, HBM port, on-chip NoC); chips connect by
    unidirectional links.

    * ``ring`` — ``chips`` links, link *i* carries chip *i* -> *i+1 mod C*.
    * ``line`` — ``2*(chips-1)`` links: forward link *i* carries
      *i* -> *i+1*; backward link ``(chips-1)+i`` carries *i+1* -> *i*.
      Ring collective schedules still run, but the wrap step routes back
      through every link — the emergent penalty is the topology axis.

    ``axis`` picks the sharding axis (``partition.shard_plan``):
    ``auto`` resolves tensor -> sequence -> group by divisibility.
    """

    chips: int = 1
    topology: str = "ring"
    link_bytes_per_cycle: int = 128
    hop_cycles: int = 32
    pipelined_multicast: bool = True
    multicast_chunks: int = 8
    axis: str = "auto"

    def __post_init__(self):
        if self.chips < 1:
            raise ValueError(f"chips must be >= 1, got {self.chips}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; one of {TOPOLOGIES}")
        if self.link_bytes_per_cycle < 1:
            raise ValueError("link_bytes_per_cycle must be >= 1, got "
                             f"{self.link_bytes_per_cycle}")
        if self.hop_cycles < 0:
            raise ValueError(f"hop_cycles must be >= 0, got {self.hop_cycles}")
        if self.multicast_chunks < 1:
            raise ValueError("multicast_chunks must be >= 1, got "
                             f"{self.multicast_chunks}")
        if self.axis not in ("auto", "tensor", "sequence", "group"):
            raise ValueError(f"unknown sharding axis {self.axis!r}")

    @property
    def name(self) -> str:
        return f"{self.topology}{self.chips}"

    @property
    def num_links(self) -> int:
        if self.chips == 1:
            return 0
        return self.chips if self.topology == "ring" else 2 * (self.chips - 1)

    def link_names(self) -> Tuple[str, ...]:
        return tuple(link_name(i) for i in range(self.num_links))

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "MeshSpec":
        return cls(**dict(d))


def link_name(i: int) -> str:
    return f"{LINK_PREFIX}{i}"


def is_link_resource(resource: str) -> bool:
    return resource.startswith(LINK_PREFIX)


# --------------------------------------------------------------------------
# wire plans


@dataclasses.dataclass(frozen=True)
class Hop:
    """One link traversal: ``nbytes`` cross link ``link`` and land on
    chip ``dst`` (which may forward them on the stream's next hop)."""

    link: int
    dst: int
    nbytes: int


@dataclasses.dataclass(frozen=True)
class Stream:
    """One chunk of a collective's payload flowing ``src`` -> hops."""

    src: int
    hops: Tuple[Hop, ...]


def _split(total: int, parts: int) -> List[int]:
    """Split ``total`` bytes into ``parts`` integer chunks (exact sum)."""
    parts = max(1, min(parts, total)) if total > 0 else 1
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def _step_hops(mesh: MeshSpec, src: int, dst: int,
               nbytes: int) -> List[Hop]:
    """Physical hops moving one chip at a time from ``src`` to ``dst``.
    Ring: always the forward direction.  Line: no wrap link, so backward
    moves use the dedicated reverse links."""
    C = mesh.chips
    hops: List[Hop] = []
    at = src
    if mesh.topology == "ring":
        while at != dst:
            nxt = (at + 1) % C
            hops.append(Hop(at, nxt, nbytes))
            at = nxt
    else:  # line
        while at != dst:
            if dst > at:
                hops.append(Hop(at, at + 1, nbytes))
                at += 1
            else:
                hops.append(Hop((C - 1) + (at - 1), at - 1, nbytes))
                at -= 1
    return hops


def _ring_walk(mesh: MeshSpec, start: int, steps: int,
               nbytes: int) -> List[Hop]:
    """``steps`` consecutive logical ring steps from ``start`` (each one
    chip forward); on a line the wrap step expands to physical hops."""
    C = mesh.chips
    hops: List[Hop] = []
    at = start
    for _ in range(steps):
        nxt = (at + 1) % C
        hops.extend(_step_hops(mesh, at, nxt, nbytes))
        at = nxt
    return hops


def _multicast_branches(mesh: MeshSpec, root: int) -> List[List[int]]:
    """Chip paths a broadcast from ``root`` follows (chain per branch)."""
    C = mesh.chips
    if mesh.topology == "ring":
        return [[(root + k) % C for k in range(C)]]
    fwd = list(range(root, C))
    bwd = list(range(root, -1, -1))
    out = []
    if len(fwd) > 1:
        out.append(fwd)
    if len(bwd) > 1:
        out.append(bwd)
    return out


def collective_streams(mesh: MeshSpec, kind: str, payload: int, *,
                       root: int = 0, dst: int = -1) -> Tuple[Stream, ...]:
    """The wire plan for one collective — the SINGLE source of truth for
    collective bytes (prediction in ``partition``, lowering in ``sim``).

    * ``multicast`` — pipelined chunk chains from ``root`` (chunk count 1
      when ``pipelined_multicast`` is off: store-and-forward).
    * ``all_gather`` — ring schedule: shard *j* (payload/C) starts at chip
      *j* and circulates C-1 ring steps.
    * ``reduce_scatter`` — the mirror image: shard *j*'s partial sums
      circulate C-1 steps and land reduced on chip *j*.
    * ``all_reduce`` — reduce-scatter then all-gather fused per shard:
      2*(C-1) ring steps, the textbook ``2*(C-1)/C * payload`` per chip.
    * ``p2p`` — ``root`` -> ``dst`` along the physical path, chunked like
      multicast so multi-hop forwards pipeline too.
    """
    C = mesh.chips
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    if C == 1 or payload <= 0:
        return ()
    streams: List[Stream] = []
    if kind in ("multicast", "p2p"):
        n = mesh.multicast_chunks if mesh.pipelined_multicast else 1
        if kind == "multicast":
            branches = [
                [h for a, b in zip(path, path[1:])
                 for h in _step_hops(mesh, a, b, 0)]
                for path in _multicast_branches(mesh, root)]
        else:
            if not 0 <= dst < C:
                raise ValueError(f"p2p needs a dst chip, got {dst}")
            branches = [_step_hops(mesh, root, dst, 0)]
        for chunk in _split(payload, n):
            for branch in branches:
                streams.append(Stream(root, tuple(
                    dataclasses.replace(h, nbytes=chunk) for h in branch)))
        return tuple(streams)
    shards = _split(payload, C)
    for j, shard in enumerate(shards):
        if shard <= 0:
            continue
        if kind == "all_gather":
            start, steps = j, C - 1
        elif kind == "reduce_scatter":
            start, steps = (j + 1) % C, C - 1
        else:  # all_reduce
            start, steps = (j + 1) % C, 2 * (C - 1)
        streams.append(Stream(start, tuple(
            _ring_walk(mesh, start, steps, shard))))
    return tuple(streams)


def collective_link_bytes(mesh: MeshSpec, kind: str, payload: int, *,
                          root: int = 0, dst: int = -1) -> int:
    """Total bytes crossing inter-chip links for one collective."""
    return sum(h.nbytes for s in
               collective_streams(mesh, kind, payload, root=root, dst=dst)
               for h in s.hops)


def _hop_cycles(mesh: MeshSpec, nbytes: int) -> int:
    return mesh.hop_cycles + math.ceil(nbytes / mesh.link_bytes_per_cycle)


def lower_collective(eng, mesh: MeshSpec, coll, *,
                     dep_of: Callable[[int], Sequence[int]],
                     tag: str) -> Dict[int, int]:
    """Lower one collective's wire plan onto ``eng`` and return
    ``{chip: arrival task}`` — the task after which that chip holds its
    share of the result.  Per-chip arrivals are what make pipelined
    multicast overlap compute: chip *j* is gated only on its own last
    chunk, while the tail of the broadcast keeps streaming to chips
    *j+1..* on link resources no macro array ever waits for.

    ``coll`` is duck-typed (``kind`` / ``payload_bytes`` / ``root`` /
    ``dst`` attributes); ``dep_of(chip)`` supplies the producer tasks of
    data originating at that chip.  Reductions conservatively gate every
    stream on all chips' producers (ring steps touch every operand).
    """
    kind = coll.kind
    streams = collective_streams(mesh, kind, coll.payload_bytes,
                                 root=coll.root, dst=coll.dst)
    if not streams:
        return {}
    shared: List[int] = []
    if kind in ("reduce_scatter", "all_reduce"):
        deps = sorted({d for c in range(mesh.chips) for d in dep_of(c)})
        shared = [eng.barrier(deps, tag=f"{tag}:operands")] if deps else []
    recv: Dict[int, List[int]] = {}
    for si, st in enumerate(streams):
        prev = list(shared) if shared else list(dep_of(st.src))
        for hi, hop in enumerate(st.hops):
            t = eng.task("noc", link_name(hop.link),
                         _hop_cycles(mesh, hop.nbytes), prev,
                         nbytes=hop.nbytes, tag=f"{tag}:s{si}h{hi}")
            prev = [t]
            recv.setdefault(hop.dst, []).append(t)
    return {chip: (ts[0] if len(ts) == 1 else
                   eng.barrier(ts, tag=f"{tag}:c{chip}"))
            for chip, ts in recv.items()}


# --------------------------------------------------------------------------
# analytic overlap calculus


def multicast_span(mesh: MeshSpec, payload: int, *,
                   pipelined: bool = None) -> int:
    """Closed-form arrival cycle at the furthest chip on an idle mesh."""
    C = mesh.chips
    if C == 1 or payload <= 0:
        return 0
    depth = max(len(_step_hops(mesh, p[0], p[-1], 0))
                for p in _multicast_branches(mesh, 0))
    if pipelined is None:
        pipelined = mesh.pipelined_multicast
    n = mesh.multicast_chunks if pipelined else 1
    n = max(1, min(n, payload))
    chunk = math.ceil(payload / n)
    return (n + depth - 1) * _hop_cycles(mesh, chunk)


def pipelined_multicast_wins(mesh: MeshSpec, payload: int) -> bool:
    """True when chunked pipelining beats store-and-forward — i.e. when
    the serialized broadcast term ``(C-1) * payload/bw`` outweighs the
    extra per-chunk hop overhead (the (P-1)*broadcast > overhead rule
    from the csl-experiments pipeline-benefit analysis)."""
    return (multicast_span(mesh, payload, pipelined=True)
            < multicast_span(mesh, payload, pipelined=False))
