"""Simulation result cache for the DSE pipeline (copy of
``repro/dse/cache.py``, pure Python; DESIGN.md §16).

The sweep hot path is ``plan_model -> simulate_plan -> energy fold ->
bottleneck/headroom stamps``; everything after planning is a pure
function of (plan JSON, hardware timing parameters, calibration scale,
lowering).  ``SimCache`` memoizes that pure suffix under a content hash
of exactly those inputs, so:

* re-sweeping a grid in-process (the successive-halving search re-visits
  survivors; ``frontier_sensitivity`` style analyses re-run sweeps) pays
  planning only;
* ``python -m repro_torch.dse --cache DIR`` warm-starts across
  invocations through the on-disk store (one JSON file per key, written
  atomically so parallel workers can share a directory);
* the energy-table axis stays a re-fold: one cached entry carries the
  folds for every ``EnergyModel`` it has been evaluated under, keyed by
  the *content* of the cost table (never its name — two different ad-hoc
  tables must never collide).

What is cached is the ``SweepRow``-feeding summary — latency cycles, HBM
bytes, per-resource utilization, bottleneck, causal headroom, and
per-table energy folds — **not** the event trace: entries are a few KB,
and every number is bit-identical to a cold simulation because it *is*
the cold simulation's number serialized through JSON (floats round-trip
exactly).  A lookup only hits when every requested energy fold is
already present; otherwise the point re-simulates and the stored entry
is replaced with the union of folds (correctness first, reuse second).

Key hygiene: the hardware fingerprint drops the config ``name`` (timing
is a function of parameters, so ``streamdcim-base`` and an identically
parameterized ad-hoc point share an entry), and the ``evaluator`` field
namespaces full-fidelity sweep points (``"point"``) away from the
search's cheap rung evaluations (``"proxy"`` — those skip the
bottleneck/headroom stamps, so their records must never satisfy a
full-fidelity lookup).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, Iterable, Mapping, Optional

from repro_torch.configs.hardware import HardwareConfig
from repro_torch.sim.energy import EnergyModel

#: Bump on any change to the cached-record shape or the key recipe;
#: mismatched on-disk entries are ignored (treated as misses), never
#: mis-replayed.
CACHE_SCHEMA_VERSION = 1


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def hw_fingerprint(hw: HardwareConfig) -> str:
    """Content hash of the *timing-relevant* hardware parameters: the
    ``name`` is presentation, not physics, and is excluded."""
    d = dataclasses.asdict(hw)
    d.pop("name", None)
    return hashlib.sha256(_canonical(d).encode()).hexdigest()[:16]


def energy_fingerprint(em: EnergyModel) -> str:
    """Content hash of one pJ-cost table (including its leakage map).
    The name is *included*: ``SweepRow.energy_model`` labels partition
    frontier cells, so two same-cost tables under different names are
    still distinct rows and cache their folds separately."""
    d = dataclasses.asdict(em)
    d["leak_pj_per_cycle"] = dict(sorted(d["leak_pj_per_cycle"].items()))
    return hashlib.sha256(_canonical(d).encode()).hexdigest()[:16]


def sim_cache_key(plan_json: str, hw: HardwareConfig,
                  scale: Optional[Mapping[str, float]] = None,
                  lowering: str = "plan",
                  evaluator: str = "point") -> str:
    """The content key over everything that determines the simulated
    schedule: the serialized ``ExecutionPlan`` (geometry, modes, attached
    kernel traces), the hardware timing parameters, the resolved
    per-resource calibration scale, the lowering (``"plan"`` for
    ``simulate_plan``; serve sweeps would key ``"serve-fine"`` /
    ``"serve-coarse"`` — the decode-lowering axis changes event shape),
    and the evaluator namespace (see module docstring)."""
    payload = _canonical({
        "v": CACHE_SCHEMA_VERSION,
        "plan": hashlib.sha256(plan_json.encode()).hexdigest(),
        "hw": hw_fingerprint(hw),
        "scale": dict(sorted((scale or {}).items())),
        "lowering": lowering,
        "evaluator": evaluator,
    })
    return hashlib.sha256(payload.encode()).hexdigest()


@dataclasses.dataclass
class CachedPoint:
    """One memoized simulation summary (see module docstring)."""

    key: str
    cycles: int
    hbm_bytes: int
    utilization: Dict[str, float]
    bottleneck: str
    headroom: Dict[str, float]
    #: ``energy_fingerprint(em)`` -> {"name", "total_pj", "edp",
    #: "by_resource"} — the folds computed so far for this trace.
    energy: Dict[str, Dict[str, object]]
    #: Non-keying provenance (model, seq_len, hw name) for debuggability.
    info: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["schema_version"] = CACHE_SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "CachedPoint":
        return cls(key=d["key"], cycles=int(d["cycles"]),
                   hbm_bytes=int(d["hbm_bytes"]),
                   utilization=dict(d["utilization"]),
                   bottleneck=str(d["bottleneck"]),
                   headroom=dict(d["headroom"]),
                   energy={k: dict(v) for k, v in d["energy"].items()},
                   info=dict(d.get("info", {})))


def _empty_stats() -> Dict[str, int]:
    return {"hits": 0, "misses": 0, "disk_hits": 0, "stores": 0}


class SimCache:
    """In-memory + optional on-disk simulation cache.

    ``path=None`` is a process-local memo; with a directory path every
    entry also persists as ``<key>.json`` (written atomically via
    tempfile + rename, so concurrent sweep workers sharing the directory
    race benignly — last identical write wins).
    """

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._mem: Dict[str, CachedPoint] = {}
        self.stats = _empty_stats()
        if path:
            os.makedirs(path, exist_ok=True)

    # ---------- lookup / store ----------

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def _load_disk(self, key: str) -> Optional[CachedPoint]:
        if not self.path:
            return None
        p = self._entry_path(key)
        try:
            with open(p) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return None
        if d.get("schema_version") != CACHE_SCHEMA_VERSION:
            return None           # stale schema: miss, never mis-replay
        try:
            return CachedPoint.from_dict(d)
        except (KeyError, TypeError, ValueError):
            return None

    def lookup(self, key: str,
               energy_fps: Iterable[str] = ()) -> Optional[CachedPoint]:
        """Return the entry for ``key`` iff it exists AND already carries
        a fold for every fingerprint in ``energy_fps`` (a partial entry
        re-simulates — the trace is not stored, so missing folds cannot
        be recovered from the cache)."""
        pt = self._mem.get(key)
        from_disk = False
        if pt is None:
            pt = self._load_disk(key)
            from_disk = pt is not None
        if pt is not None and all(fp in pt.energy for fp in energy_fps):
            if from_disk:
                self._mem[key] = pt
                self.stats["disk_hits"] += 1
            self.stats["hits"] += 1
            return pt
        self.stats["misses"] += 1
        return None

    def store(self, pt: CachedPoint) -> None:
        """Insert/replace an entry (union of energy folds with any
        existing record for the same key)."""
        prev = self._mem.get(pt.key) or self._load_disk(pt.key)
        if prev is not None:
            merged = dict(prev.energy)
            merged.update(pt.energy)
            pt = dataclasses.replace(pt, energy=merged)
        self._mem[pt.key] = pt
        self.stats["stores"] += 1
        if self.path:
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(pt.to_dict(), f)
                os.replace(tmp, self._entry_path(pt.key))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    def adopt(self, pt: CachedPoint) -> None:
        """Insert a record produced elsewhere (a sweep pool worker) into
        the in-memory map — fold-union like ``store`` but without stat
        bumps or a disk write (a disk-backed worker already persisted the
        entry; double-writing would only race)."""
        prev = self._mem.get(pt.key)
        if prev is not None:
            merged = dict(prev.energy)
            merged.update(pt.energy)
            pt = dataclasses.replace(pt, energy=merged)
        self._mem[pt.key] = pt

    # ---------- bookkeeping ----------

    def __len__(self) -> int:
        return len(self._mem)

    def merge_stats(self, other: Mapping[str, int]) -> None:
        """Fold a worker's stat delta into this cache's counters (the
        parallel sweep executor reports per-task stats back)."""
        for k, v in other.items():
            self.stats[k] = self.stats.get(k, 0) + int(v)


def resolve_cache(cache) -> Optional[SimCache]:
    """Normalize a ``run_sweep(cache=...)`` argument: None, a ``SimCache``
    instance, or a directory path string (opens/creates the disk store)."""
    if cache is None or isinstance(cache, SimCache):
        return cache
    if isinstance(cache, (str, os.PathLike)):
        return SimCache(str(cache))
    raise TypeError(f"cache must be None, a SimCache, or a directory "
                    f"path, got {cache!r}")
