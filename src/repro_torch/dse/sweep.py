"""The DSE sweep engine: (HardwareConfig grid) x (models) x (shapes)
(copy of ``repro/dse/sweep.py``, pure Python).

Every point runs the canonical compile->plan->simulate path
(``plan_model`` -> ``simulate_plan``) and is recorded as one ``SweepRow``
carrying latency, total/per-resource energy, EDP, per-resource
utilization, and the serialized ``ExecutionPlan`` — the plan JSON is the
replay artifact: feeding it back through ``ExecutionPlan.from_json`` ->
``simulate_plan`` reproduces the row's latency and energy exactly
(test-pinned), so a frontier point found in a sweep can always be
re-examined at full trace fidelity.

Grid semantics: design points are ``HardwareConfig.sweep`` products over
``Axes`` (paired ``groups`` splits so ``gen_groups < num_groups`` holds by
construction, plus independent axes); combinations the validator rejects
are recorded in ``SweepResult.skipped``, never silently dropped.  The
registry presets always lead the point list, so a ``--points N`` budget
(CI smoke) still covers the named designs.

Trace calibration (DESIGN.md §10): ``run_sweep(calibrations=...)`` adds a
third partition axis next to model and shape — each entry (None, or a
``repro_torch.sim.replay.CalibrationReport`` fitted from recorded kernel
traces) sweeps the grid once with the fitted per-resource cycle scales
applied; rows are labeled and frontier/knee extraction never mixes
calibrated with uncalibrated timing.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.hardware import HardwareConfig
from repro_torch.dse.cache import (CachedPoint, SimCache, energy_fingerprint,
                                   resolve_cache, sim_cache_key)
from repro_torch.sim.energy import EnergyModel, STREAMDCIM_ENERGY_BASE


# ---------------------------------------------------------------------------
# Grid definition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axes:
    """One sweep grid over ``HardwareConfig`` fields.

    ``groups`` pairs ``(num_groups, gen_groups)`` because the two fields
    are constrained together (the mixed-stationary split); the remaining
    axes are independent.  ``extra`` admits any other config field
    (``macros_per_group``, ``noc_bytes_per_cycle``, ...) by name.
    """

    groups: Tuple[Tuple[int, int], ...] = ((2, 1), (4, 1), (4, 2),
                                           (8, 2), (8, 4))
    rewrite_bus_bits: Tuple[int, ...] = (512, 2048)
    ping_pong: Tuple[bool, ...] = (True, False)
    extra: Mapping[str, Tuple[object, ...]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        clash = sorted(set(self.extra)
                       & {"num_groups", "gen_groups", "rewrite_bus_bits",
                          "ping_pong"})
        if clash:
            raise ValueError(
                f"extra axes {clash} collide with built-in Axes fields — "
                "set them on the Axes itself (groups pairs num_groups "
                "with gen_groups)")

    def overrides(self) -> Iterable[Dict[str, object]]:
        """Yield one override dict per grid combination."""
        extra_keys = sorted(self.extra)
        extra_vals = [self.extra[k] for k in extra_keys]
        for (ng, gg), bus, pp, *ev in itertools.product(
                self.groups, self.rewrite_bus_bits, self.ping_pong,
                *extra_vals):
            ov: Dict[str, object] = {"num_groups": ng, "gen_groups": gg,
                                     "rewrite_bus_bits": bus,
                                     "ping_pong": pp}
            ov.update(zip(extra_keys, ev))
            yield ov


DEFAULT_AXES = Axes()


def grid_points(base: Optional[HardwareConfig] = None,
                axes: Axes = DEFAULT_AXES,
                presets: Sequence[HardwareConfig] = (),
                ) -> Tuple[List[HardwareConfig], List[Dict[str, object]]]:
    """Materialize the design-point list: ``presets`` first (dedup'd by
    parameters), then the validated grid.  Returns (points, skipped) where
    each skipped record carries the overrides and the validator's reason."""
    points: List[HardwareConfig] = []
    seen = set()

    def key(hw: HardwareConfig):
        d = dataclasses.asdict(hw)
        d.pop("name")
        return tuple(sorted(d.items()))

    for hw in presets:
        if key(hw) not in seen:
            seen.add(key(hw))
            points.append(hw)
    skipped: List[Dict[str, object]] = []
    for ov in axes.overrides():
        try:
            hw = HardwareConfig.sweep(base, **ov)
        except ValueError as e:
            skipped.append({"overrides": ov, "reason": str(e)})
            continue
        if key(hw) not in seen:
            seen.add(key(hw))
            points.append(hw)
    return points, skipped


# ---------------------------------------------------------------------------
# Sweep rows / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepRow:
    """One simulated (design point, model, shape) record."""

    model: str
    seq_len: int              # 0 = the model's paper-typical default
    hw: str
    hw_params: Mapping[str, object]
    energy_model: str
    latency_cycles: int
    hbm_bytes: int
    energy_pj: float
    edp: float                # energy_pj * latency_cycles
    utilization: Mapping[str, float]
    energy_by_resource: Mapping[str, float]
    plan_json: str            # ExecutionPlan.to_json() — the replay artifact
    calibration: str = "analytic"   # CalibrationReport the timing used
                                    # ("analytic" = uncalibrated model)
    # The applied per-resource scale factors (empty = analytic), so a
    # calibrated row is reproducible from the artifact alone:
    # simulate_plan(from_json(plan_json), calibration=calibration_scale)
    # replays the row's latency exactly, like plan_json does analytically.
    calibration_scale: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    # Critical resource of the simulated trace (``obs.bottleneck_of``) —
    # what a next design iteration at this point should attack.
    bottleneck: str = ""
    # Per-resource causal headroom (``obs.whatif.headroom``): fractional
    # makespan reduction with that resource free.  Unlike busy-share this
    # is a what-if over the trace DAG, so a busy-but-off-path resource
    # scores ~0 — the frontier explains *why* a design wins.
    headroom: Mapping[str, float] = dataclasses.field(default_factory=dict)

    @property
    def num_macros(self) -> int:
        return (int(self.hw_params["num_groups"])
                * int(self.hw_params["macros_per_group"]))

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["utilization"] = dict(self.utilization)
        d["energy_by_resource"] = dict(self.energy_by_resource)
        d["hw_params"] = dict(self.hw_params)
        d["calibration_scale"] = dict(self.calibration_scale)
        d["headroom"] = dict(self.headroom)
        d["num_macros"] = self.num_macros
        return d


def pareto_frontier(rows: Sequence[SweepRow]) -> List[SweepRow]:
    """Non-dominated rows under (latency_cycles, energy_pj) minimization:
    a row survives unless some other row is <= on both metrics and < on at
    least one.  Single pass over the latency-sorted list (skyline sweep);
    rows tied on *both* metrics are all non-dominated (``dominates``
    requires one strict inequality) and all kept — equal-cost points sort
    adjacent, so an exact tie with the last frontier member is the only
    tie case."""
    ordered = sorted(rows, key=lambda r: (r.latency_cycles, r.energy_pj))
    frontier: List[SweepRow] = []
    best: Optional[Tuple[int, float]] = None    # last frontier (lat, pj)
    for r in ordered:
        cost = (r.latency_cycles, r.energy_pj)
        if best is None or r.energy_pj < best[1] or cost == best:
            frontier.append(r)
            best = cost
    return frontier


def dominates(a: SweepRow, b: SweepRow) -> bool:
    """True if ``a`` Pareto-dominates ``b`` on (latency, energy)."""
    return (a.latency_cycles <= b.latency_cycles
            and a.energy_pj <= b.energy_pj
            and (a.latency_cycles < b.latency_cycles
                 or a.energy_pj < b.energy_pj))


def utilization_knee(rows: Sequence[SweepRow],
                     tolerance: float = 0.10) -> Optional[SweepRow]:
    """The ROADMAP's per-model utilization knee: the *smallest* design
    point (fewest total macros, ties broken by lower energy) whose latency
    is within ``tolerance`` of the best latency any point achieves —
    i.e. where adding macro groups stops buying speed and only dilutes
    utilization.  Returns None for an empty row set."""
    if not rows:
        return None
    best = min(r.latency_cycles for r in rows)
    eligible = [r for r in rows
                if r.latency_cycles <= (1.0 + tolerance) * best]
    return min(eligible, key=lambda r: (r.num_macros, r.energy_pj))


@dataclasses.dataclass
class SweepResult:
    """All rows of one sweep plus the derived artifacts."""

    rows: List[SweepRow]
    skipped: List[Dict[str, object]]
    energy_model: str
    knee_tolerance: float = 0.10
    # Simulation-cache counters for this sweep (DESIGN.md §16): hits /
    # misses / disk_hits / stores, merged across parallel workers.
    # Empty when the sweep ran uncached.
    cache_stats: Dict[str, int] = dataclasses.field(default_factory=dict)

    def models(self) -> List[str]:
        seen: List[str] = []
        for r in self.rows:
            if r.model not in seen:
                seen.append(r.model)
        return seen

    def groups(self) -> List[Tuple[str, int]]:
        """The comparison units: (model, seq_len) pairs in row order.
        Frontier and knee extraction never mix shapes — the same design
        point at a shorter sequence would spuriously 'dominate' its
        longer-sequence twin, exactly like mixing models would."""
        seen: List[Tuple[str, int]] = []
        for r in self.rows:
            key = (r.model, r.seq_len)
            if key not in seen:
                seen.append(key)
        return seen

    def calibrations(self) -> List[str]:
        """Distinct calibration labels in row order (``["analytic"]``
        for an uncalibrated sweep).  A third partition key next to model
        and shape: calibrated latencies are scaled by fitted factors, so
        letting an analytic row 'dominate' a calibrated one would be as
        meaningless as mixing shapes."""
        seen: List[str] = []
        for r in self.rows:
            if r.calibration not in seen:
                seen.append(r.calibration)
        return seen

    def energy_models(self) -> List[str]:
        """Distinct energy-model labels in row order.  The fourth
        partition key (ROADMAP: ENERGY_CONFIGS x HW grid): energy_pj
        values under different pJ-cost tables are not comparable, so
        frontier/knee extraction never mixes them."""
        seen: List[str] = []
        for r in self.rows:
            if r.energy_model not in seen:
                seen.append(r.energy_model)
        return seen

    def _cells(self) -> List[Tuple[str, int, str, str]]:
        """(model, seq_len, calibration, energy_model) cells with rows."""
        cals = self.calibrations()
        ems = self.energy_models()
        return [(m, s, c, e) for m, s in self.groups() for c in cals
                for e in ems
                if any(r.model == m and r.seq_len == s
                       and r.calibration == c and r.energy_model == e
                       for r in self.rows)]

    def label(self, model: str, seq_len: int,
              calibration: Optional[str] = None,
              energy_model: Optional[str] = None) -> str:
        """Group label for reports: just the model name when one shape
        was swept, ``model@seqN`` when several disambiguate, a
        ``+calibration`` suffix when the sweep ran a calibration axis,
        and a ``/energy-model`` suffix when it ran the energy axis."""
        multi = len({s for m, s in self.groups() if m == model}) > 1
        lbl = f"{model}@seq{seq_len}" if multi else model
        if calibration is not None and len(self.calibrations()) > 1:
            lbl += f"+{calibration}"
        if energy_model is not None and len(self.energy_models()) > 1:
            lbl += f"/{energy_model}"
        return lbl

    def rows_for(self, model: str, seq_len: Optional[int] = None,
                 calibration: Optional[str] = None,
                 energy_model: Optional[str] = None) -> List[SweepRow]:
        return [r for r in self.rows if r.model == model
                and (seq_len is None or r.seq_len == seq_len)
                and (calibration is None or r.calibration == calibration)
                and (energy_model is None
                     or r.energy_model == energy_model)]

    def pareto(self, model: Optional[str] = None,
               seq_len: Optional[int] = None,
               calibration: Optional[str] = None,
               energy_model: Optional[str] = None) -> List[SweepRow]:
        """Latency/energy frontier, computed per (model, seq_len,
        calibration, energy_model) cell and concatenated in cell order
        over whatever arguments are left unfixed."""
        out: List[SweepRow] = []
        for m, s, c, e in self._cells():
            if (model is None or m == model) \
                    and (seq_len is None or s == seq_len) \
                    and (calibration is None or c == calibration) \
                    and (energy_model is None or e == energy_model):
                out.extend(pareto_frontier(self.rows_for(m, s, c, e)))
        return out

    def knees(self) -> Dict[str, SweepRow]:
        out: Dict[str, SweepRow] = {}
        for m, s, c, e in self._cells():
            knee = utilization_knee(self.rows_for(m, s, c, e),
                                    self.knee_tolerance)
            if knee is not None:
                out[self.label(m, s, c, e)] = knee
        return out

    def frontier_sensitivity(self) -> Dict[str, Dict[str, object]]:
        """How sensitive the Pareto frontier is to the energy cost table
        (the ROADMAP's ENERGY_CONFIGS x HW question): per (model, shape,
        calibration) group, the frontier's design-point names under each
        energy model, the Jaccard overlap of each against the base
        (first-swept) model's frontier, and the designs stable across
        *every* cost table.  Empty when only one energy model was swept
        (nothing to compare)."""
        ems = self.energy_models()
        if len(ems) < 2:
            return {}
        base = ems[0]
        out: Dict[str, Dict[str, object]] = {}
        for m, s in self.groups():
            for c in self.calibrations():
                fronts = {e: sorted({r.hw for r in pareto_frontier(
                    self.rows_for(m, s, c, e))}) for e in ems
                    if self.rows_for(m, s, c, e)}
                if len(fronts) < 2 or base not in fronts:
                    continue
                bset = set(fronts[base])
                jac = {}
                for e, hws in fronts.items():
                    u = bset | set(hws)
                    jac[e] = (len(bset & set(hws)) / len(u)) if u else 1.0
                stable = sorted(set.intersection(
                    *[set(h) for h in fronts.values()]))
                out[self.label(m, s, c)] = {
                    "base": base,
                    "frontier_hw": fronts,
                    "jaccard_vs_base": jac,
                    "stable_hw": stable,
                }
        return out

    def to_dict(self, intern_plans: bool = True) -> Dict[str, object]:
        # Frontier members ARE entries of self.rows: index by identity
        # (value-equality .index() would deep-compare plan JSON, O(rows^2)).
        index_of = {id(r): i for i, r in enumerate(self.rows)}
        pareto_ids = {self.label(m, s, c, e):
                      [index_of[id(r)]
                       for r in pareto_frontier(self.rows_for(m, s, c, e))]
                      for m, s, c, e in self._cells()}
        row_dicts = [r.to_dict() for r in self.rows]
        plan_table: Dict[str, str] = {}
        if intern_plans:
            # Store-by-hash: the energy axis emits one row per cost table
            # per simulated point, all sharing one plan — serializing the
            # plan JSON once per *distinct plan* (rows carry a
            # ``plan_ref`` into ``plan_table``) shrinks the artifact by
            # the axis multiplicity.  ``resolve_plan_json`` rehydrates.
            for rd in row_dicts:
                pj = rd.pop("plan_json")
                ref = hashlib.sha256(pj.encode()).hexdigest()[:16]
                plan_table.setdefault(ref, pj)
                rd["plan_ref"] = ref
        d = {
            "energy_model": self.energy_model,
            "energy_models": self.energy_models(),
            "num_rows": len(self.rows),
            "calibrations": self.calibrations(),
            "rows": row_dicts,
            "skipped": list(self.skipped),
            "pareto": pareto_ids,  # row indices, per (model, shape, cal, em)
            "knees": {m: r.to_dict() for m, r in self.knees().items()},
            "knee_tolerance": self.knee_tolerance,
            "frontier_sensitivity": self.frontier_sensitivity(),
            "cache_stats": dict(self.cache_stats),
        }
        if intern_plans:
            d["plan_table"] = plan_table
        return d


# ---------------------------------------------------------------------------
# The sweep driver
# ---------------------------------------------------------------------------

def calibration_label(calibration) -> str:
    """Row label for a ``simulate_point(calibration=...)`` argument:
    ``"analytic"`` for None (uncalibrated timing), the report's name for
    a ``CalibrationReport``, or a content-derived ``custom:ATTNx2-...``
    label for a raw scale mapping — two *different* ad-hoc scalings must
    never collapse into one frontier cell."""
    if calibration is None:
        return "analytic"
    name = getattr(calibration, "name", None)
    if name is not None:
        return name
    return "custom:" + "-".join(f"{r}x{s:g}"
                                for r, s in sorted(calibration.items()))


def resolve_plan_json(artifact: Mapping[str, object],
                      row: Mapping[str, object]) -> str:
    """Rehydrate a row's plan JSON from a ``SweepResult.to_dict()``
    artifact: interned artifacts carry ``plan_ref`` into the top-level
    ``plan_table`` side table; un-interned rows carry ``plan_json``
    inline.  Raises ``KeyError`` on a dangling reference."""
    if "plan_json" in row:
        return row["plan_json"]
    return artifact["plan_table"][row["plan_ref"]]


def _evaluate_point(cfg, hw: HardwareConfig, seq_len: int,
                    energy_models: Sequence[EnergyModel],
                    calibration=None,
                    cache: Optional[SimCache] = None,
                    stamp: bool = True,
                    ) -> Tuple[List[SweepRow], Optional[CachedPoint]]:
    """One (model config, design point, shape) evaluation through the
    canonical path — ``plan_model`` -> ``simulate_plan`` -> energy fold —
    returning one row per energy model plus the cacheable summary record
    (None when uncached).  The simulation runs *once*; the energy axis is
    a pure re-fold of the same trace under each pJ-cost table
    (latency/bytes are cost-table-invariant by construction).

    ``stamp=False`` skips the ``bottleneck``/``headroom`` attribution
    stamps — the what-if headroom replays the trace DAG once per
    resource, which is comparable in cost to the simulation itself, so
    the successive-halving search's cheap rungs opt out (their rows are
    ranking fodder, not frontier artifacts).  Cache entries are
    namespaced by that choice (``evaluator="proxy"``) so an unstamped
    record never satisfies a full-fidelity lookup."""
    from repro_torch.plan.planner import plan_model
    from repro_torch.sim.pipeline import simulate_plan
    from repro_torch.sim.replay import resolve_calibration
    plan = plan_model(cfg, hw=hw, seq_len=seq_len)
    plan_json = plan.to_json()
    scale = resolve_calibration(calibration)
    label = calibration_label(calibration)
    scale_d = dict(scale) if scale else {}
    hw_params = dataclasses.asdict(hw)
    em_fps = [energy_fingerprint(em) for em in energy_models]

    def rows_of(cycles, hbm_bytes, util, folds, bottleneck, hroom):
        return [SweepRow(
            model=cfg.name, seq_len=seq_len, hw=hw.name,
            hw_params=hw_params, energy_model=em.name,
            latency_cycles=cycles, hbm_bytes=hbm_bytes,
            energy_pj=fold["total_pj"], edp=fold["edp"],
            utilization=dict(util),
            energy_by_resource=dict(fold["by_resource"]),
            plan_json=plan_json, calibration=label,
            calibration_scale=scale_d, bottleneck=bottleneck,
            headroom=dict(hroom))
            for em, fold in zip(energy_models, folds)]

    key = None
    if cache is not None:
        key = sim_cache_key(plan_json, hw, scale,
                            evaluator="point" if stamp else "proxy")
        hit = cache.lookup(key, em_fps)
        if hit is not None:
            return rows_of(hit.cycles, hit.hbm_bytes, hit.utilization,
                           [hit.energy[fp] for fp in em_fps],
                           hit.bottleneck, hit.headroom), hit

    res = simulate_plan(plan, hw=hw, calibration=calibration)
    bottleneck, hroom = "", {}
    if stamp:
        from repro_torch.obs.attribution import bottleneck_of
        from repro_torch.obs.whatif import headroom as causal_headroom
        bottleneck = bottleneck_of(res.trace)
        hroom = causal_headroom(res.trace)
    folds = []
    for em in energy_models:
        rep = res.energy(em)
        folds.append({"name": em.name, "total_pj": rep.total_pj,
                      "edp": rep.edp, "by_resource": dict(rep.by_resource)})
    record = None
    if cache is not None:
        record = CachedPoint(
            key=key, cycles=res.cycles, hbm_bytes=res.hbm_bytes,
            utilization=res.trace.utilizations(), bottleneck=bottleneck,
            headroom=hroom, energy=dict(zip(em_fps, folds)),
            info={"model": cfg.name, "seq_len": seq_len, "hw": hw.name,
                  "calibration": label})
        cache.store(record)
    return rows_of(res.cycles, res.hbm_bytes, res.trace.utilizations(),
                   folds, bottleneck, hroom), record


def _point_rows(cfg, hw: HardwareConfig, seq_len: int,
                energy_models: Sequence[EnergyModel],
                calibration=None, cache: Optional[SimCache] = None,
                stamp: bool = True) -> List[SweepRow]:
    """Back-compat row-only wrapper over ``_evaluate_point``."""
    return _evaluate_point(cfg, hw, seq_len, energy_models,
                           calibration=calibration, cache=cache,
                           stamp=stamp)[0]


def simulate_point(cfg, hw: HardwareConfig, seq_len: int = 0,
                   energy_model: Optional[EnergyModel] = None,
                   calibration=None) -> SweepRow:
    """One (model config, design point, shape) evaluation through the
    canonical path: ``plan_model`` -> ``simulate_plan`` -> energy fold.
    ``calibration`` (a ``repro_torch.sim.replay.CalibrationReport`` or raw
    resource->factor mapping) scales the analytic timing by the fitted
    per-resource factors — the trace-calibrated sweep axis (DESIGN.md
    §10)."""
    em = energy_model or STREAMDCIM_ENERGY_BASE
    return _point_rows(cfg, hw, seq_len, [em], calibration)[0]


#: Worker-process cache instances, one per on-disk store path (or the
#: ``None`` key for a process-local memo) — reused across the tasks a
#: pool worker serves so intra-worker hits don't re-open the store.
_WORKER_CACHES: Dict[Optional[str], SimCache] = {}


def _sweep_worker(task):
    """Evaluate one sweep task in a pool worker.  Module-level (pickled
    by reference), resolves the model config from the registry by name,
    and binds a worker-local ``SimCache`` to the shared disk path so
    parallel workers warm the same store the serial path reads.  Returns
    ``(rows, CachedPoint|None, stats_delta)`` — the parent adopts the
    record into its own cache and merges the stat delta, keeping
    ``SweepResult.cache_stats`` identical in meaning to a serial run."""
    name, seq, cal, hw, ems, stamp, cache_path, want_record = task
    from repro_torch.configs import registry
    cfg = registry.get_config(name)
    cache = None
    if want_record:
        cache = _WORKER_CACHES.get(cache_path)
        if cache is None:
            cache = SimCache(cache_path)
            _WORKER_CACHES[cache_path] = cache
    before = dict(cache.stats) if cache is not None else {}
    rows, record = _evaluate_point(cfg, hw, seq, list(ems),
                                   calibration=cal, cache=cache,
                                   stamp=stamp)
    delta = ({k: v - before.get(k, 0) for k, v in cache.stats.items()}
             if cache is not None else {})
    return rows, record, delta


def run_sweep(models: Optional[Sequence[str]] = None,
              base: Optional[HardwareConfig] = None,
              axes: Axes = DEFAULT_AXES,
              points: Optional[int] = None,
              seq_lens: Sequence[int] = (0,),
              energy_model: Optional[EnergyModel] = None,
              energy_models: Optional[Sequence[EnergyModel]] = None,
              include_presets: bool = True,
              knee_tolerance: float = 0.10,
              calibrations: Sequence[object] = (None,),
              progress=None,
              workers: Optional[int] = None,
              cache=None,
              stamp: bool = True,
              hw_points: Optional[Sequence[HardwareConfig]] = None,
              ) -> SweepResult:
    """Run the grid.  ``models`` are registry arch names (default: the
    simulator-supported pool); ``points`` caps the number of *design
    points* (the per-model row count follows), presets first so a small
    budget still sweeps the named configs.

    ``calibrations`` is the trace-calibration axis (DESIGN.md §10): each
    entry — None for the uncalibrated analytic model, or a
    ``repro_torch.sim.replay.CalibrationReport`` / raw resource->factor
    mapping — sweeps the whole grid once, labeled on the rows; frontier
    and knee extraction never mix calibrations.

    ``energy_models`` is the cost-table axis (ROADMAP: ENERGY_CONFIGS x
    HW grid): each ``EnergyModel`` re-folds every simulated point's trace
    (the simulation itself runs once per point — latency is
    cost-table-invariant), yielding per-table frontiers and the
    ``SweepResult.frontier_sensitivity()`` report.  The scalar
    ``energy_model`` remains the single-table entry point.

    Fast-DSE knobs (DESIGN.md §16):

    * ``workers=N`` fans the evaluations out over a process pool.  The
      task list is built first in the exact serial nesting order (model
      -> shape -> calibration -> design point) and ``executor.map``
      preserves input order, so rows, skipped records, and ``progress``
      callbacks are byte-identical to a serial sweep — parallelism is a
      wall-clock optimization, never a semantic one.
    * ``cache`` memoizes the simulate->fold->stamp suffix: None (off), a
      ``SimCache``, or a directory path for the on-disk warm-start
      store.  ``SweepResult.cache_stats`` reports this sweep's
      hits/misses (deltas, even on a pre-warmed cache object).
    * ``stamp=False`` skips the bottleneck/headroom stamps (search
      proxy rungs); ``hw_points`` bypasses grid materialization with an
      explicit design-point list (the search's survivor sets)."""
    from repro_torch.configs import registry
    ems = (list(energy_models) if energy_models
           else [energy_model or STREAMDCIM_ENERGY_BASE])
    model_names = list(models) if models else list(registry.SIM_ARCHS)
    if hw_points is not None:
        pts, skipped = list(hw_points), []
    else:
        presets = (tuple(registry.HW_CONFIGS.values())
                   if include_presets else ())
        pts, skipped = grid_points(base, axes, presets)
    if points is not None:
        pts = pts[:max(points, 0)]
    sim_cache = resolve_cache(cache)
    before = dict(sim_cache.stats) if sim_cache is not None else {}
    # Deterministic task order == the serial nesting order; every
    # execution strategy below walks this list in order.
    tasks = [(name, seq, cal, hw)
             for name in model_names
             for seq in seq_lens
             for cal in calibrations
             for hw in pts]
    rows: List[SweepRow] = []
    if workers and workers > 1 and len(tasks) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        ctx = (mp.get_context("fork")
               if "fork" in mp.get_all_start_methods()
               else mp.get_context())
        payload = [(name, seq, cal, hw, tuple(ems), stamp,
                    sim_cache.path if sim_cache is not None else None,
                    sim_cache is not None)
                   for name, seq, cal, hw in tasks]
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=ctx) as ex:
            for pt_rows, record, delta in ex.map(_sweep_worker, payload,
                                                 chunksize=1):
                rows.extend(pt_rows)
                if sim_cache is not None:
                    if record is not None:
                        sim_cache.adopt(record)
                    sim_cache.merge_stats(delta)
                if progress is not None:
                    # one call per *simulated point* — the energy axis
                    # re-folds the same trace, no extra work
                    progress(pt_rows[0])
    else:
        for name, seq, cal, hw in tasks:
            cfg = registry.get_config(name)
            pt_rows, _ = _evaluate_point(cfg, hw, seq, ems,
                                         calibration=cal, cache=sim_cache,
                                         stamp=stamp)
            rows.extend(pt_rows)
            if progress is not None:
                progress(pt_rows[0])
    stats = ({k: v - before.get(k, 0)
              for k, v in sim_cache.stats.items()}
             if sim_cache is not None else {})
    return SweepResult(rows=rows, skipped=skipped, energy_model=ems[0].name,
                       knee_tolerance=knee_tolerance, cache_stats=stats)
