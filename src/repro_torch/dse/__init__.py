"""``repro_torch.dse`` — energy-aware design-space exploration
(counterpart of ``repro/dse/__init__.py``, DESIGN.md §9).

StreamDCIM's §IV evaluation is one hand-picked design point; the
architectural claim (tile-based reconfigurable macros + mixed-stationary
dataflow + ping-pong rewriting) is about *the space* of design points.
This package sweeps that space: a grid over ``HardwareConfig`` fields
(``num_groups``/``gen_groups`` splits, ``rewrite_bus_bits``,
``ping_pong``, any field via ``Axes.extra``) x registry models x shapes,
each point run through the canonical ``plan_model -> simulate_plan`` path
and scored with ``repro_torch.sim.energy``.

Artifacts per sweep:

* ``SweepRow``      — latency, HBM bytes, total/per-resource energy, EDP,
                      per-resource utilization, and the serialized
                      ``ExecutionPlan`` (replayable: JSON -> ``from_json``
                      -> ``simulate_plan`` reproduces the row exactly);
* Pareto frontier   — non-dominated (latency, energy) rows per model;
* utilization knee  — the smallest design point within 10% of the best
                      latency per model (ROADMAP §Simulator);
* cost-table axis   — ``run_sweep(energy_models=...)`` folds every
                      ``EnergyModel`` over each simulated point (one
                      simulation per point; energy re-folds) and
                      ``SweepResult.frontier_sensitivity()`` reports how
                      much of the frontier survives swapping the table
                      (``python -m repro_torch.dse --energy-axis``).

The scale-out axis (chips x topology x per-chip ``HardwareConfig``,
DESIGN.md §13) lives in ``repro_torch.shard.sweep`` and is re-exported here:
``run_shard_sweep`` rows carry speedup-vs-chips and scale-out-efficiency
columns next to the single-chip sweep's latency/energy ones
(``python -m repro_torch.shard``).

Entry point: ``python -m repro_torch.dse`` (``--json`` artifact,
``--points N`` budget for a smoke run; the JAX package's
``benchmarks/run.py dse`` has no counterpart in the port yet).
"""
from repro_torch.dse.cache import (CachedPoint, SimCache, energy_fingerprint,
                                   hw_fingerprint, sim_cache_key)
from repro_torch.dse.sweep import (Axes, DEFAULT_AXES, SweepResult, SweepRow,
                                   calibration_label, dominates, grid_points,
                                   pareto_frontier, resolve_plan_json,
                                   run_sweep, simulate_point, utilization_knee)
from repro_torch.dse.search import (RungRecord, SearchResult, sample_space,
                                    successive_halving)
from repro_torch.shard.sweep import (ShardSweepResult, ShardSweepRow,
                                     run_shard_sweep)

__all__ = [
    "Axes", "CachedPoint", "DEFAULT_AXES", "RungRecord", "SearchResult",
    "SimCache", "SweepResult", "SweepRow", "calibration_label",
    "dominates", "energy_fingerprint", "grid_points", "hw_fingerprint",
    "pareto_frontier", "resolve_plan_json", "run_sweep", "sample_space",
    "ShardSweepResult", "ShardSweepRow", "run_shard_sweep", "sim_cache_key",
    "simulate_point", "successive_halving", "utilization_knee",
]
