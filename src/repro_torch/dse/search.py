"""Successive-halving frontier search over ``HardwareConfig`` space
(copy of ``repro/dse/search.py``, pure Python; DESIGN.md §16).

The grid sweep pays full-fidelity simulation for every design point; at
CIMFlow scale (ROADMAP item 4) that caps exploration at ~dozens of
points.  Successive halving spends the budget where it matters: early
rungs rank every candidate with a *cheap proxy* — the same canonical
``plan_model -> simulate_plan`` path, but at a reduced sequence length
and without the expensive ``bottleneck``/``headroom`` what-if stamps —
and only the survivors graduate to the next fidelity rung.  The final
rung re-evaluates survivors through the unmodified grid path
(``run_sweep(stamp=True)`` at the target shape), so every emitted
``SweepRow`` is exactly what the exhaustive grid would have produced for
that point: same replayable plan JSON, same frontier/knee extraction,
same attribution stamps.

Rung schedule: with ``N`` candidates, ``eta`` halving rate and ``R``
rungs, rung ``r`` evaluates ``ceil(N / eta**r)`` candidates at sequence
fidelity ``max(min_seq, target // eta**(R-1-r))`` (per model — the
target resolves each family's paper-typical default when ``seq_len=0``).
Survivor selection is frontier-safe by construction: every point on any
proxy rung's per-cell (model x calibration x energy-table) Pareto
frontier survives unconditionally; the remaining quota fills by
Pareto-peel rank (rank 0 = frontier, peel, rank 1, ...) minimized across
cells, ties broken by candidate order.  Determinism: no RNG anywhere
except ``sample_space``'s seeded candidate draw; identical inputs yield
identical rungs, survivors, and rows.

Proxy evaluations share the simulation cache under the ``"proxy"``
evaluator namespace (a stamp-less record must never satisfy a
full-fidelity lookup), so repeated searches — and the search's own
re-visits — warm-start from disk like the grid path does.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.hardware import HardwareConfig
from repro_torch.dse.sweep import (Axes, DEFAULT_AXES, SweepResult, SweepRow,
                                   grid_points, pareto_frontier, run_sweep)
from repro_torch.sim.energy import EnergyModel, STREAMDCIM_ENERGY_BASE


def sample_space(n: Optional[int] = None,
                 base: Optional[HardwareConfig] = None,
                 axes: Axes = DEFAULT_AXES,
                 include_presets: bool = True,
                 seed: int = 0,
                 ) -> Tuple[List[HardwareConfig], List[Dict[str, object]]]:
    """Materialize the candidate space: the validated grid (presets
    first, like ``grid_points``), deterministically subsampled to ``n``
    points with a seeded draw when the grid is larger.  Presets are
    always kept — a budget draw never drops the named designs."""
    from repro_torch.configs import registry
    presets = (tuple(registry.HW_CONFIGS.values())
               if include_presets else ())
    points, skipped = grid_points(base, axes, presets)
    if n is None or n >= len(points):
        return points, skipped
    n = max(n, 0)
    head = points[:min(len(presets), n)]
    tail = points[len(head):]
    picked = sorted(random.Random(seed).sample(range(len(tail)),
                                               n - len(head)))
    return head + [tail[i] for i in picked], skipped


@dataclasses.dataclass
class RungRecord:
    """One rung's ledger: who was evaluated at what fidelity, who
    survived, and what the cache saved."""

    rung: int
    proxy: bool                       # False only for the final rung
    seq_lens: Dict[str, int]          # model -> evaluated seq fidelity
    candidates: List[str]             # hw names entering this rung
    survivors: List[str]              # hw names leaving this rung
    quota: int
    frontier_protected: List[str]     # rung-frontier union (always kept)
    cache_stats: Dict[str, int]

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SearchResult:
    """Final full-fidelity sweep over the surviving candidates plus the
    per-rung elimination ledger."""

    sweep: SweepResult
    rungs: List[RungRecord]
    space_size: int
    eta: int
    proxy_sims: int                   # simulated points on proxy rungs
    full_sims: int                    # simulated points at full fidelity

    def to_dict(self) -> Dict[str, object]:
        d = self.sweep.to_dict()
        d["search"] = {
            "space_size": self.space_size,
            "eta": self.eta,
            "num_rungs": len(self.rungs),
            "proxy_sims": self.proxy_sims,
            "full_sims": self.full_sims,
            "rungs": [r.to_dict() for r in self.rungs],
        }
        return d


def _resolved_target_seq(cfg, seq_len: int) -> int:
    """The numeric shape a ``seq_len=0`` sweep actually simulates (the
    workload builders' paper-typical defaults), so the proxy rung ladder
    divides a real number."""
    if seq_len:
        return seq_len
    from repro_torch.core.types import Family
    if cfg.family == Family.ENCDEC:
        return 448
    return 4096


def _peel_ranks(rows: Sequence[SweepRow]) -> Dict[str, int]:
    """Pareto-peel rank per design-point name within one frontier cell:
    rank 0 = on the frontier, remove it, rank 1 = next skyline, ..."""
    remaining = list(rows)
    ranks: Dict[str, int] = {}
    rank = 0
    while remaining:
        front = pareto_frontier(remaining)
        names = {r.hw for r in front}
        for nm in names:
            ranks.setdefault(nm, rank)
        remaining = [r for r in remaining if r.hw not in names]
        rank += 1
    return ranks


def successive_halving(models: Optional[Sequence[str]] = None,
                       base: Optional[HardwareConfig] = None,
                       axes: Axes = DEFAULT_AXES,
                       candidates: Optional[Sequence[HardwareConfig]] = None,
                       num_candidates: Optional[int] = None,
                       eta: int = 2,
                       rungs: Optional[int] = None,
                       seq_len: int = 0,
                       min_seq: int = 128,
                       energy_model: Optional[EnergyModel] = None,
                       energy_models: Optional[Sequence[EnergyModel]] = None,
                       include_presets: bool = True,
                       knee_tolerance: float = 0.10,
                       calibrations: Sequence[object] = (None,),
                       cache=None,
                       workers: Optional[int] = None,
                       seed: int = 0,
                       progress=None) -> SearchResult:
    """Run the rung schedule described in the module docstring and
    return the survivors' full-fidelity ``SweepResult`` plus the ledger.

    ``candidates`` bypasses space sampling with an explicit point list
    (the small-grid equivalence tests); otherwise ``sample_space``
    draws ``num_candidates`` from the ``axes`` grid.  ``cache`` /
    ``workers`` thread straight through to ``run_sweep``."""
    from repro_torch.configs import registry
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    ems = (list(energy_models) if energy_models
           else [energy_model or STREAMDCIM_ENERGY_BASE])
    model_names = list(models) if models else list(registry.SIM_ARCHS)
    if candidates is not None:
        pool, skipped = list(candidates), []
    else:
        pool, skipped = sample_space(num_candidates, base, axes,
                                     include_presets, seed)
    n = len(pool)
    if rungs is None:
        # Enough rungs that the final one simulates <= max(4, N/eta)
        # points, capped so the cheapest proxy stays a meaningful shape.
        rungs = 2 if n <= 16 else 3
    rungs = max(int(rungs), 1)
    by_name = {hw.name: hw for hw in pool}
    if len(by_name) != n:
        raise ValueError("candidate design-point names must be unique")
    cfgs = {m: registry.get_config(m) for m in model_names}
    targets = {m: _resolved_target_seq(cfgs[m], seq_len)
               for m in model_names}

    alive: List[str] = [hw.name for hw in pool]
    ledger: List[RungRecord] = []
    proxy_sims = 0
    for r in range(rungs - 1):
        quota = max(1, math.ceil(n / eta ** (r + 1)))
        if len(alive) <= quota:
            break
        div = eta ** (rungs - 1 - r)
        rung_seqs = {m: max(min_seq, targets[m] // div)
                     for m in model_names}
        hw_list = [by_name[nm] for nm in alive]
        # Per-model proxy sweep at that model's rung fidelity; stamp=False
        # skips the what-if headroom (ranking fodder, not artifacts).
        scores: Dict[str, int] = {}
        protected: List[str] = []
        rung_stats: Dict[str, int] = {}
        for m in model_names:
            res = run_sweep(models=[m], seq_lens=(rung_seqs[m],),
                            energy_models=ems, include_presets=False,
                            calibrations=calibrations, hw_points=hw_list,
                            cache=cache, workers=workers, stamp=False,
                            progress=progress)
            proxy_sims += len(hw_list) * len(calibrations)
            for k, v in res.cache_stats.items():
                rung_stats[k] = rung_stats.get(k, 0) + v
            for cell in res._cells():
                cell_rows = res.rows_for(cell[0], seq_len=cell[1],
                                         calibration=cell[2],
                                         energy_model=cell[3])
                ranks = _peel_ranks(cell_rows)
                for nm, rk in ranks.items():
                    scores[nm] = min(scores.get(nm, rk), rk)
                for row in pareto_frontier(cell_rows):
                    if row.hw not in protected:
                        protected.append(row.hw)
        # Frontier-safe survivor selection: rung-frontier union first,
        # then fill to quota by peel rank, ties by candidate order.
        survivors = [nm for nm in alive if nm in protected]
        if len(survivors) < quota:
            rest = sorted((nm for nm in alive if nm not in protected),
                          key=lambda nm: (scores.get(nm, n), alive.index(nm)))
            survivors += rest[:quota - len(survivors)]
        survivors = [nm for nm in alive if nm in survivors]  # stable order
        ledger.append(RungRecord(
            rung=r, proxy=True, seq_lens=dict(rung_seqs),
            candidates=list(alive), survivors=list(survivors),
            quota=quota, frontier_protected=list(protected),
            cache_stats=rung_stats))
        alive = survivors

    final_hw = [by_name[nm] for nm in alive]
    sweep = run_sweep(models=model_names, seq_lens=(seq_len,),
                      energy_models=ems, include_presets=False,
                      knee_tolerance=knee_tolerance,
                      calibrations=calibrations, hw_points=final_hw,
                      cache=cache, workers=workers, stamp=True,
                      progress=progress)
    sweep.skipped = list(skipped)
    ledger.append(RungRecord(
        rung=len(ledger), proxy=False,
        seq_lens={m: targets[m] if seq_len == 0 else seq_len
                  for m in model_names},
        candidates=list(alive), survivors=list(alive),
        quota=len(alive), frontier_protected=[],
        cache_stats=dict(sweep.cache_stats)))
    return SearchResult(sweep=sweep, rungs=ledger, space_size=n, eta=eta,
                        proxy_sims=proxy_sims,
                        full_sims=(len(final_hw) * len(model_names)
                                   * len(calibrations)))
