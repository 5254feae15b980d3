"""CLI for ``repro_torch.dse``: ``PYTHONPATH=src python -m repro_torch.dse``
(copy of ``repro/dse/__main__.py``; it simulates on the host and touches
no card).

Prints a per-model sweep table (design point, latency, energy, EDP, macro
utilization; Pareto members starred, the utilization knee marked) and
optionally writes the full machine-readable sweep — rows with serialized
plans, frontier indices, knees — with ``--json``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.dse.sweep import DEFAULT_AXES, run_sweep
from repro_torch.sim.energy import ENERGY_PRESETS


def format_table(result, model: str, seq_len: int, knees=None,
                 calibration: str = None,
                 energy_model: str = None) -> str:
    knees = result.knees() if knees is None else knees
    rows = result.rows_for(model, seq_len, calibration, energy_model)
    frontier = set(id(r) for r in result.pareto(model, seq_len, calibration,
                                               energy_model))
    knee = knees.get(result.label(model, seq_len, calibration, energy_model))
    lines = [f"== {result.label(model, seq_len, calibration, energy_model)} "
             f"({len(rows)} points, "
             f"energy model {energy_model or result.energy_model}) ==",
             f"{'':2s}{'design point':<42s} {'cycles':>12s} {'energy(uJ)':>11s} "
             f"{'EDP':>10s} {'utilGEN':>8s} {'utilATTN':>9s}"]
    for r in sorted(rows, key=lambda r: r.latency_cycles):
        mark = "*" if id(r) in frontier else " "
        mark += "K" if knee is not None and r is knee else " "
        lines.append(
            f"{mark:2s}{r.hw:<42.42s} {r.latency_cycles:>12d} "
            f"{r.energy_pj / 1e6:>11.1f} {r.edp:>10.2e} "
            f"{r.utilization.get('GEN', 0.0):>8.2f} "
            f"{r.utilization.get('ATTN', 0.0):>9.2f}")
    if knee is not None:
        lines.append(f"   knee: {knee.hw} ({knee.num_macros} macros, "
                     f"within {result.knee_tolerance:.0%} of best latency)")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse",
        description="StreamDCIM design-space exploration sweep")
    ap.add_argument("--models", nargs="*", default=None,
                    help="registry arch names (default: simulator pool)")
    ap.add_argument("--points", type=int, default=None,
                    help="design-point budget (presets first; CI smoke)")
    ap.add_argument("--seq", type=int, nargs="*", default=[0],
                    help="sequence lengths (0 = model default)")
    ap.add_argument("--energy", default="streamdcim-energy-base",
                    choices=sorted(ENERGY_PRESETS),
                    help="energy model preset")
    ap.add_argument("--energy-axis", action="store_true",
                    help="sweep EVERY energy preset as a joint axis with "
                         "the hardware grid and report frontier "
                         "sensitivity to the cost table (ROADMAP)")
    ap.add_argument("--calibration", metavar="PATH", default=None,
                    help="CalibrationReport JSON (repro_torch.sim.replay) — "
                         "sweeps the analytic AND the trace-calibrated "
                         "timing as a second axis (DESIGN.md §10)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full sweep artifact (rows + plans + "
                         "pareto + knees)")
    ap.add_argument("--workers", type=int, default=None,
                    help="process-pool width for the sweep (rows stay "
                         "byte-identical to serial; DESIGN.md §16)")
    ap.add_argument("--cache", metavar="DIR", default=None,
                    help="on-disk simulation cache directory — re-runs "
                         "warm-start from it (DESIGN.md §16)")
    ap.add_argument("--search", action="store_true",
                    help="successive-halving frontier search instead of "
                         "the exhaustive grid: cheap low-seq rungs rank "
                         "candidates, survivors graduate to full "
                         "fidelity (DESIGN.md §16)")
    ap.add_argument("--search-candidates", type=int, default=None,
                    help="candidate budget drawn from the grid for "
                         "--search (default: the whole grid)")
    ap.add_argument("--search-eta", type=int, default=2,
                    help="halving rate between rungs (default 2)")
    ap.add_argument("--search-rungs", type=int, default=None,
                    help="rung count (default: 2 for <=16 candidates, "
                         "else 3)")
    args = ap.parse_args(argv)

    calibrations = (None,)
    if args.calibration:
        from repro_torch.sim.replay import CalibrationReport
        with open(args.calibration) as f:
            calibrations = (None, CalibrationReport.from_json(f.read()))

    done = [0]

    def progress(row):
        done[0] += 1
        print(f"\r  {done[0]} points simulated", end="", file=sys.stderr)

    energy_models = None
    if args.energy_axis:
        # --energy stays the *base* table (leads the axis: ordering and
        # frontier_sensitivity compare the other presets against it).
        base = ENERGY_PRESETS[args.energy]
        energy_models = [base] + [e for e in ENERGY_PRESETS.values()
                                  if e.name != base.name]
    search = None
    if args.search:
        from repro_torch.dse.search import successive_halving
        search = successive_halving(
            models=args.models, axes=DEFAULT_AXES,
            num_candidates=args.search_candidates,
            eta=args.search_eta, rungs=args.search_rungs,
            seq_len=args.seq[0],
            energy_model=ENERGY_PRESETS[args.energy],
            energy_models=energy_models, calibrations=calibrations,
            cache=args.cache, workers=args.workers, progress=progress)
        result = search.sweep
    else:
        result = run_sweep(models=args.models, axes=DEFAULT_AXES,
                           points=args.points, seq_lens=args.seq,
                           energy_model=ENERGY_PRESETS[args.energy],
                           energy_models=energy_models,
                           calibrations=calibrations, progress=progress,
                           workers=args.workers, cache=args.cache)
    print(file=sys.stderr)
    knees = result.knees()
    for model, seq_len in result.groups():
        for cal in result.calibrations():
            for em in result.energy_models():
                print(format_table(result, model, seq_len, knees=knees,
                                   calibration=cal, energy_model=em))
                print()
    sens = result.frontier_sensitivity()
    for label, rec in sens.items():
        print(f"== {label}: frontier sensitivity to the cost table ==")
        for em, j in rec["jaccard_vs_base"].items():
            print(f"   {em:<28s} jaccard vs {rec['base']}: {j:.2f} "
                  f"({len(rec['frontier_hw'][em])} frontier designs)")
        print(f"   stable across all tables: {rec['stable_hw']}")
    if search is not None:
        print(f"== successive-halving search: {search.space_size} "
              f"candidates, eta={search.eta} ==")
        for rec in search.rungs:
            kind = "proxy" if rec.proxy else "full"
            print(f"   rung {rec.rung} ({kind}): "
                  f"{len(rec.candidates)} -> {len(rec.survivors)} "
                  f"(quota {rec.quota}, seq {sorted(set(rec.seq_lens.values()))})")
        print(f"   proxy sims {search.proxy_sims}, "
              f"full sims {search.full_sims}")
    if result.cache_stats:
        print(f"# cache: {result.cache_stats}")
    if result.skipped:
        print(f"# {len(result.skipped)} invalid grid combinations skipped")
    if args.json:
        art = search.to_dict() if search is not None else result.to_dict()
        with open(args.json, "w") as f:
            json.dump(art, f, indent=2)
        print(f"# sweep artifact -> {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
