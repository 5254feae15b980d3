"""``python -m repro_torch.obs`` — text utilization / stall report for a
saved plan artifact or an on-the-fly simulation (copy of
``repro/obs/__main__.py``, DESIGN.md §12).  It runs on the host only: the
simulator touches no card.

Usage::

    python -m repro_torch.obs plan.json                  # saved ExecutionPlan
    python -m repro_torch.obs --model vilbert-base --smoke --mode tile_stream
    python -m repro_torch.obs --rewrite-stall     # paper §I micro-workload
    python -m repro_torch.obs plan.json --perfetto out.json   # + Perfetto dump
    python -m repro_torch.obs plan.json --json           # attribution as JSON
    python -m repro_torch.obs plan.json --critpath       # causal critical path
    python -m repro_torch.obs plan.json --whatif ATTN:2 --whatif ping_pong

Stale artifacts are rejected: ``ExecutionPlan.from_json`` checks the
plan's ``version`` stamp and raises on mismatch.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.attribution import attribute, format_report
from repro_torch.obs.timeline import (timeline_from_sim, timeline_from_trace,
                                      validate_timeline, write_timeline)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Utilization / stall attribution report from a saved "
                    "ExecutionPlan artifact or an on-the-fly simulation.")
    p.add_argument("plan", nargs="?", default=None,
                   help="path to a saved ExecutionPlan JSON artifact")
    p.add_argument("--model", default=None,
                   help="simulate a registered model config instead of "
                        "loading a plan (e.g. vilbert-base)")
    p.add_argument("--smoke", action="store_true",
                   help="use the model's smoke-sized config")
    p.add_argument("--mode", default=None,
                   choices=["non_stream", "layer_stream", "tile_stream"],
                   help="force one execution mode (default: planner choice)")
    p.add_argument("--hw", default=None,
                   help="hardware preset name (default: plan's / base)")
    p.add_argument("--seq", type=int, default=0,
                   help="sequence length override for --model")
    p.add_argument("--rewrite-stall", action="store_true",
                   help="report the paper §I rewrite-stall micro-workload")
    p.add_argument("--ping-pong", action="store_true",
                   help="with --rewrite-stall: enable the shadow sub-array")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the attribution report as JSON")
    p.add_argument("--perfetto", metavar="OUT", default=None,
                   help="also write the Perfetto trace_event timeline here "
                        "(critical-path edges as flow events when "
                        "--critpath is also given)")
    p.add_argument("--critpath", action="store_true",
                   help="also report the causal critical path (on-path "
                        "resource/op-class shares, slack histogram)")
    p.add_argument("--whatif", metavar="RESOURCE:K", action="append",
                   default=[],
                   help="project a what-if scenario on the trace DAG "
                        "(repeatable): ATTN:2, HBM:4, INTERCONNECT:2, "
                        "or ping_pong to toggle the shadow sub-array")
    return p


def _simulate(args):
    """Resolve the CLI to one (SimResult-ish, title) pair."""
    from repro_torch.configs.registry import get_config, get_hw_config
    from repro_torch.core.types import ExecutionMode
    hw = get_hw_config(args.hw) if args.hw else None

    if args.rewrite_stall:
        from repro_torch.configs.hardware import STREAMDCIM_BASE
        from repro_torch.sim.pipeline import rewrite_stall_trace
        trace = rewrite_stall_trace(hw or STREAMDCIM_BASE,
                                    ping_pong=args.ping_pong)
        label = "ping-pong" if args.ping_pong else "serial"
        return None, trace, f"§I rewrite-stall micro-workload ({label})"

    from repro_torch.sim.pipeline import simulate_plan
    if args.plan:
        from repro_torch.plan.planner import ExecutionPlan
        with open(args.plan) as f:
            plan = ExecutionPlan.from_json(f.read())   # rejects stale version
        res = simulate_plan(plan, hw=hw)
        return res, res.trace, f"plan {args.plan} ({plan.model}@{plan.hw})"

    if args.model:
        from repro_torch.plan.planner import plan_model
        mode = ExecutionMode(args.mode) if args.mode else None
        plan = plan_model(get_config(args.model, smoke=args.smoke), hw=hw,
                          seq_len=args.seq, mode=mode,
                          force_mode=mode is not None)
        res = simulate_plan(plan, hw=hw)
        return res, res.trace, f"{args.model} ({plan.hw})"

    raise SystemExit("nothing to report: pass a plan artifact, --model, "
                     "or --rewrite-stall (see --help)")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    res, trace, title = _simulate(args)
    report = attribute(trace)
    crit = None
    if args.critpath:
        from repro_torch.obs.critpath import critical_path, format_critpath
        crit = critical_path(trace)
    projections = []
    if args.whatif:
        from repro_torch.obs.whatif import format_whatif, run_whatif
        projections = [run_whatif(trace, spec) for spec in args.whatif]
    if args.as_json:
        out = {"title": title, **report.to_dict()}
        if crit is not None:
            out["critical_path"] = crit.to_dict()
        if projections:
            out["whatif"] = [p.to_dict() for p in projections]
        print(json.dumps(out, indent=2))
    else:
        print(format_report(report, title=title))
        if crit is not None:
            print()
            print(format_critpath(crit, title=f"critical path — {title}"))
        if projections:
            print()
            print(format_whatif(projections, title=f"what-if — {title}"))
    if args.perfetto:
        tl = (timeline_from_sim(res, title=title,
                                critical_path=args.critpath)
              if res is not None
              else timeline_from_trace(trace, title=title,
                                       critical_path=args.critpath))
        validate_timeline(tl)
        write_timeline(tl, args.perfetto)
        print(f"\nperfetto timeline -> {args.perfetto} "
              f"(open at https://ui.perfetto.dev)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
