"""CLI for ``repro_torch.shard``:
``PYTHONPATH=src python -m repro_torch.shard`` (copy of
``repro/shard/__main__.py``; it simulates on the host and touches no
card).

Prints the scale-out table per (model, mode, topology) cell — chips,
resolved axis, latency, speedup, scale-out efficiency, collective bytes,
bottleneck — and optionally writes the machine-readable sweep (rows +
speedup-vs-chips curves, serialized sharded plans with ``--keep-plans``)
with ``--json``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.types import ExecutionMode
from repro_torch.shard.sweep import (DEFAULT_CHIPS, DEFAULT_MODELS,
                                     run_shard_sweep)


def format_table(result) -> str:
    cells = {}
    for r in result.rows:
        cells.setdefault(result.label(r), []).append(r)
    lines = []
    for label, rows in cells.items():
        lines.append(f"== {label} ({len(rows)} points) ==")
        lines.append(f"  {'chips':>5s} {'axis':<9s} {'cycles':>12s} "
                     f"{'speedup':>8s} {'eff':>6s} {'noc_bytes':>12s} "
                     f"{'bottleneck':<12s}")
        for r in sorted(rows, key=lambda r: r.chips):
            lines.append(
                f"  {r.chips:>5d} {r.axis:<9s} {r.latency_cycles:>12d} "
                f"{r.speedup:>8.2f} {r.efficiency:>6.2f} "
                f"{r.collective_bytes:>12d} {r.bottleneck:<12s}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.shard",
        description="StreamDCIM chiplet-mesh scale-out sweep")
    ap.add_argument("--models", default=",".join(DEFAULT_MODELS),
                    help="comma-separated registry model names")
    ap.add_argument("--chips", default=",".join(map(str, DEFAULT_CHIPS)),
                    help="comma-separated chip counts")
    ap.add_argument("--topologies", default="ring",
                    help="comma-separated: ring,line")
    ap.add_argument("--modes", default="",
                    help="comma-separated execution modes (default: all)")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="use the tiny smoke configs")
    ap.add_argument("--link-bytes", type=int, default=None,
                    help="NoC link bytes/cycle (MeshSpec default 128)")
    ap.add_argument("--hop-cycles", type=int, default=None,
                    help="NoC per-hop latency (MeshSpec default 32)")
    ap.add_argument("--keep-plans", action="store_true",
                    help="embed serialized ShardedPlans in --json rows")
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    mesh_kwargs = {}
    if args.link_bytes is not None:
        mesh_kwargs["link_bytes_per_cycle"] = args.link_bytes
    if args.hop_cycles is not None:
        mesh_kwargs["hop_cycles"] = args.hop_cycles
    modes = ([ExecutionMode(m) for m in args.modes.split(",") if m]
             or None)

    done = [0]

    def progress(row):
        done[0] += 1
        print(f"\r  {done[0]} points simulated", end="", file=sys.stderr)

    result = run_shard_sweep(
        [m for m in args.models.split(",") if m],
        chips=[int(c) for c in args.chips.split(",") if c],
        topologies=[t for t in args.topologies.split(",") if t],
        modes=modes, seq_len=args.seq, smoke=args.smoke,
        mesh_kwargs=mesh_kwargs, keep_plans=args.keep_plans,
        progress=progress)
    if done[0]:
        print(file=sys.stderr)
    print(format_table(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result.to_dict(), f, indent=1)
        print(f"wrote {args.json} ({len(result.rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
