"""Scale-out design-space exploration (DESIGN.md §13): the system-level
sweep CIMFlow argues for — chips x topology x per-chip ``HardwareConfig``
x model x mode, through plan -> shard -> simulate.

Every row records the sharded latency, the resolved axis, speedup vs the
1-chip cell and scale-out efficiency (speedup / chips), the bottleneck
resource (``obs.attribution.bottleneck_of`` — ``INTERCONNECT`` when the
NoC links dominate), and the serialized ``ShardedPlan`` so any row
replays standalone, same as ``repro_torch.dse`` rows.

Copy of ``repro/shard/sweep.py``, pure Python: the same code, its imports
pointed at the port's copies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import registry
from repro_torch.configs.hardware import HardwareConfig, STREAMDCIM_BASE
from repro_torch.core.types import ExecutionMode
from repro_torch.plan.planner import plan_model
from repro_torch.shard.noc import MeshSpec
from repro_torch.shard.partition import shard_plan
from repro_torch.shard.sim import simulate_sharded_plan

SHARD_SWEEP_VERSION = 1

DEFAULT_MODELS = ("vilbert-base", "qwen2-vl-2b")
DEFAULT_CHIPS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class ShardSweepRow:
    model: str
    seq_len: int
    mode: str
    hw: str
    topology: str
    chips: int
    axis: str
    latency_cycles: int
    hbm_bytes: int
    collective_bytes: int
    speedup: float              # vs the 1-chip cell (same model/mode/hw)
    efficiency: float           # speedup / chips
    bottleneck: str
    plan_json: Optional[Dict[str, object]] = None

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ShardSweepResult:
    rows: Tuple[ShardSweepRow, ...]

    def label(self, r: ShardSweepRow) -> str:
        return f"{r.model}/s{r.seq_len}/{r.mode}/{r.hw}/{r.topology}"

    def speedup_vs_chips(self) -> Dict[str, List[Tuple[int, float]]]:
        """The replayable scale-out curve: cell label -> sorted
        (chips, speedup) points."""
        out: Dict[str, List[Tuple[int, float]]] = {}
        for r in self.rows:
            out.setdefault(self.label(r), []).append((r.chips, r.speedup))
        for pts in out.values():
            pts.sort()
        return out

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema_version": SHARD_SWEEP_VERSION,
            "rows": [r.to_dict() for r in self.rows],
            "speedup_vs_chips": {
                k: [[c, s] for c, s in v]
                for k, v in self.speedup_vs_chips().items()},
        }


def run_shard_sweep(models: Sequence[str] = DEFAULT_MODELS, *,
                    chips: Sequence[int] = DEFAULT_CHIPS,
                    topologies: Sequence[str] = ("ring",),
                    hw_points: Sequence[HardwareConfig] = (STREAMDCIM_BASE,),
                    modes: Optional[Sequence[ExecutionMode]] = None,
                    seq_len: int = 512,
                    smoke: bool = False,
                    mesh_kwargs: Optional[Dict[str, object]] = None,
                    keep_plans: bool = False,
                    progress=None) -> ShardSweepResult:
    """Sweep the scale-out grid.  ``mesh_kwargs`` overrides ``MeshSpec``
    link parameters (bandwidth, hop latency, multicast chunking);
    ``keep_plans`` embeds each row's serialized ``ShardedPlan``.
    Speedups are computed against the 1-chip run of the same cell (one
    is simulated for the baseline even when 1 is not in ``chips``)."""
    modes = tuple(modes or ExecutionMode)
    mesh_kwargs = dict(mesh_kwargs or {})
    rows: List[ShardSweepRow] = []
    from repro_torch.obs.attribution import bottleneck_of
    for name in models:
        cfg = registry.get_config(name, smoke=smoke)
        for hw in hw_points:
            for mode in modes:
                plan = plan_model(cfg, hw=hw, seq_len=seq_len, mode=mode,
                                  force_mode=True)
                for topo in topologies:
                    base_cycles: Optional[int] = None
                    for c in sorted(set(chips) | {1}):
                        mesh = MeshSpec(chips=c, topology=topo,
                                        **mesh_kwargs)
                        splan = shard_plan(plan, mesh)
                        res = simulate_sharded_plan(splan, hw=hw)
                        if base_cycles is None:
                            base_cycles = res.cycles
                        if c not in chips:
                            continue
                        row = ShardSweepRow(
                            model=cfg.name, seq_len=plan.seq_len,
                            mode=mode.value, hw=hw.name, topology=topo,
                            chips=c, axis=splan.axis,
                            latency_cycles=res.cycles,
                            hbm_bytes=res.hbm_bytes,
                            collective_bytes=res.collective_bytes,
                            speedup=base_cycles / max(res.cycles, 1),
                            efficiency=(base_cycles
                                        / max(res.cycles, 1)) / c,
                            bottleneck=bottleneck_of(res.trace),
                            plan_json=(splan.to_dict()
                                       if keep_plans else None))
                        rows.append(row)
                        if progress is not None:
                            progress(row)
    return ShardSweepResult(rows=tuple(rows))
