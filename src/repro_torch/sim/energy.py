"""``repro.sim.energy`` — napkin energy model folded over simulator traces.

The simulator (``repro.sim``) reports *cycles*; the paper's efficiency
claims (§IV: 2.30x/1.13x energy vs non-/layer-based streaming) are about
*energy*.  ``EnergyModel`` closes that gap the way CIMFlow
(arXiv:2505.01107) and NeuroSim (arXiv:2505.02314) do for digital CIM: a
per-event cost table folded over ``Trace.events``, producing a
per-resource / per-op breakdown, total pJ, and EDP for any ``SimResult``.

Cost structure (all picojoules):

* dynamic — ``pj_per_macro_cycle`` per *macro* per busy compute cycle on
  the CIM arrays (GEN scaled by ``hw.gen_macros``, ATTN by
  ``hw.attn_macros``: the whole allocation switches together under
  bit-serial broadcast), ``pj_per_rewrite_byte`` on the CIM write port,
  ``pj_per_noc_byte`` on the tile-based streaming network,
  ``pj_per_hbm_byte`` off-chip, ``pj_per_vec_cycle`` on the SIMD unit;
* static — ``leak_pj_per_cycle[resource]`` per makespan cycle (GEN/ATTN
  again scaled per macro), so a bigger macro array pays idle leakage for
  the whole run: the latency/energy trade-off ``repro.dse`` sweeps.

``STREAMDCIM_ENERGY_BASE`` is calibrated against the same napkin
constants the roofline benchmarks use (``benchmarks/common.py``: HBM
~45 pJ/byte, on-chip ~2 pJ/byte, ~0.8 pJ/bf16-flop — those names are now
thin aliases over this model), with the CIM-side constants chosen so the
three-way comparison's energy ordering reproduces the paper's §IV claim
(TILE < LAYER < NON on the MHA models).  Ratios between design points are
meaningful; absolute joules are not (DESIGN.md §9).

Copy of ``repro/sim/energy.py``, pure Python: the same code, its imports
pointed at the port's copies (``repro_torch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, TYPE_CHECKING

from repro_torch.configs.hardware import HW_PRESETS, HardwareConfig

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.sim.pipeline import SimResult
    from repro_torch.sim.trace import Trace

@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """One pJ-cost table (an energy design point, like ``HardwareConfig``
    is a timing design point).  Registered in
    ``repro.configs.registry.ENERGY_CONFIGS``."""

    name: str = "streamdcim-energy-base"
    # --- dynamic costs ---
    pj_per_macro_cycle: float = 30.0   # per TBR-CIM macro per busy cycle
    pj_per_rewrite_byte: float = 4.0   # CIM write port (§I rewrite path)
    pj_per_noc_byte: float = 2.0       # TBSN hop (== on-chip napkin const)
    pj_per_hbm_byte: float = 45.0      # off-chip DRAM (~5.6 pJ/bit)
    pj_per_vec_cycle: float = 50.0     # SIMD softmax/elementwise lane bank
    # --- static leakage, per makespan cycle ---
    #     GEN/ATTN entries are per macro; others per resource instance.
    leak_pj_per_cycle: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"GEN": 0.5, "ATTN": 0.5, "BUS": 10.0,
                                 "NOC": 20.0, "HBM": 100.0, "VEC": 10.0})
    # --- napkin bridge: bf16 MXU flop (roofline comparisons only;
    #     the CIM arrays are charged per macro-cycle, not per flop) ---
    pj_per_flop: float = 0.8

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in ("name", "leak_pj_per_cycle"):
                continue
            v = getattr(self, f.name)
            if v < 0:
                raise ValueError(f"{self.name}: {f.name} must be >= 0, "
                                 f"got {v!r}")
        if any(v < 0 for v in self.leak_pj_per_cycle.values()):
            raise ValueError(f"{self.name}: leakage rates must be >= 0, "
                             f"got {dict(self.leak_pj_per_cycle)!r}")

    def macro_ops_per_cycle(self, hw: HardwareConfig) -> float:
        """INT8 MAC throughput of one macro per cycle (both multiply and
        add counted), for pJ/op cross-checks against ``pj_per_flop``."""
        return 2 * hw.macro_rows * hw.macro_cols / hw.vector_cycles


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """The fold result for one simulated run."""

    model: str                       # EnergyModel name
    hw: str                          # HardwareConfig name
    makespan_cycles: int
    by_resource: Dict[str, float]    # dynamic + that resource's leakage, pJ
    by_op: Dict[str, float]          # dynamic energy keyed by op tag, pJ
    dynamic_pj: float
    leakage_pj: float

    @property
    def total_pj(self) -> float:
        return self.dynamic_pj + self.leakage_pj

    @property
    def edp(self) -> float:
        """Energy-delay product, pJ * cycles (relative units — the
        simulator is cycle-approximate and unclocked)."""
        return self.total_pj * self.makespan_cycles

    def summary(self) -> Dict[str, float]:
        s = {"total_pj": self.total_pj, "dynamic_pj": self.dynamic_pj,
             "leakage_pj": self.leakage_pj, "edp_pj_cycles": self.edp}
        for r, pj in sorted(self.by_resource.items()):
            s[f"pj_{r}"] = pj
        return s


def _event_pj(em: EnergyModel, hw: HardwareConfig, resource: str,
              kind: str, cycles: int, nbytes: int) -> float:
    """Dynamic energy of ``cycles``/``nbytes`` on one (resource, kind)."""
    if kind == "compute":
        if resource == "GEN":
            return cycles * hw.gen_macros * em.pj_per_macro_cycle
        if resource == "ATTN":
            return cycles * hw.attn_macros * em.pj_per_macro_cycle
        if resource == "VEC":
            return cycles * em.pj_per_vec_cycle
        return 0.0
    if kind == "rewrite":
        # Rewrite events carry their byte counts; a byte-less event (old
        # traces) falls back to the write-port width the cycles imply.
        nb = nbytes or cycles * hw.rewrite_bytes_per_cycle
        return nb * em.pj_per_rewrite_byte
    if kind == "forward":
        return nbytes * em.pj_per_noc_byte
    if kind == "dma":
        return nbytes * em.pj_per_hbm_byte
    return 0.0


def _leak_scale(hw: HardwareConfig, resource: str) -> int:
    if resource == "GEN":
        return hw.gen_macros
    if resource == "ATTN":
        return hw.attn_macros
    return 1


def energy_of_trace(trace: "Trace", hw: HardwareConfig,
                    model: Optional[EnergyModel] = None) -> EnergyReport:
    """Fold ``model`` over a trace's events: one per-event pass builds the
    per-resource and per-op dynamic breakdowns together (so the two always
    sum to the same ``dynamic_pj``, including the byte-less rewrite
    fallback); leakage reads the trace's cached makespan."""
    em = model or STREAMDCIM_ENERGY_BASE
    agg = trace.aggregates
    by_resource: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    dynamic = 0.0
    for e in trace.events:
        pj = _event_pj(em, hw, e.resource, e.kind, e.cycles, e.bytes)
        if pj:
            by_resource[e.resource] = by_resource.get(e.resource, 0.0) + pj
            by_op[e.op] = by_op.get(e.op, 0.0) + pj
            dynamic += pj
    leakage = 0.0
    for resource, rate in em.leak_pj_per_cycle.items():
        pj = agg.makespan * rate * _leak_scale(hw, resource)
        by_resource[resource] = by_resource.get(resource, 0.0) + pj
        leakage += pj
    return EnergyReport(model=em.name, hw=hw.name,
                        makespan_cycles=agg.makespan,
                        by_resource=by_resource, by_op=by_op,
                        dynamic_pj=dynamic, leakage_pj=leakage)


def energy_of(result: "SimResult",
              model: Optional[EnergyModel] = None,
              hw: Optional[HardwareConfig] = None) -> EnergyReport:
    """Energy report for a ``SimResult``.  The design point defaults to
    the one the simulation ran on (``SimResult.hw_cfg``, falling back to
    the preset its name points at)."""
    hw = hw or getattr(result, "hw_cfg", None) or HW_PRESETS[result.hw]
    return energy_of_trace(result.trace, hw, model)


STREAMDCIM_ENERGY_BASE = EnergyModel()

# Low-leakage corner (e.g. aggressive power gating): latency-optimal
# points pay less for their idle area, flattening the Pareto frontier.
STREAMDCIM_ENERGY_LOWLEAK = EnergyModel(
    name="streamdcim-energy-lowleak",
    leak_pj_per_cycle={"GEN": 0.1, "ATTN": 0.1, "BUS": 2.0, "NOC": 4.0,
                       "HBM": 20.0, "VEC": 2.0})

# DRAM-heavy corner (older HBM / LPDDR-class ~2x pJ/byte): traffic
# differences between execution modes dominate even harder.
STREAMDCIM_ENERGY_DRAMHEAVY = EnergyModel(
    name="streamdcim-energy-dramheavy", pj_per_hbm_byte=90.0)

ENERGY_PRESETS: Dict[str, EnergyModel] = {
    m.name: m for m in (STREAMDCIM_ENERGY_BASE, STREAMDCIM_ENERGY_LOWLEAK,
                        STREAMDCIM_ENERGY_DRAMHEAVY)}
