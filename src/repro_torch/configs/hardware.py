"""StreamDCIM hardware configurations (copy of ``repro/configs/hardware.py``):
the design points the planner's predictions are computed for.

The original docstring follows.

StreamDCIM hardware configurations — the simulator's architecture axis.

``HardwareConfig`` is the accelerator-side sibling of ``ModelConfig``: where
a ``ModelConfig`` pins one network, a ``HardwareConfig`` pins one CIM design
point for ``repro.sim`` to execute it on (paper §II / Fig. 2).  The default
``STREAMDCIM_BASE`` is calibrated so the §I TranCIM analysis reproduces:
with K = 2048x512 INT8 over a 512-bit rewrite bus, serial (layer-based
streaming) rewriting stalls ~57% of the QK^T phase.

Presets are registered in ``repro.configs.registry.HW_CONFIGS`` next to
``ARCHS``; ``benchmarks/bench_sim.py`` resolves its design points from
there (``registry.get_hw_config``).
"""
from __future__ import annotations

import dataclasses
import math

# Short axis labels for sweep-derived design-point names
# ("streamdcim-base/g8-gg4-bus1024-pp0"): every sweepable field has one.
_SWEEP_ABBREV = {
    "num_groups": "g",
    "gen_groups": "gg",
    "macros_per_group": "mpg",
    "macro_rows": "r",
    "macro_cols": "c",
    "input_bits": "ib",
    "bits_per_cycle": "bpc",
    "drain_cycles": "dc",
    "rewrite_bus_bits": "bus",
    "hbm_bytes_per_cycle": "hbm",
    "noc_bytes_per_cycle": "noc",
    "ping_pong": "pp",
    "act_bytes": "ab",
}


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """One tile-based streaming digital-CIM design point.

    The macro array is ``num_groups`` groups of ``macros_per_group`` TBR-CIM
    macros; each macro stores a ``macro_rows x macro_cols`` INT8 stationary
    tile and evaluates one input vector bit-serially.  ``rewrite_bus_bits``
    is the shared write port into the CIM sub-arrays (paper §I: 512-bit);
    ``ping_pong`` says whether each macro has the shadow sub-array that lets
    tile t+1 rewrite while tile t computes (paper §II-C).
    """

    name: str = "streamdcim-base"
    # --- macro array geometry ---
    num_groups: int = 4
    macros_per_group: int = 16
    macro_rows: int = 128          # stationary-operand rows (k dim)
    macro_cols: int = 128          # stationary-operand cols (n dim / lanes)
    # --- timing ---
    input_bits: int = 8            # INT8 activations, bit-serial input
    bits_per_cycle: int = 2        # dual-rail input DACless digital issue
    drain_cycles: int = 2          # adder-tree + accumulator drain per vector
    rewrite_bus_bits: int = 512    # CIM write-port width (paper §I)
    # --- memories / networks (bytes per cycle) ---
    hbm_bytes_per_cycle: int = 64  # off-chip DRAM port
    noc_bytes_per_cycle: int = 128  # tile-based streaming network (TBSN)
    # --- features ---
    ping_pong: bool = True         # shadow sub-array (compute-rewrite overlap)
    act_bytes: int = 1             # INT8 activations/scores in DMA accounting
    # --- dataflow split: groups running weight-stationary generation vs
    #     input-stationary attention (mixed-stationary, paper §II-B) ---
    gen_groups: int = 2

    def __post_init__(self):
        # ValueError (not assert): sweep-constructed design points must fail
        # loudly even under ``python -O``, and the message must carry the
        # offending values so a DSE grid error is self-diagnosing.
        def positive(field: str) -> None:
            v = getattr(self, field)
            if v <= 0:
                raise ValueError(
                    f"{self.name}: {field} must be > 0, got {v!r}")
        for field in ("num_groups", "macros_per_group", "macro_rows",
                      "macro_cols", "input_bits", "bits_per_cycle",
                      "rewrite_bus_bits", "hbm_bytes_per_cycle",
                      "noc_bytes_per_cycle", "act_bytes"):
            positive(field)
        if self.drain_cycles < 0:
            raise ValueError(f"{self.name}: drain_cycles must be >= 0, "
                             f"got {self.drain_cycles!r}")
        if not 0 < self.gen_groups < self.num_groups:
            raise ValueError(
                f"{self.name}: gen_groups must satisfy 0 < gen_groups < "
                f"num_groups, got gen_groups={self.gen_groups} "
                f"num_groups={self.num_groups}")
        if self.rewrite_bus_bits % 8:
            raise ValueError(
                f"{self.name}: rewrite_bus_bits must be a multiple of 8 "
                f"(whole bytes per write-port cycle), got "
                f"{self.rewrite_bus_bits}")

    # ---------- sweep construction ----------

    @classmethod
    def sweep(cls, base: "HardwareConfig | None" = None,
              name: "str | None" = None, **overrides) -> "HardwareConfig":
        """Build a validated sweep design point: ``base`` (default
        ``STREAMDCIM_BASE``) with field overrides and a deterministic
        derived name (``streamdcim-base/g8-gg4-bus1024``) so sweep
        artifacts and Pareto reports are self-describing.  Validation is
        the same ``__post_init__`` path every config takes; unknown
        fields raise ``ValueError`` (a typo'd axis must not silently
        sweep nothing)."""
        base = base if base is not None else STREAMDCIM_BASE
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(overrides) - known)
        if unknown:
            raise ValueError(f"unknown HardwareConfig sweep field(s) "
                             f"{unknown}; sweepable: {sorted(known)}")
        if name is None:
            order = list(_SWEEP_ABBREV)      # canonical axis order
            parts = [f"{_SWEEP_ABBREV.get(k, k)}{int(v) if isinstance(v, bool) else v}"
                     for k, v in sorted(overrides.items(),
                                        key=lambda kv: order.index(kv[0]))
                     if getattr(base, k) != v]
            name = base.name + ("/" + "-".join(parts) if parts else "")
        return dataclasses.replace(base, name=name, **overrides)

    # ---------- derived quantities ----------

    @property
    def vector_cycles(self) -> int:
        """Cycles for one input vector through a stationary tile set."""
        return math.ceil(self.input_bits / self.bits_per_cycle) + self.drain_cycles

    @property
    def rewrite_bytes_per_cycle(self) -> int:
        return self.rewrite_bus_bits // 8

    @property
    def num_macros(self) -> int:
        return self.num_groups * self.macros_per_group

    @property
    def gen_macros(self) -> int:
        return self.gen_groups * self.macros_per_group

    @property
    def attn_macros(self) -> int:
        return (self.num_groups - self.gen_groups) * self.macros_per_group

    @property
    def macro_tile_bytes(self) -> int:
        return self.macro_rows * self.macro_cols  # INT8 stationary cells


STREAMDCIM_BASE = HardwareConfig()

# Half the macro array — utilization/stall behavior under tighter capacity.
STREAMDCIM_SMALL = dataclasses.replace(
    STREAMDCIM_BASE, name="streamdcim-small", num_groups=2, gen_groups=1,
    macros_per_group=8)

# Wider rewrite bus: what §I's stall analysis looks like when the write
# port is no longer the bottleneck.
STREAMDCIM_WIDEBUS = dataclasses.replace(
    STREAMDCIM_BASE, name="streamdcim-widebus", rewrite_bus_bits=2048)

HW_PRESETS = {h.name: h for h in
              (STREAMDCIM_BASE, STREAMDCIM_SMALL, STREAMDCIM_WIDEBUS)}
