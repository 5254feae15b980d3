"""TBR-CIM macro timing model (paper §II-A).

A macro stores a ``macro_rows x macro_cols`` INT8 stationary tile per
sub-array and evaluates one input vector bit-serially
(``ceil(input_bits / bits_per_cycle) + drain_cycles`` cycles per vector,
all resident tiles in parallel).  Each macro has **two** sub-arrays; the
reconfigurable modes decide what the second one does:

* ``NORMAL``  — both sub-arrays hold stationary operand tiles: double the
  resident capacity, but a rewrite must overwrite a live sub-array, so
  rewriting serializes with compute (the TranCIM §I stall).
* ``HYBRID``  — one sub-array active, one shadow: half the capacity, but
  tile t+1 can rewrite into the shadow while tile t computes — the
  substrate for the ping-pong compute-rewriting pipeline (§II-C).

Rewrite latency comes from the shared CIM write port
(``rewrite_bus_bits``), exactly the §I arithmetic in
``benchmarks/bench_rewrite_overlap.py``: K = 2048x512 INT8 over a 512-bit
bus takes 2048*512/64 = 16384 cycles.

Copy of ``repro/sim/macro.py``, pure Python: the same code, its imports
pointed at the port's copies (``repro_torch``).
"""
from __future__ import annotations

import dataclasses
import enum
import math

from repro_torch.configs.hardware import HardwareConfig


class MacroMode(str, enum.Enum):
    NORMAL = "normal"      # both sub-arrays stationary (max capacity)
    HYBRID = "hybrid"      # active + shadow sub-array (ping-pong rewrite)


@dataclasses.dataclass(frozen=True)
class MacroArray:
    """A group allocation of TBR-CIM macros in one reconfigurable mode."""

    hw: HardwareConfig
    groups: int
    mode: MacroMode = MacroMode.NORMAL

    @property
    def num_macros(self) -> int:
        return self.groups * self.hw.macros_per_group

    @property
    def capacity_tiles(self) -> int:
        per_macro = 2 if self.mode == MacroMode.NORMAL else 1
        return self.num_macros * per_macro

    @property
    def overlap_rewrite(self) -> bool:
        return self.mode == MacroMode.HYBRID and self.hw.ping_pong

    # ---------- timing ----------

    def tiles(self, k: int, n: int) -> int:
        """Stationary tiles needed for a k x n resident operand."""
        return (math.ceil(k / self.hw.macro_rows)
                * math.ceil(n / self.hw.macro_cols))

    def passes(self, k: int, n: int, count: int = 1) -> int:
        """Input-streaming passes for ``count`` resident k x n operands
        (e.g. per-head K tiles) given the array's tile capacity."""
        return math.ceil(count * self.tiles(k, n) / self.capacity_tiles)

    def gemm_cycles(self, m: int, k: int, n: int, count: int = 1) -> int:
        """(m x k) @ (k x n) with the k x n operand stationary: each pass
        streams all m input vectors through the resident tile set."""
        return self.passes(k, n, count) * m * self.hw.vector_cycles

    def rewrite_cycles(self, nbytes: int) -> int:
        return math.ceil(nbytes / self.hw.rewrite_bytes_per_cycle)


def dma_cycles(hw: HardwareConfig, nbytes: int) -> int:
    return math.ceil(nbytes / hw.hbm_bytes_per_cycle)


def noc_cycles(hw: HardwareConfig, nbytes: int) -> int:
    """Tile-based streaming network (TBSN) transfer between macro groups."""
    return math.ceil(nbytes / hw.noc_bytes_per_cycle)
