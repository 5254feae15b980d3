"""``repro_torch.sim``: the cycle-approximate StreamDCIM simulator and its
record/replay loop (counterpart of ``repro/sim/__init__.py``).

``macro``, ``dataflow``, ``pipeline``, ``trace``, ``energy`` and
``workload`` are pure-Python copies of the JAX package's modules.
``replay`` records the port's kernels (CUDA events on the card, the host
clock on the CPU) into ``KernelTrace``s that attach to plans and replay
through ``simulate_plan``.  ``serve_sim`` (a copy too) lowers a
multi-request continuous-batching schedule through the same schedulers:
``simulate_serve(...).metrics`` is what ``obs.metrics.assert_serve_parity``
holds the serving ``Engine.stats()`` to.
"""
from repro_torch.configs.hardware import (HW_PRESETS, HardwareConfig,
                                          STREAMDCIM_BASE, STREAMDCIM_SMALL,
                                          STREAMDCIM_WIDEBUS)
from repro_torch.sim.energy import (ENERGY_PRESETS, EnergyModel,
                                    EnergyReport, STREAMDCIM_ENERGY_BASE,
                                    energy_of, energy_of_trace)
from repro_torch.sim.macro import MacroArray, MacroMode
from repro_torch.sim.pipeline import (SimResult, compare_modes,
                                      rewrite_stall_trace, simulate,
                                      simulate_model, simulate_plan,
                                      simulate_rewrite_stall)
from repro_torch.sim.replay import (CalibrationReport, KernelRecorder,
                                    KernelTrace, active_recorder,
                                    analytic_op_profile, fit_calibration,
                                    record_plan, recorder_for, recording,
                                    resolve_calibration)
from repro_torch.sim.serve_sim import (ServeSimResult, ServeStepSim,
                                       simulate_serve)
from repro_torch.sim.trace import Event, Trace
from repro_torch.sim.workload import (AttnOp, DecodeOp, GemmOp, Layer,
                                      Workload, build_workload,
                                      decode_workload_from_plan,
                                      workload_from_plan)

__all__ = [
    "HW_PRESETS", "HardwareConfig", "STREAMDCIM_BASE", "STREAMDCIM_SMALL",
    "STREAMDCIM_WIDEBUS", "ENERGY_PRESETS", "EnergyModel", "EnergyReport",
    "STREAMDCIM_ENERGY_BASE", "energy_of", "energy_of_trace", "MacroArray",
    "MacroMode", "SimResult", "compare_modes", "simulate", "simulate_model",
    "simulate_plan", "simulate_rewrite_stall", "rewrite_stall_trace",
    "CalibrationReport", "KernelRecorder", "KernelTrace", "active_recorder",
    "analytic_op_profile", "fit_calibration", "record_plan", "recorder_for",
    "recording", "resolve_calibration",
    "ServeSimResult", "ServeStepSim", "simulate_serve",
    "Event", "Trace", "AttnOp", "DecodeOp", "GemmOp", "Layer", "Workload",
    "build_workload", "decode_workload_from_plan", "workload_from_plan",
]
