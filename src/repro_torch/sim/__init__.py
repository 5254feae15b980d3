"""The workload lowering the planner walks (counterpart of
``repro/sim/workload.py``; the simulator is not ported)."""
