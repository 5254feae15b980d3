"""Observability: the serving metrics registry and request spans
(counterpart of ``repro/obs/metrics.py``; the simulator analyses are not
ported)."""
