"""The deterministic, resumable data pipeline (counterpart of
``repro/data``)."""
