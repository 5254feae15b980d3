"""Serving: the continuous-batching schedule, the paged KV pool and the
engine (counterpart of ``repro/serve``)."""
