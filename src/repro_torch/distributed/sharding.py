"""Sharding predicates over a mesh's axis sizes (copy of part of
``repro/distributed/sharding.py``).

Only what ``shard.partition`` needs is copied: ``_axis_size``,
``heads_shardable``, ``kv_heads_shardable``, ``experts_shardable`` and
``_SimulatedMesh``.  They read nothing of a mesh but ``mesh.shape``, a
mapping from axis name to size, so they take a ``_SimulatedMesh`` (or any
object with such a ``shape``) and need no device.  The rule table over
parameter trees (``spec_for_param``, ``param_shardings``) comes with
multi-GPU training, ROADMAP item 13, which fills the rest of this file.
"""
from __future__ import annotations

from repro_torch.core.types import ModelConfig


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def heads_shardable(cfg: ModelConfig, mesh) -> bool:
    m = _axis_size(mesh, "model")
    return cfg.num_heads % m == 0 if cfg.num_heads else False


def kv_heads_shardable(cfg: ModelConfig, mesh) -> bool:
    m = _axis_size(mesh, "model")
    return cfg.num_kv_heads % m == 0 if cfg.num_kv_heads else False


def experts_shardable(cfg: ModelConfig, mesh) -> bool:
    m = _axis_size(mesh, "model")
    return cfg.num_experts % m == 0 if cfg.num_experts else False


class _SimulatedMesh:
    """Stand-in with production axis sizes for rule evaluation on a small
    (e.g. single-device test) mesh — only ``.shape`` is consulted by the
    rule table."""

    def __init__(self, axis_sizes):
        self.shape = dict(axis_sizes)
