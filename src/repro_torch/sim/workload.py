"""Lower a decoder ``ModelConfig`` into the per-layer op graph the planner
walks (copy of the parts of ``repro/sim/workload.py`` the planner needs:
``AttnOp``, ``GemmOp``, ``Layer``, ``Workload``, ``build_workload`` and
the decoder builder, ``workload.py:177-254``).

Every layer is a tuple of ops: ``AttnOp`` (one attention including its Q
projection and K/V generation) and ``GemmOp`` (a weight-stationary GEMM:
output projection, FFN).  The simulator itself, its decode lowering and
the crossmodal/enc-dec builders are not ported: the port plans only the
families it runs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.types import Family, ModelConfig, pad_to

BLOCK = 256           # q/kv tile edge, matching plan.heuristics.DEFAULT_BLOCK


@dataclasses.dataclass(frozen=True)
class AttnOp:
    name: str
    seq_q: int
    seq_kv: int
    d_q: int            # width of the query-side activations
    d_kv: int           # width of the KV-source activations (other modality
                        # for cross-forwarding — paper Fig. 4a)
    heads: int
    kv_heads: int
    head_dim: int
    cross: bool = False  # K/V generated from the *other* stream
    block_q: int = BLOCK   # tile edges the schedulers iterate with —
    block_kv: int = BLOCK  # plan-driven lowering carries the plan's tiling

    @property
    def kv_width(self) -> int:
        return 2 * self.kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class GemmOp:
    name: str
    m: int
    k: int
    n: int


@dataclasses.dataclass(frozen=True)
class Layer:
    index: int
    ops: Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    layers: Tuple[Layer, ...]

    @property
    def attention_ops(self) -> List[Tuple[int, AttnOp]]:
        return [(l.index, op) for l in self.layers for op in l.ops
                if isinstance(op, AttnOp)]


def _ffn_ops(tag: str, seq: int, d: int, d_ff: int, act: str) -> List[GemmOp]:
    ops = [GemmOp(f"{tag}_ffn_up", seq, d, d_ff)]
    if act == "silu":                       # gated MLP: extra gate matmul
        ops.append(GemmOp(f"{tag}_ffn_gate", seq, d, d_ff))
    ops.append(GemmOp(f"{tag}_ffn_down", seq, d_ff, d))
    return ops


def _attn_block(tag: str, seq_q: int, seq_kv: int, d_q: int, d_kv: int,
                heads: int, kv_heads: int, hd: int,
                cross: bool = False) -> List[object]:
    return [AttnOp(tag, seq_q, seq_kv, d_q, d_kv, heads, kv_heads, hd,
                   cross=cross),
            GemmOp(f"{tag}_oproj", seq_q, heads * hd, d_q)]


def build_workload(cfg: ModelConfig, seq_len: int = 0) -> Workload:
    """seq_len = 0 picks the decoders' typical sequence (4096), padded to
    the tile block.  Only the dense decoder families are lowered."""
    if cfg.num_heads == 0:
        raise ValueError(
            f"{cfg.name}: attention-free families are out of simulator "
            "scope (no K/V streaming to schedule)")
    if cfg.family in (Family.CROSSMODAL, Family.ENCDEC):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} workload lowering is not "
            f"ported (only the decoder builder is)")
    return _build_decoder(cfg, seq_len)


def _build_decoder(cfg: ModelConfig, seq_len: int) -> Workload:
    s = pad_to(seq_len or 4096, BLOCK)
    d, h = cfg.d_model, cfg.num_heads
    hd = cfg.head_dim or d // h
    layers: List[Layer] = []
    for i in range(cfg.num_layers):
        ops = _attn_block(f"l{i}_self", s, s, d, d, h, cfg.num_kv_heads, hd)
        ops += _ffn_ops(f"l{i}", s, d, cfg.d_ff, cfg.act)
        layers.append(Layer(len(layers), tuple(ops)))
    return Workload(cfg.name, tuple(layers))
