"""Lower ``ModelConfig``s into per-layer op graphs the simulator executes.

The simulator sees a model as a sequence of layers, each a tuple of ops:

* ``AttnOp``  — one attention (self- or cross-) including its Q projection
  and KV generation; the scheduler decides how Q/K/V move (HBM round-trip,
  layer-granular streaming, or tile-granular cross-forwarding).
* ``GemmOp``  — a plain weight-stationary GEMM (FFN matmuls, output
  projections); identical compute across schedulers, but the non-streaming
  baseline round-trips its activations through HBM.

* ``DecodeOp`` — one attention layer of one decode *step* across active
  serving slots (per-slot cached-KV lengths); built from
  ``repro.plan.DecodePlan``s via ``decode_workload_from_plan`` and
  consumed by ``sim.simulate_serve`` (DESIGN.md §11).

Supported families (the paper's §III pool): CROSSMODAL (ViLBERT two-stream
co-TRM), ENCDEC (whisper), and dense/VLM decoders (qwen2-vl).  Prefill
sequence lengths are padded to the attention block size; decode KV
lengths are ragged (the last tile may be partial) and shrink per layer
under DTPU pruning.

Copy of ``repro/sim/workload.py``, pure Python: the same code, its imports
pointed at the port's copies (``repro_torch``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.types import Family, ModelConfig, pad_to

BLOCK = 256           # q/kv tile edge — matches kernels/stream_attention.py


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
class DecodeOp:
    """One attention layer of one decode *step* across active slots: each
    slot streams its cached K/V (post-DTPU-pruning length ``seq_kv[s]``)
    through the attention macros for a single query token.  ``append`` is
    False for static caches (enc-dec cross-attention).  Built from a
    ``repro.plan.DecodePlan`` layer (``decode_workload_from_plan``)."""

    name: str
    seq_kv: Tuple[int, ...]   # per-slot attended KV length (incl. new token)
    d_q: int
    d_kv: int
    heads: int
    kv_heads: int
    head_dim: int
    cross: bool = False
    append: bool = True
    block_kv: int = BLOCK

    @property
    def kv_width(self) -> int:
        return 2 * self.kv_heads * self.head_dim

    @property
    def slots(self) -> int:
        return len(self.seq_kv)


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


def workload_from_plan(plan, prefix: str = "") -> Workload:
    """Lower an ``repro.plan.ExecutionPlan`` back into the op graph the
    schedulers execute — no mode re-derivation: the plan *is* the op list
    (attention ``LayerPlan``s + ``GemmPlan``s in recorded op order), and
    per-op modes stay on the plan (``sim.pipeline.simulate_plan`` reads
    them).  ``prefix`` renames every op (serving timelines keep per-step
    tags distinct — ``sim.simulate_serve``).  Duck-typed so this module
    never imports the planner."""
    ops: List[Tuple[int, int, object]] = []          # (op_index, layer, op)
    for lp in plan.layers:
        ops.append((lp.op_index, lp.layer_index,
                    AttnOp(prefix + lp.name, lp.seq_q, lp.seq_kv, lp.d_q,
                           lp.d_kv, lp.heads, lp.kv_heads, lp.head_dim,
                           cross=lp.cross, block_q=lp.block_q,
                           block_kv=lp.block_kv)))
    for g in plan.gemms:
        ops.append((g.op_index, g.layer_index,
                    GemmOp(prefix + g.name, g.m, g.k, g.n)))
    return _group_ops(plan.model, ops)


def _group_ops(model: str,
               ops: List[Tuple[int, int, object]]) -> Workload:
    """Fold (op_index, layer_index, op) records into the per-layer op
    tuples the schedulers walk — shared by the prefill and decode plan
    lowerings."""
    ops = sorted(ops, key=lambda t: t[0])
    layers: List[Layer] = []
    for _, li, op in ops:
        if not layers or layers[-1].index != li:
            layers.append(Layer(li, ()))
        layers[-1] = Layer(li, layers[-1].ops + (op,))
    return Workload(model, tuple(layers))


def decode_workload_from_plan(plan, prefix: str = "") -> Workload:
    """Lower an ``repro.plan.DecodePlan`` into the op graph one decode
    step executes: per model layer, its ``DecodeOp``(s) followed by the
    step's weight-stationary GEMMs (output projection + FFN at one token
    per slot).  ``prefix`` renames every op (``f"{prefix}{name}"``) so a
    multi-step serving timeline keeps per-step tags distinct.  Duck-typed
    like ``workload_from_plan``."""
    ops: List[Tuple[int, int, object]] = []
    for lp in plan.layers:
        ops.append((lp.op_index, lp.layer_index,
                    DecodeOp(prefix + lp.name, tuple(lp.seq_kv), lp.d_q,
                             lp.d_kv, lp.heads, lp.kv_heads, lp.head_dim,
                             cross=lp.cross, append=not lp.cross,
                             block_kv=lp.block_kv)))
    for g in plan.gemms:
        ops.append((g.op_index, g.layer_index,
                    GemmOp(prefix + g.name, g.m, g.k, g.n)))
    return _group_ops(plan.model, ops)


def build_workload(cfg, seq_len: int = 0) -> Workload:
    """seq_len = 0 picks the model's paper-typical sequence (ViLBERT:
    N_X = N_Y = 4096; whisper: 1500-frame encoder / 448-token decoder;
    decoders: 4096), padded to the tile block.

    Also accepts an ``repro_torch.plan.ExecutionPlan``: the plan is
    lowered directly (``workload_from_plan``) instead of re-deriving the
    op graph from the config."""
    if hasattr(cfg, "layers") and hasattr(cfg, "gemms"):
        return workload_from_plan(cfg)
    if cfg.num_heads == 0:
        raise ValueError(
            f"{cfg.name}: attention-free families are out of simulator "
            "scope (no K/V streaming to schedule) — see ROADMAP §Simulator")
    if cfg.family == Family.CROSSMODAL:
        return _build_crossmodal(cfg, seq_len)
    if cfg.family == Family.ENCDEC:
        return _build_encdec(cfg, seq_len)
    return _build_decoder(cfg, seq_len)


def _build_crossmodal(cfg: ModelConfig, seq_len: int) -> Workload:
    sx = pad_to(seq_len or 4096, BLOCK)
    sy = pad_to(seq_len or cfg.seq_y or 4096, BLOCK)
    dx, dy = cfg.d_model, cfg.d_model_y
    hx, hy = cfg.num_heads, cfg.num_heads_y
    hdx, hdy = dx // hx, dy // hy
    layers: List[Layer] = []
    n_pre = cfg.num_layers - cfg.num_coattn_layers
    for i in range(n_pre):
        ops = _attn_block(f"y{i}_self", sy, sy, dy, dy, hy, hy, hdy)
        ops += _ffn_ops(f"y{i}", sy, dy, cfg.d_ff_y, cfg.act)
        layers.append(Layer(len(layers), tuple(ops)))
    for i in range(cfg.num_coattn_layers):
        # Co-TRM block: each stream's K/V are generated from the *other*
        # modality's activations — the cross-forwarding case.
        ops: List[object] = []
        ops += _attn_block(f"cox{i}_co", sx, sy, dx, dy, hx, hx, hdx,
                           cross=True)
        ops += _attn_block(f"cox{i}_self", sx, sx, dx, dx, hx, hx, hdx)
        ops += _ffn_ops(f"cox{i}", sx, dx, cfg.d_ff, cfg.act)
        ops += _attn_block(f"coy{i}_co", sy, sx, dy, dx, hy, hy, hdy,
                           cross=True)
        ops += _attn_block(f"coy{i}_self", sy, sy, dy, dy, hy, hy, hdy)
        ops += _ffn_ops(f"coy{i}", sy, dy, cfg.d_ff_y, cfg.act)
        layers.append(Layer(len(layers), tuple(ops)))
    return Workload(cfg.name, tuple(layers))


def _build_encdec(cfg: ModelConfig, seq_len: int) -> Workload:
    se = pad_to(cfg.encoder_seq, BLOCK)
    sd = pad_to(seq_len or 448, BLOCK)
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim or cfg.d_model // cfg.num_heads
    hkv = cfg.num_kv_heads
    layers: List[Layer] = []
    for i in range(cfg.num_encoder_layers):
        ops = _attn_block(f"enc{i}_self", se, se, d, d, h, hkv, hd)
        ops += _ffn_ops(f"enc{i}", se, d, cfg.d_ff, cfg.act)
        layers.append(Layer(len(layers), tuple(ops)))
    for i in range(cfg.num_layers):
        ops = _attn_block(f"dec{i}_self", sd, sd, d, d, h, hkv, hd)
        ops += _attn_block(f"dec{i}_cross", sd, se, d, d, h, hkv, hd,
                           cross=True)
        ops += _ffn_ops(f"dec{i}", sd, d, cfg.d_ff, cfg.act)
        layers.append(Layer(len(layers), tuple(ops)))
    return Workload(cfg.name, tuple(layers))


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
