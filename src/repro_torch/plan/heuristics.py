"""Planner heuristics: mode resolution + the analytic HBM-traffic model
(copy of ``repro/plan/heuristics.py``).

These are the decision rules that used to live scattered across the repo
(``core.streaming.choose_mode`` / ``tile_stream_profitable`` /
``streamed_bytes_per_layer``, ``models.layers``' inline fallback, the
``sim.workload`` re-derivation).  They are now *planner internals*
(DESIGN.md §8): ``repro.plan.plan_model`` calls them once per layer and
records the outcome in an ``ExecutionPlan``; the legacy entry points in
``repro.core.streaming`` are deprecation shims over this module.

The core decision (DESIGN.md §2): the TBR-CIM macro's *mode_config* bit
(hybrid vs normal reconfiguration, paper §II-A) maps to an analytic
dataflow choice per attention layer — fusing KV-generation into attention
(TILE_STREAM) reduces HBM traffic iff streaming the raw activations
``x_kv`` (width ``d_kv``) beats streaming materialized K/V
(width ``2·Hkv·hd``):

    per-q-block streamed bytes:   TILE_STREAM  = S·d_kv
                                  LAYER_STREAM = S·2·Hkv·hd   (+ one-time
                                                 2·S·Hkv·hd write for K/V)

For MHA models (the paper's ViLBERT targets: Hkv·hd = d) tile-streaming
strictly wins; for aggressively-GQA LMs (2·Hkv·hd << d) generation-fusion
is traffic-negative and the planner falls back to LAYER_STREAM — the
normal-mode/weight-stationary path.
"""
from __future__ import annotations

from repro_torch.core.types import AttnKind, ExecutionMode

#: q/kv tile edge used by default plans — matches
#: ``kernels/stream_attention.py`` and ``sim.workload.BLOCK``.
DEFAULT_BLOCK = 256


def tile_stream_profitable(d_model: int, num_kv_heads: int,
                           head_dim: int) -> bool:
    """True iff fused KV-generation reduces streamed HBM bytes.

    ``d_model`` is the width of the KV-*source* activations (the other
    modality's width for cross-attention — paper Fig. 4a).
    """
    return 2 * num_kv_heads * head_dim >= d_model


def resolve_layer_mode(requested: ExecutionMode, *, d_kv: int,
                       num_kv_heads: int, head_dim: int,
                       attn_kind: AttnKind = AttnKind.FULL,
                       fuse_kv_generation: bool = True) -> ExecutionMode:
    """Resolve the execution mode for one attention layer.

    Honors an explicit NON_STREAM / LAYER_STREAM request (benchmark
    baselines); for TILE_STREAM, applies the profitability rule unless the
    layer is MLA (latent decompress: always fuse) or ``fuse_kv_generation``
    is off (cross-forwarding disabled).
    """
    if requested != ExecutionMode.TILE_STREAM:
        return requested
    if attn_kind == AttnKind.MLA:
        return ExecutionMode.TILE_STREAM
    if fuse_kv_generation and tile_stream_profitable(d_kv, num_kv_heads,
                                                     head_dim):
        return ExecutionMode.TILE_STREAM
    return ExecutionMode.LAYER_STREAM


def decode_attn_hbm_bytes(seq_kv: int, num_heads: int, num_kv_heads: int,
                          head_dim: int, mode: ExecutionMode, *,
                          append: bool = True,
                          bytes_per_el: int = 2) -> int:
    """Analytic HBM-traffic model for one *decode-step* attention layer,
    one slot (DESIGN.md §11).

    ``seq_kv`` is the KV length the step actually attends over — the
    cache length *including* the token being decoded, after DTPU pruning
    (``PruningConfig.kept_tokens``) shrank it for this layer.  ``append``
    is False for static caches (enc-dec cross-attention: the encoder KV
    never grows).  Mirrored exactly by the simulator's decode lowering
    (``sim.pipeline``):

    * TILE_STREAM  — the new token's K/V are generated on the stationary
      macros and cross-forwarded straight into the attention macros (never
      read back from HBM this step); one cache-append write + a streamed
      read of the ``seq_kv - 1`` previously cached tokens.
    * LAYER_STREAM — layer-granular sync: the append commits to HBM first,
      then attention re-reads the *whole* cache including the new token.
    * NON_STREAM   — unfused: Q and the score/probability rows spill and
      round-trip HBM around every stage, exactly like the prefill model.
    """
    kv_w = 2 * num_kv_heads * head_dim * bytes_per_el
    qo = num_heads * head_dim * bytes_per_el       # one token's Q (== O)
    if mode == ExecutionMode.NON_STREAM:
        a = num_heads * seq_kv * bytes_per_el      # one score row per head
        return ((kv_w if append else 0) + seq_kv * kv_w
                + 2 * qo + 4 * a + 2 * qo)
    if mode == ExecutionMode.LAYER_STREAM:
        return (kv_w if append else 0) + seq_kv * kv_w
    # TILE_STREAM: forwarded new-token KV is not re-read — with append the
    # step moves (seq_kv - 1) cached rows in + 1 appended row out, without
    # it just the seq_kv cached rows; both total seq_kv rows.
    return seq_kv * kv_w


def decode_rewrite_cycles(seq_kv: int, num_kv_heads: int, head_dim: int,
                          mode: ExecutionMode, *,
                          block_kv: int = DEFAULT_BLOCK,
                          rewrite_bytes_per_cycle: int,
                          bytes_per_el: int = 2) -> int:
    """CIM write-port cycles to land one decode step's KV working set in
    the attention macros — the same per-tile arithmetic the simulator's
    decode lowering charges.  Streaming modes rewrite the cached KV tile
    by tile (the last tile may be partial — decode lengths are ragged);
    NON_STREAM rewrites K and V whole.  This is where DTPU pruning pays
    off in decode: fewer kept tokens, fewer tiles rewritten."""
    kv_row = 2 * num_kv_heads * head_dim * bytes_per_el
    if mode == ExecutionMode.NON_STREAM:
        half = seq_kv * num_kv_heads * head_dim * bytes_per_el
        return 2 * -(-half // rewrite_bytes_per_cycle)
    cycles = 0
    done = 0
    while done < seq_kv:
        tile = min(block_kv, seq_kv - done)
        cycles += -(-(tile * kv_row) // rewrite_bytes_per_cycle)
        done += tile
    return cycles


def attn_hbm_bytes(seq_q: int, seq_kv: int, d_kv: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, mode: ExecutionMode, *,
                   block_q: int = DEFAULT_BLOCK,
                   bytes_per_el: int = 2) -> int:
    """Analytic HBM-traffic model for one attention layer (DESIGN.md §6).

    Counts Q/K/V/O/x_kv movement; weight traffic is identical across modes
    and omitted.  ``d_kv`` is the KV-source activation width (== d_model
    for self-attention).
    """
    # ceil, matching the simulator's schedulers (which pad partial tiles).
    nqb = max(-(-seq_q // block_q), 1)
    q_bytes = seq_q * num_heads * head_dim * bytes_per_el
    o_bytes = q_bytes
    kv_width = 2 * num_kv_heads * head_dim
    if mode == ExecutionMode.NON_STREAM:
        # Q,K,V written+read; scores A (H·Sq·Skv) written+read; P written+
        # read; out written.  (The paper's off-chip round-trip baseline.)
        a_bytes = num_heads * seq_q * seq_kv * bytes_per_el
        kv_bytes = seq_kv * kv_width * bytes_per_el
        return (2 * q_bytes + 2 * kv_bytes + 4 * a_bytes + 2 * o_bytes
                + seq_kv * d_kv * bytes_per_el)
    if mode == ExecutionMode.LAYER_STREAM:
        # x_kv read once + K/V written once, then re-read per q block.
        kv_bytes = seq_kv * kv_width * bytes_per_el
        return (q_bytes + o_bytes + seq_kv * d_kv * bytes_per_el
                + kv_bytes + nqb * kv_bytes)
    # TILE_STREAM: x_kv re-read per q block; K/V never touch HBM.
    return (q_bytes + o_bytes + nqb * seq_kv * d_kv * bytes_per_el)
