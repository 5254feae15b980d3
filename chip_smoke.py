#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's failure is
caught:
  1. the card's name and power limit, torch and CUDA versions;
  2. build of every kernel in src/repro_torch/csrc (one nvcc per source,
     in parallel), with the compiler's register/spill report, the count
     of tensor-core (HGMMA) instructions in the attention libraries'
     SASS, and how many of the stream kernel's clusters fit at once;
  3. each kernel against its plain PyTorch version on the card, in f32 and
     bf16, at the kernel test cases (ragged kv_len / cache_len, K = 768
     included; attention rows with no live key also against the mean of
     V; the bf16 attention kernels' live kv tiles against their Python
     mirror) and at the main paths' shapes, decode attention's batch
     invariance (a row of a batched call equals the B = 1 call, bitwise,
     at every case and main shape; a single row also inside a batch of
     three); kernel, plain, library-call times and the card's bound at
     each kernel's timed main-path shape; flash's time and TFLOP/s at each
     of its main shapes (vilbert, qwen3-32b's causal GQA prefill,
     hymba-1.5b's windowed prefill, and phases 12-14's: vilbert-large's
     hd-64 streams, whisper-base's encoder, prompt and cross-attention,
     qwen2-vl-2b's causal GQA 12/2 at 4096 and 2048), its wide route at
     MLA's latent widths (q/k 576, v 512; cases with rows that straddle
     two heads, odd G, GQA at 192/160, B = 2, a window, rows with no
     live key; every case's route against blocked.flash_route and the
     library's last launch, the wide route bitwise deterministic;
     deepseek-v3's prefills of 256 and 1024 tokens and a 4096-token
     forward with 128 heads, the 1024 and 4096 ones timed against the
     plain version, SDPA (with the backends that take it; the kernel
     must beat it) and a matmul-softmax-matmul chain), the stream kernel's
     K/V regeneration factor and its main shapes (vilbert-large's, and
     whisper-base's encoder self-attention and cross-attention over 1500
     encoder states with 4 and with 1 query row per kv head, timed at the
     decode shape against its bound and matmul K/V + SDPA, regeneration
     1); tile_gemm: its library's route and split rules against their
     Python mirrors, each case and main shape (vilbert-base's, qwen3-32b's
     and hymba-1.5b's MLPs) on its intended route (and bf16 wgmma ones
     also through the mma route, the first port's kernel, which the
     wrapper takes for an x off 16-byte alignment), a row of a splitk call
     equal to the M = 1 call bitwise at qwen3-32b's decode shapes, times
     at GEMM_TIMED against the mma route (the parent's kernel) in turns
     and torch.matmul; decode attention and the SSD scan: every call on
     its intended route (bf16 tc, f32 simt), the decode split rule of the
     library against blocked.decode_splits, and at DECODE_TIMED and every
     MAIN_SSD shape the kernel against the parent's kernel (the simt
     route, launched through the C interface) in turns, decode also
     against SDPA in turns, each also by its device time from
     torch.profiler (the decode tc route must be one launch); the two
     backward kernels (flash_attention_bwd, stream_attention_bwd) against
     their plain versions in f32 and bf16 at their cases (ragged kv_len,
     causal with q_offset, window, GQA, RoPE + qk-norm, hd 32-128, rows
     with no live key) and at the training shapes (vilbert-base's text
     and vision streams at N = 4096, qwen3-32b's causal 4096, the flash
     tc route there also on four draws of its own), each call
     repeated and held bitwise equal, the forwards' lse against the plain
     versions', times against SDPA's backward (flash) and matmul K/V
     generation + SDPA's backward + the dx/dW matmuls (stream);
  4. the first main path: vilbert-base VQA forward, bf16, B = 2,
     N_X = N_Y = 4096, in NON_STREAM, LAYER_STREAM and TILE_STREAM, with
     the kept-token counts and kernel launch counters checked (every
     tile_gemm launch on the wgmma route); then the three modes against
     each other in f32 at N = 1024, B = 1;
  5. the second main path: qwen3-32b at full width and depth, bf16, served
     by the paged-KV Engine (4 slots, prefill + batched decode) on five
     requests, with the token, pool, batching and launch-counter gates
     (tile_gemm: prefill on the wgmma route only, decode on splitk only),
     a profiled decode call and a profiled 1024-token prefill;
  6. serving checks in f32 at qwen3-32b's widths, 2 layers: batched against
     per-slot decode, and NON/LAYER/TILE prefill against each other;
  7. the third main path: mamba2-780m (SSM) at full width and depth, bf16,
     served by the same Engine (4 slots, per-slot decode: the paged pool
     does not take SSM caches) on five requests, with the token, decode
     and launch-counter gates (ssd_scan 48 per prefill, nothing else);
  8. the fourth: hymba-1.5b (hybrid attention + SSM heads, sliding
     window 1024) at full width and depth, bf16, the same way on four
     requests, one of them longer than the window (ssd_scan, flash
     attention, tile_gemm and decode attention over the ring; tile_gemm's
     routes gated as in phase 5; in phases 5, 7 and 8 every decode
     attention and SSD launch on the tc route);
  9. checks in f32 at both configurations' widths, 2 layers: prefill(S)
     then one decode step against prefill(S + 1) (for hymba S > 1024:
     the ring has wrapped), the kernel's prefill against the plain
     version's, and hymba's NON/LAYER/TILE prefills against each other;
     in bf16, the first layer's SSD state after the kernel's prefill (the
     tc route) against the plain version's;
 10. training at full width through make_train_step (bf16, remat): vilbert-base
     (B = 2, N = 4096, DTPU pruning on) 10 steps in each mode, qwen3-32b
     at 4 of its 64 layers (B = 1, S = 4096) 5 steps in LAYER and TILE,
     each on one repeated batch of the data pipeline's synthetic source:
     loss and grad norm finite, the loss falls, every step's launch
     counters equal what the path must launch (each forward twice, each
     attention backward once, no decode attention or SSD scan); step
     time, samples or tokens per second, peak memory, and one profiled
     step (device time against wall time of its forward, backward and
     optimizer, the busy share, the top kernels);
 11. f32 gradient checks, vilbert-base at full width with one text-only
     layer and one co-TRM block (N = 1024; the gradient of its two final
     streams against random weights) and qwen3-32b at 2 layers (S = 1024;
     its training loss): the kernel path against the plain path (every
     kernel replaced by its plain version on the card) and the three
     modes against each other, max |difference| over max |value| per
     parameter;
 12. vilbert-large (24 layers, 12 co-TRM blocks, both streams 1024 wide
     with 16 heads of 64) as phase 4: bf16, B = 2, N = 4096, three modes,
     kept counts (4096 x 3, 2816 x 3, 2048 x 3, 1408 x 3) and launch
     gates; then the modes in f32 at N = 1024 with one text-only layer and
     one co-TRM block;
 13. whisper-base (6 + 6 layers, d 512) at full width and depth, bf16:
     B = 4 clips of 1500 frames from the data pipeline and a 4-token
     prompt; encode and prefill in each mode, then 60 greedy decode steps
     (self-attention on decode attention's tc route over a plain 65-slot
     cache, cross-attention on the stream kernel with one query row per
     kv head), the launches of every call gated exactly; encode, prefill
     and decode-step times, a profiled decode step and encode; then f32 at
     2 + 2 layers: prefill(S) + a decode step against the teacher-forced
     decoder at S + 1, and the modes against each other, within 1e-4;
 14. qwen2-vl-2b (28 layers, GQA 12/2, M-RoPE) at full width and depth,
     bf16: the forward at S = 4096 over a text + image-grid position
     layout in each mode (flash and wgmma GEMMs only, the three bitwise
     equal) against the same forward with every kernel's plain version on
     the card; served by the paged-KV Engine (4 slots, five requests of
     256-2048 prompt tokens, 32 new tokens each) with phase 5's gates; f32
     at 2 layers: M-RoPE with equal streams against the 1-D RoPE forward
     and batched against per-slot decode, within 1e-4;
 15. grok-1-314b (MoE: 8 experts top-2, GQA 48/8) at full width, 4 of its
     64 layers, bf16: the forward at S = 1024 in each mode (the resolved
     attention per layer, exact launches), against the plain versions
     (the tokens whose expert set differs printed); served by the paged
     Engine (three requests of 256-1024 prompt tokens, 16 new tokens,
     batched decode on decode attention's tc route) with exact launch
     gates, TTFT, decode ms a call and profiled calls; then f32 at 2
     layers within 1e-4: the modes, the kernels against their plain
     versions (expert sets that differ and the smallest top-k gate margin
     printed), and with moe_capacity=100 prefill + decode against a
     longer prefill and a batched decode step against single ones;
 16. deepseek-v3-671b (MLA + 256 experts top-8 + a shared expert) at full
     width, its 3 dense-prefix layers and 2 MoE layers, the same way:
     MLA's latent attention on flash's wide route in every mode (the
     modes bitwise equal; exact wide-route counts), the latent cache
     served per slot, f32 checks at 1 dense + 1 MoE layer;
 17. minitron-4b (GELU MLP, GQA 24/8, vocab 256,000), starcoder2-7b
     (GELU, GQA 36/4; its use_bias read by no model code) and
     h2o-danube3-4b (dense sliding window of 4096, hd 120) at full width
     and depth, bf16, one after the other: the forward at S = 1024 in
     each mode (TILE_STREAM resolves to flash at all three; exact
     launches, tile_gemm on wgmma), then served by the paged Engine
     (three requests, h2o-danube3's prompts of 4500 tokens past its
     window, so its ring wraps) with phase 15's gates; then f32 at 2
     layers within 1e-4: the modes, the kernels against their plain
     versions, prefill + decode against a longer prefill and a batched
     decode step against single ones (h2o-danube3 at 4200 tokens, past
     the window); phase 3 checks their flash, decode and GEMM shapes;
 18. record/replay: vilbert-base planned at N = 4096 in each forced mode,
     every plan op recorded on the card in bf16 (CUDA events, median of
     5 after 2 warm-up calls), the traces attached, the plan's JSON round
     trip, replayed through the simulator and fitted (gates: one op-level
     trace per op, none shadowed, cycles > 0, the round trip equal with
     the same makespan, each replayed op lasting its recorded cycles,
     TILE's recorded stream grids equal to the library's launch
     configuration, finite positive calibration scales); recorded/analytic
     ratios per op class and how far the fit reproduces them,
     the replayed makespans beside the analytic ordering, the recorded
     vision self-attention beside phase 3's kernel times; qwen3-32b
     (2 layers) served under a recording with phase 17's request shape,
     each decode call's records attached to its own bucket's DecodePlan
     (two steps of two buckets); the per-slot decode_attention_by_plan
     recorded once against its plain version; then the DSE on the card's
     fit: the TILE_STREAM CalibrationReport written to JSON, read back
     and swept (``repro_torch.dse.run_sweep``, DSE_POINTS design points)
     under the analytic and the calibrated timing (the analytic rows
     equal a sweep without calibration, the calibrated ones finite and
     positive; both frontiers printed, and the points that move on or off
     it), and one sharded plan (4 simulated chips) simulated with the same
     calibration and rendered by ``timeline_from_sharded``: host work;
 19. training of the other families at full width, bf16, TILE_STREAM:
     mamba2-780m, hymba-1.5b, qwen2-vl-2b (image-grid M-RoPE positions)
     and whisper-base at full depth, deepseek-v3 at its 3 dense-prefix
     layers, 5 steps each on a repeated batch (AdamW 1e-4), and grok-1's
     one layer forward + backward (its optimizer's state does not fit
     the card); gates: exact launches and routes every step (the SSD
     scan and its backward, flash's wide forward and backward for MLA),
     a falling loss, a gradient on every parameter the loss reads; a
     profiled step and the peak memory printed (phase 3 checks the SSD
     backward, bf16 on its tc route, and the flash backward's wide route,
     and times each at phase 19's shapes against its parent's kernels,
     launched through the C interface, in turns);
 20. their f32 gradients at 1-2 layers, kernel path against plain path,
     and the modes against each other where a mode changes what runs;
 21. the rest of single-card inference: (a) the serving launcher's
     ``launch.serve.run`` at starcoder2-7b's full CONFIG (8 drawn requests,
     16 new tokens, 4 slots, max_len 256; exact launch gates), then
     ``simulate_serve`` over the same requests with the engine's own
     plans, held to ``Engine.stats()`` by ``assert_serve_parity``; tokens/s,
     wall, and a profiled rerun's device time and busy share; (b) the int8
     projection (``ops.projection`` under ``runtime.flags(
     quantize_proj=True)``, bf16) at vilbert-base's and starcoder2-7b's
     MLP shapes, M = 4 (padded for ``torch._int_mm``) included: int8
     operands, scales and output bitwise equal to the CPU plain path's,
     the int32 sums to an exact f64 product, timed beside ``tile_gemm``,
     ``torch.matmul`` and the bound (int8 at 1,979 TOPS); (c) vilbert-base's
     LAYER_STREAM forward (B = 2, N = 4096) and starcoder2-7b's serving
     under the flag: no ``tile_gemm`` launch, every MLP product on the
     int8 path, finite logits, parity, tokens in range, the share of
     greedy tokens equal to (a)'s; (d) the three examples
     (``examples/torch_*.py``) on the card and ``python -m repro_torch.obs``
     twice, as subprocesses that must exit 0;
 22. training of the last four archs at full width, bf16, with phase 19's
     gates (train_run): vilbert-large at full depth (B = 2, N = 4096,
     LAYER and TILE; its encoder step as phase 10's), minitron-4b at 16
     of its 32 layers (1 x 2048), starcoder2-7b at 24 of its 32 layers
     (1 x 2048; the optimizer's state of all 32 does not fit the card)
     and h2o-danube3-4b at 12 of its 24 layers at 1 x 8192, past its
     4096-key window (LAYER and TILE; the decoders' TILE_STREAM resolves
     to flash); then
     f32 at 2 layers, kernel against plain gradients within 1e-4:
     h2o-danube3 at S = 8192 in both modes, the other three in one mode
     (phase 3 checks the flash backward at h2o-danube3's training shape,
     hd 120 with whole kv tiles outside the window, and the tc flash
     backward at qwen3-32b's heads at 4096, 8192 and 16384 keys on four
     draws of their own);
 23. multi-GPU on torch.distributed (phase 23, ~130 s): (a) on the
     one-rank NCCL host mesh (launch.mesh.make_host_mesh), starcoder2-7b
     and qwen2-vl-2b at full width and depth served by Engine(mesh=...)
     against Engine(mesh=None), both per-slot (tokens, kernel launches and
     routes equal), three qwen3-32b train steps at 4 layers (1 x 4096)
     through loop.train(mesh=...), the sharded step, against mesh=None
     (losses and every parameter bitwise equal, launches equal),
     cross_pod_mean_int8 at one pod (the gradients as they are; the
     quantizer on the card bitwise equal to the CPU's) and
     gather_matmul_overlapped at world 1 (one tile_gemm launch, bitwise
     equal to tile_gemm); (b) each of the 16 'model' ranks of the
     production mesh in turn on the card (distributed.parallel.rank_view),
     one layer's attention and MLP (or MoE) forward and backward on the
     rank's blocks through the kernels, f32 and bf16: qwen3-32b at 4096
     tokens and h2o-danube3-4b at 8192 (query heads), starcoder2-7b at
     4096 under the attn_q hint (context-parallel: the rank's query rows
     against the whole K/V), each in LAYER_STREAM and TILE_STREAM (the
     planner's rule forced); grok-1-314b at 1024 (3 of 48 heads,
     expert-TP) and deepseek-v3-671b's MoE layer at 1024 (MLA on 8 of 128
     heads, 16 of 256 experts; its f32 check with the experts cut to 32):
     every rank's launches exact, the ranks' sums (context-parallel rows
     joined) against the whole layer (f32 within 1e-4; bf16 no farther
     from the f32 numbers than twice the whole is), in bf16 rank 0's
     device ms (and rank 15's for context parallelism) against the
     whole's over 16; then the same of mamba2-780m's SSM mixer at 4096
     (3 of 48 heads: the in-projection's gathered columns and the gated
     norm's sum through a parallel.Exchange, ssd_scan and its backward on
     the rank's heads), vilbert-large's co-TRM block at N = 4096 (both
     streams, 1 of 16 heads a stream, LAYER and TILE: the stream kernel
     generating the rank's head's K/V from the other modality) and
     whisper-base's decoder layer at 4096 tokens over 1500 encoder frames
     under the attn_q hint (context-parallel self- and cross-attention,
     LAYER and TILE), each row's rank 0 kernel routes printed; (d)
     cost_analysis_cycles of a recorded tile_gemm beside its recorded
     time; (c) the dry run (launch.dryrun) of one cell per family on a
     fake 256-rank (16, 16) world, qwen3-32b's train_4k there at full
     depth (one microbatch), deepseek-v3's train_4k at depth 4, grok-1's
     at depth 2, starcoder2-7b's at depth 4 with --optimized, and
     mamba2-780m's, whisper-base's (--optimized) and vilbert-large's at
     depth 1, and one cell on a fake
     512-rank (2, 16, 16) world, each in its own process, started before
     (a): status ok, the JSON round-trips, no train cell a gathered step,
     cross-pod traffic on two pods, the qwen3-32b train cell sharded
     (nothing replicated over 'model', reduce-scatters, FLOPs a device
     within 2.5x the model's, arguments within 1% of the rule table's
     blocks), the six cut train cells with nothing replicated over
     'model' and FLOPs a device within their DRYRUN_OPTIONS multiple of
     the model's, and per-device FLOPs, bytes, memory, collective traffic and
     roofline (on the H100's datasheet rates) printed;
 then one JSON line of per-kernel numbers, with the routes of
 tile_gemm, flash attention, decode attention, the SSD scan and the
 backward kernels
 over the main paths (phases 4-5, 7-8, 10, 12-17, 19, 21-23) and their timed
 shapes ("tile_gemm_shapes", "decode_attention_shapes",
 "ssd_scan_shapes", "stream_attention_shapes", "flash_attention_shapes",
 the backward kernels', "int8_projection_shapes"); and the last line:
 {"ok": true, "device": {...}}.

Bound of a kernel call: the larger of its FLOPs over the H100 SXM peak of
its input type (989 TFLOP/s bf16, 67 TFLOP/s f32) and the bytes it must
move (inputs read once, output written once) over 3.35 TB/s.  The FLOPs
are the function's, once: ssd_scan's bf16 route takes each f32 operand
as two bf16 halves (three products), which is the kernel's choice and is
printed beside the bound, not counted in it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import runtime  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    AttnKind, ExecutionMode, Family)
from repro_torch.kernels import _build, blocked, ops, quant, ref  # noqa: E402
from repro_torch.kernels import decode_attention as decode_lib  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, live_tiles)
from repro_torch.kernels.flash_vjp import (  # noqa: E402
    flash_attention_bwd, stream_attention_bwd)
from repro_torch.kernels import ssd_scan as ssd_lib  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.kernels.stream_attention import (  # noqa: E402
    config as stream_config, regeneration, stream_attention)
from repro_torch.kernels import tile_gemm as tile_gemm_lib  # noqa: E402
from repro_torch.kernels.tile_gemm import (  # noqa: E402
    route_of, splits_of, tile_gemm)
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.encdec import EncDec  # noqa: E402
from repro_torch.models.ssm import SSM, ssm_dims  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.models.vilbert import ViLBERT  # noqa: E402
from repro_torch.plan import plan_decode_step, plan_model  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    KernelRecorder, analytic_op_profile, compare_modes, fit_calibration,
    record_plan, recording, simulate_plan, simulate_serve)
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.schedule import ServeRequest  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.dse import run_sweep  # noqa: E402
from repro_torch.obs.timeline import (  # noqa: E402
    timeline_from_sharded, validate_timeline)
from repro_torch.shard import (  # noqa: E402
    MeshSpec, shard_plan, simulate_sharded_plan)
from repro_torch.sim.replay import CalibrationReport  # noqa: E402
from repro_torch.obs.metrics import assert_serve_parity  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.types import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_vjp  # noqa: E402
from repro_torch.plan.heuristics import resolve_layer_mode  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402
from repro_torch.train import steps as ST  # noqa: E402
from repro_torch.train.loop import build_model, to_device  # noqa: E402

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPES = (torch.float32, torch.bfloat16)
# Kernel against plain version: |got - want| <= atol + rtol * |want|.
# f32: the JAX package's kernel tolerances (tests/test_kernels.py), as
# atol = rtol.  bf16: kernel and plain version read the same bf16 inputs
# and both compute in f32, so they differ by the rounding of the output,
# at most one bf16 ulp, which is at most 2**-7 of the value; atol covers
# the f32 summation order near zero (measured below 2e-5 in f32).  The
# tensor-core attention kernels take each f32 operand (P; the stream
# kernel's K and V) as two bf16 values, which keeps them inside this limit
# where bf16 operands alone would not (tests/test_torch_attention_split.py).
# chip_faults.py plants faults (a kv tile or a K chunk skipped) in copies
# of the kernels and checks that these limits catch them.
BF16_TOL = (1e-4, 2 ** -7)
TOL = {"flash_attention": {torch.float32: (2e-4, 2e-4),
                           torch.bfloat16: BF16_TOL},
       "stream_attention": {torch.float32: (5e-4, 5e-4),
                            torch.bfloat16: BF16_TOL},
       "tile_gemm": {torch.float32: (1e-3, 1e-3), torch.bfloat16: BF16_TOL},
       # f32: the JAX package's decode tolerance (test_decode_attention.py)
       "decode_attention": {torch.float32: (1e-5, 1e-5),
                            torch.bfloat16: BF16_TOL},
       # f32: over 10x the largest error read at any case or main shape
       # (y 7.8e-6, final state 1.8e-6), and below what products done in
       # TF32 would miss by.  The final state is f32 in both runs and takes
       # the f32 limits.
       "ssd_scan": {torch.float32: (1e-4, 1e-4), torch.bfloat16: BF16_TOL},
       # the backward kernels: f32 at the JAX package's gradient tolerances
       # (test_kernels.py:179, :196); bf16 as the forwards
       "flash_attention_bwd": {torch.float32: (2e-4, 2e-4),
                               torch.bfloat16: BF16_TOL},
       "stream_attention_bwd": {torch.float32: (5e-4, 5e-4),
                                torch.bfloat16: BF16_TOL},
       # f32 (dt and a's gradients are f32 in both dtypes): 1e-4 with atol
       # taken of the tensor's largest value (a third field), as the CPU
       # tests hold the port's SSD gradient to JAX's.  ddt_t sums
       # du_t . x_t and a times the reverse cumsum of dLD, terms as large as
       # the largest ddt that cancel down to small values; the kernel and
       # the plain version sum them in other orders in f32, so a small
       # element's error follows the largest terms (read: 2.3e-4 at
       # max |ddt| 153, 1.5e-6 of it, mamba2's widths at S = 2000)
       "ssd_scan_bwd": {torch.float32: (1e-4, 1e-4, "of max"),
                        torch.bfloat16: BF16_TOL}}
# Three modes against each other, vilbert-base in f32 at N = 1024: the
# final vision and language streams (the logits say little: with random
# weights the pooler's tanh saturates), max |difference| over max |value|.
# Three summation orders in f32, carried through 12 layers.
MODE_TOL = 1e-4
EXPECTED_COUNTS = ((4096, 4096), (2816, 2816), (2816, 2816),
                   (2048, 2048), (1408, 1408), (1408, 1408))
# vilbert-large's 12 co-TRM blocks at N = 4096 (core.pruning.keep_plan)
EXPECTED_COUNTS_LARGE = tuple((n, n) for n in (4096,) * 3 + (2816,) * 3
                              + (2048,) * 3 + (1408,) * 3)
KERNELS = {
    "stream_attention": (stream_attention,
                         "src/repro/kernels/stream_attention.py:167"),
    "flash_attention": (flash_attention,
                        "src/repro/kernels/flash_attention.py:105"),
    "tile_gemm": (tile_gemm, "src/repro/kernels/tile_gemm.py:57"),
    "decode_attention": (decode_attention,
                         "src/repro/kernels/decode_attention.py:124"),
    "ssd_scan": (ssd_scan, "src/repro/kernels/ssd_scan.py:97"),
    # the JAX training path's custom VJPs (jnp, not Pallas kernels)
    "flash_attention_bwd": (flash_attention_bwd,
                            "src/repro/kernels/flash_vjp.py:114"),
    "stream_attention_bwd": (stream_attention_bwd,
                             "src/repro/kernels/flash_vjp.py:267"),
    # the gradient of the JAX training path's SSD: XLA's autodiff of the
    # jnp chunked scan (the Pallas kernel has no backward)
    "ssd_scan_bwd": (ssd_scan_bwd, "src/repro/kernels/jnp_blocked.py:261"),
}


def free() -> None:
    """Return the last phase's device memory: its Engine and Probe hold
    reference cycles, which only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, budget_ms: float = 400.0) -> float:
    """Mean device time of fn() in ms, by CUDA events after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype: torch.dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(name: str, case: str, got: torch.Tensor, want: torch.Tensor
            ) -> float:
    torch.cuda.synchronize()
    atol, rtol, *of_max = TOL[name][got.dtype]
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{name} {case}: shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)} or non-finite output")
    g, w = got.float(), want.float()
    if of_max:
        atol *= max(w.abs().max().item(), 1.0)
    err = (g - w).abs()
    if (err > atol + rtol * w.abs()).any():
        worst = (err / (atol + rtol * w.abs())).max().item()
        fail(f"{name} {case}: max |err| {err.max().item():.3e}, max |want| "
             f"{w.abs().max().item():.3e}; worst element {worst:.1f}x its "
             f"limit (atol {atol}, rtol {rtol})")
    return err.max().item()


def randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len (None = Sk)
FLASH_CASES = [
    (1, 4, 4, 128, 128, 128, 128, False, 0, None),   # MHA square
    (2, 8, 2, 256, 256, 128, 128, True, 0, None),    # GQA causal
    (1, 4, 2, 128, 384, 128, 128, True, 0, None),    # causal, offset KV
    (2, 4, 4, 128, 256, 128, 128, True, 100, None),  # sliding window
    (1, 2, 1, 256, 256, 128, 128, False, 0, None),   # MQA
    (2, 4, 2, 100, 200, 64, 64, True, 50, 170),      # ragged Sq/Sk + kv_len
    (1, 4, 1, 77, 150, 96, 32, False, 0, None),      # hdv != hd, ragged
    (2, 8, 8, 300, 1408, 128, 128, False, 0, None),  # pruned vilbert kv
    (2, 4, 2, 96, 200, 32, 32, True, 64, 190),       # hd = 32, ragged
    (1, 64, 8, 1024, 1024, 128, 128, True, 0, None),  # qwen3-32b prefill
    # rows with no live key (see no_live_key): past kv_len + window - 1 ...
    (1, 2, 1, 300, 300, 64, 64, False, 32, 100),
    (2, 8, 2, 130, 700, 128, 128, True, 8, 600),
    (1, 2, 2, 64, 150, 32, 32, False, 0, 0),         # ... or every row
    # MLA's latent widths (the wide route): MQA, ragged Sq != Sk, kv_len
    (1, 16, 1, 200, 333, 576, 512, True, 0, 300),
]
# More of the wide route's edges: odd G, Hkv = 2 GQA just over 128 wide,
# B = 2, a sliding window, rows past kv_len + window - 1 with no live key,
# G = 3 with kv_len, non-causal rows that straddle two heads.
FLASH_WIDE_CASES = [
    (1, 5, 1, 128, 128, 576, 512, True, 0, None),
    (1, 8, 2, 128, 192, 192, 160, True, 0, None),
    (2, 8, 1, 128, 256, 576, 512, True, 0, None),
    (1, 4, 1, 256, 256, 576, 512, True, 70, None),
    (1, 4, 1, 192, 192, 576, 512, False, 32, 100),
    (1, 3, 1, 64, 300, 576, 512, False, 0, 250),
    (1, 4, 1, 100, 256, 576, 512, False, 0, None),
]
# B, Hq, Hkv, Sq, Sk, hd, D, causal, window, rope, knorm, kv_len
STREAM_CASES = [
    (1, 4, 4, 128, 128, 128, 256, False, 0, False, False, None),
    (2, 8, 2, 128, 256, 128, 256, True, 0, True, False, None),
    (1, 4, 2, 128, 128, 128, 384, True, 0, True, True, None),
    (1, 4, 2, 128, 256, 128, 256, True, 96, True, False, None),
    (2, 4, 2, 100, 200, 64, 96, True, 0, True, True, 170),   # ragged
    (2, 12, 12, 300, 1408, 64, 1024, False, 0, False, False, None),
    (2, 4, 2, 96, 200, 32, 150, True, 0, True, True, 190),  # hd = 32
    (1, 64, 8, 256, 256, 128, 5120, True, 0, True, True, None),  # qwen3 TILE
    # fewer D chunks than generation stages, over 8 rounds of kv tiles:
    # clusters of 1 (128 rows, 8 tiles) and of 8 (1024 rows, 64 tiles)
    (1, 1, 1, 128, 512, 64, 64, False, 0, False, False, None),
    (1, 8, 1, 128, 4096, 64, 64, False, 0, True, False, None),
    (1, 1, 1, 128, 512, 64, 96, True, 0, True, True, None),
    (1, 8, 1, 128, 4096, 64, 96, False, 0, False, True, None),
    (1, 1, 1, 128, 512, 64, 192, False, 0, True, False, None),
    (1, 8, 1, 128, 4096, 64, 192, True, 0, True, True, None),
    (1, 1, 1, 128, 512, 128, 64, False, 0, False, True, None),
    (1, 8, 1, 128, 4096, 128, 64, False, 0, True, False, None),
    # rows with no live key (see no_live_key)
    (1, 2, 1, 300, 300, 64, 128, False, 32, True, False, 100),
    (1, 8, 2, 130, 700, 128, 256, True, 8, True, True, 600),
    # whisper-base's cross-attention: one query row per kv head (decode)
    # and a 4-token prompt, over 1500 encoder states (a ragged last tile)
    (4, 8, 8, 1, 1500, 64, 512, False, 0, False, False, None),
    (4, 8, 8, 4, 1500, 64, 512, False, 0, False, False, None),
    (2, 8, 8, 1, 1500, 64, 512, False, 0, False, False, 1499),
]
M_SMALL = blocked.GEMM_M_SMALL
GEMM_CASES = [(256, 128, 192), (512, 384, 256), (128, 256, 128),
              (128, 768, 256),   # K = 768: the reference's ragged-K case
              (100, 770, 130),   # ragged M, N and K: mma (bf16), simt (f32)
              # the edge between splitk and wgmma
              (M_SMALL, 256, 512), (M_SMALL + 1, 256, 512),
              # K below one K tile, N a multiple of 8 but not of a tile
              (M_SMALL, 40, 136), (200, 40, 136),
              # K and N multiples of 8 but not of a tile; splitk in 13
              # splits, the last of 8 rows
              (300, 776, 264), (3, 776, 264),
              (4, 3000, 520),    # splitk in 47 splits, the last ragged
              (5, 770, 130)]     # splitk's element loads (N % 8 != 0)

# The main path's shapes at vilbert-base, B = 2, N = 4096 (first co-TRM
# block; text-only layers have the text self-attention shape).
# Flash also carries phase 5's causal GQA prefill (qwen3-32b, 1024 tokens)
# and phase 8's windowed one (hymba-1.5b, 3000 tokens, window 1024).
MAIN_FLASH = {  # name: (B, Hq, Hkv, Sq, Sk, hd, causal, window)
    "vision self 4096": (2, 8, 8, 4096, 4096, 128, False, 0),
    "text self 4096": (2, 12, 12, 4096, 4096, 64, False, 0),
    "vision self 1408": (2, 8, 8, 1408, 1408, 128, False, 0),
    "qwen3-32b prefill 1024": (1, 64, 8, 1024, 1024, 128, True, 0),
    "hymba-1.5b prefill 3000": (1, 25, 5, 3000, 3000, 64, True, 1024),
}
# Phases 12-14: vilbert-large's streams (16 heads of 64, both 1024 wide;
# LAYER_STREAM, at N = 4096 and at its kept counts), whisper-base (B = 4:
# the encoder in LAYER_STREAM, the decoder's causal prompt self-attention
# in every mode, its cross-attention over the 1500 encoder states in
# LAYER_STREAM) and qwen2-vl-2b (GQA 12/2, hd 128, causal: the M-RoPE
# forward at 4096 and the served prefills).
MAIN_FLASH.update({
    f"vilbert-large self {n}": (2, 16, 16, n, n, 64, False, 0)
    for n in (4096, 2816, 2048, 1408)})
MAIN_FLASH.update({
    "whisper encoder 1500": (4, 8, 8, 1500, 1500, 64, False, 0),
    "whisper prompt self 4": (4, 8, 8, 4, 4, 64, True, 0),
    "whisper cross 4": (4, 8, 8, 4, 1500, 64, False, 0),
    "qwen2-vl forward 4096": (1, 12, 2, 4096, 4096, 128, True, 0),
    "qwen2-vl prefill 2048": (1, 12, 2, 2048, 2048, 128, True, 0),
})
# Phases 15 and 16 (grok-1-314b, deepseek-v3-671b): the forward at
# MOE_S tokens, then the Engine serves MOE_REQUESTS (rid, prompt length, new
# tokens, arrival step): r0 and r1 share a bucket (grok-1's batched decode),
# r2 arrives while they decode; the cache holds MOE_MAX_LEN positions.
MOE_S = 1024
MOE_REQUESTS = [(0, 1024, 16, 0), (1, 1024, 16, 0), (2, 256, 16, 1)]
MOE_MAX_LEN = 1040
MOE_PROMPTS = sorted({MOE_S} | {p for _, p, _, _ in MOE_REQUESTS})
# grok-1's causal GQA 48/8 (hd 128) at its forward and served prompts
MAIN_FLASH.update({f"grok-1 prefill {s}": (1, 48, 8, s, s, 128, True, 0)
                   for s in MOE_PROMPTS})
# Phase 16's MLA latent attention at deepseek-v3's forward and served
# prompts: q (1, 128, S, 576), k (1, 1, S, 576), v (1, 1, S, 512), causal,
# on the wide route; the 1024-token one (MLA_TIMED) is timed against SDPA
# and a matmul-softmax-matmul chain.
MAIN_FLASH_MLA = {  # name: (B, Hq, Hkv, Sq, Sk, hd, hdv, causal)
    f"deepseek-v3 MLA prefill {s}": (1, 128, 1, s, s, 576, 512, True)
    for s in MOE_PROMPTS}
# ... and the forward of phase 3's 4096-token wide backward shape, also
# timed
MLA_LONG = {"deepseek-v3 MLA 4096": (1, 128, 1, 4096, 4096, 576, 512, True)}
MLA_TIMED = ("deepseek-v3 MLA prefill 1024", "deepseek-v3 MLA 4096")
MAIN_STREAM = {  # name: (B, H, Sq, Sk, hd, D)
    "vision self 4096": (2, 8, 4096, 4096, 128, 1024),
    "text self 4096": (2, 12, 4096, 4096, 64, 768),
    "vision co 4096": (2, 8, 4096, 4096, 128, 768),
    "text co 4096": (2, 12, 4096, 4096, 64, 1024),
    "text co 1408": (2, 12, 1408, 1408, 64, 1024),
    # vilbert-large: self- and co-attention of both streams share a shape
    "vilbert-large 4096": (2, 16, 4096, 4096, 64, 1024),
    "vilbert-large 2816": (2, 16, 2816, 2816, 64, 1024),
    "vilbert-large 1408": (2, 16, 1408, 1408, 64, 1024),
    # whisper-base, B = 4: encoder self-attention, the prompt's and one
    # decode step's cross-attention (one query row per kv head)
    "whisper encoder self 1500": (4, 8, 1500, 1500, 64, 512),
    "whisper cross 4": (4, 8, 4, 1500, 64, 512),
    "whisper cross decode": (4, 8, 1, 1500, 64, 512),
}
# The stream kernel is also timed at whisper's decode shape (Sq = 1).
STREAM_TIMED = ("whisper cross decode",)
MAIN_GEMM = {  # name: (M, K, N)
    "text mlp up": (8192, 768, 3072),
    "text mlp down": (8192, 3072, 768),
    "vision mlp": (8192, 1024, 1024),
}
# Phase 5's MLP projections: gate/up (M, 5120, 25600) and down (M, 25600,
# 5120) at its prompt lengths and its decode bucket sizes.
MAIN_GEMM.update({
    f"qwen3 {what} M={m} mlp {proj}": (m, k, n)
    for what, ms in (("prefill", (512, 1024, 1536)), ("decode", (1, 3)))
    for m in ms
    for proj, k, n in (("up", 5120, 25600), ("down", 25600, 5120))})
# Phases 7 and 8's requests: rid, prompt length, new tokens, arrival step.
# mamba2: r0/r1 of one length, r3 the longest, r4 waits for a free slot;
# hymba: r0 (3000) and r2 (2048) longer than the 1024-key window.
MAMBA2_REQUESTS = [(0, 2048, 32, 0), (1, 2048, 32, 0), (2, 1000, 32, 0),
                   (3, 4000, 16, 1), (4, 512, 32, 2)]
HYMBA_REQUESTS = [(0, 3000, 32, 0), (1, 1500, 32, 0), (2, 2048, 32, 1),
                  (3, 512, 32, 2)]
# Phase 14's requests (qwen2-vl-2b): r1/r2 share a bucket, r3 and r4
# arrive while the others decode; the cache holds 2080 positions.
QWEN2VL_REQUESTS = [(0, 2048, 32, 0), (1, 1024, 32, 0), (2, 1024, 32, 0),
                    (3, 256, 32, 1), (4, 512, 32, 3)]
QWEN2VL_MAX_LEN = 2080
# Phase 13 (whisper-base): B = 4 clips of 1500 frames, a 4-token prompt,
# 60 greedy decode steps; the self-attention cache holds 65 positions (a
# second kv tile of one key).
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 4, 4, 60
WHISPER_MAX_LEN = WHISPER_PROMPT + WHISPER_STEPS + 1
# Phase 8's MLP projections (hymba-1.5b: d_model 1600, d_ff 5504): gate/up
# (M, 1600, 5504) and down (M, 5504, 1600) at its prompt lengths and its
# per-slot decode (M = 1).
MAIN_GEMM.update({
    f"hymba {what} M={m} mlp {proj}": (m, k, n)
    for what, ms in (("prefill", sorted({p for _, p, _, _ in HYMBA_REQUESTS})),
                     ("decode", (1,)))
    for m in ms
    for proj, k, n in (("up", 1600, 5504), ("down", 5504, 1600))})
# Phases 12-14's MLPs: vilbert-large (both streams 1024 <-> 4096, M = 2 x
# each kept count), whisper-base (512 <-> 2048: the encoder's M = 4 x 1500,
# the prompt's 4 x 4, a decode step's 4) and qwen2-vl-2b (gate/up 1536 ->
# 8960, down 8960 -> 1536: the forward's 4096, the served prompts, decode
# buckets of 1 to 4).
MAIN_GEMM.update({
    f"vilbert-large M={2 * n} mlp {proj}": (2 * n, k, m)
    for n in (4096, 2816, 2048, 1408)
    for proj, k, m in (("up", 1024, 4096), ("down", 4096, 1024))})
MAIN_GEMM.update({
    f"whisper {what} M={m} mlp {proj}": (m, k, n)
    for what, m in (("encode", WHISPER_B * 1500),
                    ("prefill", WHISPER_B * WHISPER_PROMPT),
                    ("decode", WHISPER_B))
    for proj, k, n in (("up", 512, 2048), ("down", 2048, 512))})
MAIN_GEMM.update({
    f"qwen2-vl {what} M={m} mlp {proj}": (m, k, n)
    for what, ms in (("forward", (4096,)),
                     ("prefill",
                      sorted({p for _, p, _, _ in QWEN2VL_REQUESTS})),
                     ("decode", (1, 2, 3, 4)))
    for m in ms
    for proj, k, n in (("up", 1536, 8960), ("down", 8960, 1536))})
# Phase 16's tile_gemm calls (deepseek-v3-671b, d_model 7168): the dense
# prefix's MLP (gate/up 7168 -> 18432, down 18432 -> 7168) and the shared
# expert's (7168 <-> 2048) at the forward's and served prompts' M and the
# per-slot decode's M = 1.  grok-1 has neither.
MAIN_GEMM.update({
    f"deepseek-v3 {what} M={m} {mlp} {proj}": (m, k, n)
    for what, ms in (("prefill", MOE_PROMPTS), ("decode", (1,)))
    for m in ms
    for mlp, f in (("mlp", 18432), ("shared expert", 2048))
    for proj, k, n in (("up", 7168, f), ("down", f, 7168))})
# Full width and full depth in bf16 (~8.3, ~14.5 and ~8.0 GB of weights),
# each model freed before the next.  The forward at DENSE3_S tokens, then
# the Engine serves DENSE3_REQUESTS (rid, prompt length, new tokens,
# arrival step): r0 and r1 share a bucket, r2 arrives while they decode.
# h2o-danube3's prompts are longer than its 4096-key window, so its ring
# wraps in prefill and stays wrapped while it decodes.
DENSE3 = ("minitron-4b", "starcoder2-7b", "h2o-danube3-4b")
DENSE3_S = 1024
DENSE3_REQUESTS = {
    "minitron-4b": [(0, 1024, 16, 0), (1, 1024, 16, 0), (2, 256, 16, 1)],
    "starcoder2-7b": [(0, 1024, 16, 0), (1, 1024, 16, 0), (2, 256, 16, 1)],
    "h2o-danube3-4b": [(0, 4500, 16, 0), (1, 4500, 16, 0),
                       (2, 1024, 16, 1)]}
DENSE3_MAX_LEN = {a: max(p + n for _, p, n, _ in r) + 8
                  for a, r in DENSE3_REQUESTS.items()}
# The f32 checks at 2 layers: prompts of DENSE3_CHECK_S tokens (h2o-danube3
# past its window, so that its ring has wrapped).
DENSE3_CHECK_S = {"minitron-4b": 256, "starcoder2-7b": 256,
                  "h2o-danube3-4b": 4200}
DENSE3_PROMPTS = {a: sorted({DENSE3_S} | {p for _, p, _, _ in r})
                  for a, r in DENSE3_REQUESTS.items()}
# Phase 17's kernel shapes: causal GQA flash at the forward's and served
# prompts (h2o-danube3: hd 120, window 4096, its 4500-token prompts past
# the window) and at the f32 checks' prompts (flash's f32 route), decode
# attention's buckets (r0 and r1 at their last step; h2o-danube3's ring
# of 4096 keys full, r2's not), and the MLP projections (GELU up/down:
# minitron 3072 <-> 9216, starcoder2 4608 <-> 18432; SwiGLU gate/up/down:
# h2o-danube3 3840 <-> 10240) at the prompts' M and decode's M = 1, 2.
DENSE3_WIDTHS = {  # arch: (Hq, Hkv, hd, window, d_model, d_ff)
    "minitron-4b": (24, 8, 128, 0, 3072, 9216),
    "starcoder2-7b": (36, 4, 128, 0, 4608, 18432),
    "h2o-danube3-4b": (32, 8, 120, 4096, 3840, 10240)}


def dense3_shapes():
    """Phase 17's (flash, decode, GEMM) main shapes, named by arch."""
    flash, decode, gemm = {}, {}, {}
    for arch, (hq, hkv, hd, win, d, ff) in DENSE3_WIDTHS.items():
        for s in sorted(set(DENSE3_PROMPTS[arch]) | {DENSE3_CHECK_S[arch]}):
            flash[f"{arch} prefill {s}"] = (1, hq, hkv, s, s, hd, True, win)
        reqs, max_len = DENSE3_REQUESTS[arch], DENSE3_MAX_LEN[arch]
        w = min(max_len, win or max_len)
        last = reqs[0][1] + reqs[0][2] - 1          # r0 and r1's last step
        alone = reqs[2][1] + reqs[2][2] - 1         # r2's
        decode[f"{arch} bucket of 2"] = (2, hq, hkv, w, hd,
                                         (min(last, w),) * 2)
        decode[f"{arch} bucket of 1"] = (1, hq, hkv, w, hd, min(alone, w))
        gemm.update({
            f"{arch} {what} M={m} mlp {proj}": (m, k, n)
            for what, ms in (("prefill", DENSE3_PROMPTS[arch]),
                             ("decode", (1, 2)))
            for m in ms
            for proj, k, n in (("up", d, ff), ("down", ff, d))})
    return flash, decode, gemm


DENSE3_FLASH, DENSE3_DECODE, DENSE3_GEMM = dense3_shapes()
MAIN_FLASH.update(DENSE3_FLASH)
MAIN_GEMM.update(DENSE3_GEMM)
# B, S, H, P, N, chunk: the JAX package's test_ssd_kernel_interpret cases
# (the last one ragged), then every prefill of phases 7 (mamba2-780m: H 48,
# P 64, N 128) and 8 (hymba-1.5b: H 25, P 128, N 16), chunk 256.
SSD_CASES = [(1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 64),
             (1, 200, 3, 16, 8, 64)]
MAIN_SSD = {f"mamba2-780m prefill {s}": (1, s, 48, 64, 128, 256)
            for s in sorted({plen for _, plen, _, _ in MAMBA2_REQUESTS})}
MAIN_SSD.update({f"hymba-1.5b prefill {s}": (1, s, 25, 128, 16, 256)
                 for s in sorted({plen for _, plen, _, _ in HYMBA_REQUESTS})})
# tile_gemm is also timed at these main-path shapes, each against the
# mma route (the first port's kernel, unchanged: the parent's kernel) in
# turns, and against torch.matmul.
GEMM_TIMED = ("text mlp up", "text mlp down", "vision mlp",
              "qwen3 prefill M=1024 mlp up",
              "qwen3 prefill M=1024 mlp down", "qwen3 decode M=3 mlp up",
              "qwen3 decode M=3 mlp down", "qwen3 decode M=1 mlp up",
              "qwen3 decode M=1 mlp down", "hymba prefill M=3000 mlp up",
              "hymba prefill M=3000 mlp down", "hymba decode M=1 mlp up",
              "hymba decode M=1 mlp down")
TIMED = {"decode_attention": "qwen3-32b bucket of 4",
         "flash_attention": "vision self 4096",
         "stream_attention": "vision self 4096",
         "tile_gemm": "text mlp up",
         "ssd_scan": "mamba2-780m prefill 2048"}


def no_live_key(Sq: int, Sk: int, causal: bool, window: int,
                kv_len) -> torch.Tensor:
    """The query rows of a case (q_offset Sk - Sq when causal) that have no
    live key.  Such a row takes the softmax of equal -1e30 scores, as
    ref_attention does: the mean of V over the Sk keys."""
    kv_len = Sk if kv_len is None else kv_len
    qpos = torch.arange(Sq, device="cuda") + (Sk - Sq if causal else 0)
    if kv_len == 0:
        return torch.ones_like(qpos, dtype=torch.bool)
    if window > 0:
        return qpos >= kv_len + window - 1
    return torch.zeros_like(qpos, dtype=torch.bool)


def check_mean_rows(name, case, got, v, dead):
    """The rows with no live key against the mean of V (B, Hkv, Sk, hdv)
    over its keys."""
    if not dead.any():
        return
    B, Hq = got.shape[:2]
    mean = v.float().mean(dim=2).repeat_interleave(Hq // v.shape[1], dim=1)
    compare(name, f"{case}, rows with no live key against the mean of V",
            got[:, :, dead], mean[:, :, None].expand(-1, -1, int(dead.sum()),
                                                     -1))


def check_live_tiles():
    """The kernels' live kv tiles (read from the library) against their
    Python mirror, at every 128-row span of every flash case."""
    for B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len in \
            FLASH_CASES + FLASH_WIDE_CASES:
        kw = dict(kv_len=Sk if kv_len is None else kv_len, causal=causal,
                  window=window, q_offset=Sk - Sq if causal else 0)
        for r0 in range(0, Hq // Hkv * Sq, 64):
            r1 = min(r0 + 128, Hq // Hkv * Sq)
            got = live_tiles(r0, r1, Sq, sk=Sk, **kw)
            want = blocked.live_kv_tiles(r0, r1, Sq, sk=Sk, **kw)
            if got != want:
                fail(f"flash_attention live kv tiles of rows [{r0}, {r1}) "
                     f"at {(Sq, Sk)} {kw}: library {got}, "
                     f"blocked.live_kv_tiles {want}")
    say("  live kv tiles: the library's rule equals blocked.live_kv_tiles "
        "at every flash case")


def check_flash_route(case: str, dt, hd: int, hdv: int, n0: int,
                      routes0: dict) -> str:
    """The route of the flash launches since (n0, routes0): all on
    blocked.flash_route's, which the library's last-launch record names
    too."""
    want = blocked.flash_route(dt, hd, hdv)
    n = flash_attention.launches - n0
    got = {r: flash_attention.routes[r] - routes0[r] for r in routes0}
    code = _build.last_launch("flash_attention")[0]
    if got != {**dict.fromkeys(routes0, 0), want: n} or \
            code != blocked.FLASH_ROUTES.index(want):
        fail(f"flash_attention {case}: routes {got} (library's last launch "
             f"route {code}); all {n} launches must take the {want} route "
             f"(code {blocked.FLASH_ROUTES.index(want)})")
    return want


def check_flash(gen, report):
    name = "flash_attention"
    check_live_tiles()
    for dt in DTYPES:
        for B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len in \
                FLASH_CASES + FLASH_WIDE_CASES:
            q = randn(gen, B, Hq, Sq, hd, dtype=dt, scale=0.5)
            k = randn(gen, B, Hkv, Sk, hd, dtype=dt, scale=0.5)
            v = randn(gen, B, Hkv, Sk, hdv, dtype=dt, scale=0.5)
            kw = dict(causal=causal, window=window,
                      q_offset=Sk - Sq if causal else 0, kv_len=kv_len)
            case = f"{dt} case {(B, Hq, Hkv, Sq, Sk, hd, hdv)}"
            n0, routes0 = flash_attention.launches, dict(flash_attention.routes)
            got = flash_attention(q, k, v, **kw)
            route = check_flash_route(case, dt, hd, hdv, n0, routes0)
            err = compare(name, case, got,
                          blocked.flash_attention_plain(q, k, v, **kw))
            check_mean_rows(name, case, got, v,
                            no_live_key(Sq, Sk, causal, window, kv_len))
            extra = ""
            if route == "wide":
                if not torch.equal(flash_attention(q, k, v, **kw), got):
                    fail(f"{name} {case}: two calls of the wide route differ")
                extra = ", wide route, bitwise deterministic"
            say(f"  {name} {str(dt)[6:]} {(B, Hq, Hkv, Sq, Sk, hd, hdv)} "
                f"causal={causal} window={window} kv_len={kv_len}: "
                f"max|err| {err:.2e}{extra}")
        for case, (B, H, Hkv, Sq, Sk, hd, causal, window) in \
                MAIN_FLASH.items():
            q = randn(gen, B, H, Sq, hd, dtype=dt)
            k = randn(gen, B, Hkv, Sk, hd, dtype=dt)
            v = randn(gen, B, Hkv, Sk, hd, dtype=dt)
            kw = dict(causal=causal, window=window,
                      q_offset=Sk - Sq if causal else 0)
            got = flash_attention(q, k, v, **kw)
            err = compare(name, f"{dt} {case}", got,
                          blocked.flash_attention_plain(q, k, v, **kw))
            ms = time_ms(lambda: flash_attention(q, k, v, **kw))
            flops = 4 * B * H * hd * live_pairs(Sq, Sk, **kw)
            say(f"  {name} {str(dt)[6:]} main path {case}: max|err| "
                f"{err:.2e}; {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
                f"over the live keys")
            if dt == torch.bfloat16 and case == TIMED[name]:
                e = q.element_size()
                flops = 4 * B * H * Sq * Sk * hd
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * e
                report[name] = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: flash_attention(q, k, v)),
                    device_ms=device_ms(lambda: flash_attention(q, k, v))[0],
                    plain_ms=time_ms(
                        lambda: blocked.flash_attention_plain(q, k, v)),
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v)),
                    shape=f"q/k/v {(B, H, Sq, hd)} bf16",
                    flops=flops, bytes=nbytes, dtype=dt, shapes=[])
        for case, (B, H, Hkv, Sq, Sk, hd, hdv, causal) in \
                {**MAIN_FLASH_MLA, **MLA_LONG}.items():
            q = randn(gen, B, H, Sq, hd, dtype=dt, scale=0.5)
            k = randn(gen, B, Hkv, Sk, hd, dtype=dt, scale=0.5)
            v = randn(gen, B, Hkv, Sk, hdv, dtype=dt, scale=0.5)
            n0, routes0 = flash_attention.launches, dict(flash_attention.routes)
            got = flash_attention(q, k, v, causal=causal)
            route = check_flash_route(f"{dt} {case}", dt, hd, hdv, n0, routes0)
            err = compare(name, f"{dt} {case}", got,
                          blocked.flash_attention_plain(q, k, v,
                                                        causal=causal))
            if route == "wide" and not torch.equal(
                    flash_attention(q, k, v, causal=causal), got):
                fail(f"{name} {dt} {case}: two calls of the wide route differ")
            ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
            flops = 2 * B * H * (hd + hdv) * live_pairs(
                Sq, Sk, causal, 0, Sk - Sq if causal else 0)
            say(f"  {name} {str(dt)[6:]} main path {case} "
                f"{(B, H, Hkv, Sq, Sk, hd, hdv)} causal={causal}: max|err| "
                f"{err:.2e}; {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
                f"over the live keys; {route} route"
                + (", bitwise deterministic" if route == "wide" else ""))
            if dt == torch.bfloat16 and case in MLA_TIMED:
                report.setdefault(name, {"shapes": []})["shapes"].append(
                    time_flash_mla(case, q, k, v, causal, err))
            del q, k, v, got


def sdpa_gqa(q, k, v, causal: bool):
    """SDPA with k/v broadcast to q's heads: an expanded view for one kv
    head (MQA), copies otherwise."""
    H, Hkv = q.shape[1], k.shape[1]
    if Hkv == 1:
        k, v = k.expand(-1, H, -1, -1), v.expand(-1, H, -1, -1)
    else:
        k, v = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal)


def sdpa_backends(q, k, v, causal: bool) -> list:
    """The SDPA backends that accept the call, in the order PyTorch tries
    them; the default call takes the first."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for b in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                sdpa_gqa(q, k, v, causal)
            ok.append(b.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    return ok


def attention_chain(q, k, v, causal: bool):
    """matmul, softmax (f32), matmul: the unfused library chain."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
    if causal:
        Sq, Sk = s.shape[-2:]
        s.masked_fill_(torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
                       .triu(Sk - Sq + 1), float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), v)


def time_flash_mla(case, q, k, v, causal, err):
    """The wide route at MLA's shape, bf16: kernel (CUDA events) and device
    (profiler) time, the plain version, SDPA (the backend it takes) and the
    matmul-softmax-matmul chain, against the bound of the live (query, key)
    pairs' FLOPs.  Fails unless the kernel is faster than SDPA.  Its
    launches are not counted."""
    B, H, Sq, hd = q.shape
    Sk, hdv = k.shape[2], v.shape[3]
    n0, routes0 = flash_attention.launches, dict(flash_attention.routes)
    fn = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
    ms = time_ms(fn)
    dev, kernels, per = device_ms(fn)
    flash_attention.launches, flash_attention.routes = n0, routes0
    plain_ms = time_ms(lambda: blocked.flash_attention_plain(
        q, k, v, causal=causal))
    backends = sdpa_backends(q, k, v, causal)
    lib_ms = time_ms(lambda: sdpa_gqa(q, k, v, causal))
    lib_dev = device_ms(lambda: sdpa_gqa(q, k, v, causal))[0]
    chain_ms = time_ms(lambda: attention_chain(q, k, v, causal))
    pairs = live_pairs(Sq, Sk, causal, 0, Sk - Sq if causal else 0)
    flops = 2 * B * H * pairs * (hd + hdv)
    nbytes = (q.numel() + k.numel() + v.numel() + B * H * Sq * hdv) \
        * q.element_size()
    b_ms, b_by = bound(flops, nbytes, q.dtype)
    say(f"    timed {case}: kernel {ms:.4f} ms, device {dev:.4f} ms in "
        f"{kernels:g} launch ({', '.join(map(kernel_name, per))}), "
        f"{flops / dev / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; SDPA "
        f"{lib_ms:.3f} ms (device {lib_dev:.3f}; backends that take it: "
        f"{backends}); matmul-softmax-matmul {chain_ms:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}): device {dev / b_ms:.1f}x bound")
    if not ms < lib_ms:
        fail(f"flash_attention {case}: the wide route ({ms:.4f} ms) is not "
             f"faster than SDPA ({lib_ms:.4f} ms)")
    return dict(name=case, max_abs_err=err, ms=ms, device_ms=dev,
                plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, library_backends=backends,
                chain_ms=chain_ms, bound_ms=b_ms, bound_by=b_by,
                flops=flops, bytes=nbytes)


def live_pairs(Sq: int, Sk: int, causal: bool = False, window: int = 0,
               q_offset: int = 0) -> int:
    """(query, key) pairs of one head that the mask leaves live."""
    qpos = np.arange(Sq) + q_offset
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


def check_stream(gen, report):
    name = "stream_attention"
    shapes = []
    for dt in DTYPES:
        for (B, Hq, Hkv, Sq, Sk, hd, D, causal, window, rope, knorm,
             kv_len) in STREAM_CASES:
            q = randn(gen, B, Hq, Sq, hd, dtype=dt, scale=0.5)
            x = randn(gen, B, Sk, D, dtype=dt, scale=0.5)
            wk = randn(gen, D, Hkv, hd, dtype=dt, scale=D ** -0.5)
            wv = randn(gen, D, Hkv, hd, dtype=dt, scale=D ** -0.5)
            sin = cos = kg = None
            if rope:
                sin, cos = ref.rope_tables(Sk, hd, device="cuda")
            if knorm:
                kg = randn(gen, hd, scale=0.1) + 1.0
            kw = dict(sin=sin, cos=cos, k_gamma=kg, causal=causal,
                      window=window, q_offset=Sk - Sq if causal else 0,
                      kv_len=kv_len)
            case = f"{dt} case {(B, Hq, Hkv, Sq, Sk, hd, D)}"
            got = stream_attention(q, x, wk, wv, **kw)
            err = compare(name, case, got,
                          blocked.stream_attention_plain(q, x, wk, wv, **kw))
            check_mean_rows(name, case, got,
                            torch.einsum("btd,dhe->bhte", x.float(),
                                         wv.float()),
                            no_live_key(Sq, Sk, causal, window, kv_len))
            say(f"  {name} {str(dt)[6:]} {(B, Hq, Hkv, Sq, Sk, hd, D)} "
                f"causal={causal} window={window} rope={rope} "
                f"knorm={knorm} kv_len={kv_len}: max|err| {err:.2e}")
        for case, (B, H, Sq, Sk, hd, D) in MAIN_STREAM.items():
            q = randn(gen, B, H, Sq, hd, dtype=dt)
            x = randn(gen, B, Sk, D, dtype=dt)
            wk = randn(gen, D, H, hd, dtype=dt, scale=D ** -0.5)
            wv = randn(gen, D, H, hd, dtype=dt, scale=D ** -0.5)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = stream_attention(q, x, wk, wv)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            if extra > got.numel() * got.element_size() + (1 << 20):
                fail(f"{name} {case}: the call allocated {extra} bytes beyond "
                     f"its output: K/V must stay on chip")
            err = compare(name, f"{dt} {case}", got,
                          blocked.stream_attention_plain(q, x, wk, wv))
            say(f"  {name} {str(dt)[6:]} main path {case}: max|err| "
                f"{err:.2e}; allocated beyond the output: "
                f"{extra - got.numel() * got.element_size()} bytes")
            if dt == torch.bfloat16 and case in STREAM_TIMED:
                shapes.append(time_stream(case, q, x, wk, wv, err))
            if dt == torch.bfloat16 and case == TIMED[name]:
                flops, nbytes = stream_work(q, x, wk, wv)
                report[name] = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: stream_attention(q, x, wk, wv)),
                    device_ms=device_ms(
                        lambda: stream_attention(q, x, wk, wv))[0],
                    plain_ms=time_ms(
                        lambda: blocked.stream_attention_plain(q, x, wk, wv)),
                    library_ms=time_ms(lambda: stream_library(q, x, wk, wv)),
                    shape=f"q {(B, H, Sq, hd)}, x_kv {(B, Sk, D)} bf16",
                    flops=flops, bytes=nbytes, dtype=dt,
                    regeneration=regeneration(1, Sq))
    report[name]["shapes"] = shapes


def stream_work(q, x, wk, wv):
    """(FLOPs, bytes) of one stream_attention call of MHA q (B, H, Sq, hd)
    over x_kv (B, Sk, D): the K/V generation and the attention, each input
    read once and the output written once."""
    B, H, Sq, hd = q.shape
    Sk, D = x.shape[1:]
    flops = 4 * B * H * Sq * Sk * hd + 4 * B * Sk * D * H * hd
    nbytes = (2 * q.numel() + x.numel() + wk.numel()
              + wv.numel()) * q.element_size()
    return flops, nbytes


def stream_library(q, x, wk, wv):
    """The same function by library calls: K/V by matmul, then SDPA."""
    B, H, _, hd = q.shape
    Sk, D = x.shape[1:]
    k = (x.reshape(B * Sk, D) @ wk.reshape(D, H * hd)) \
        .view(B, Sk, H, hd).transpose(1, 2)
    v = (x.reshape(B * Sk, D) @ wv.reshape(D, H * hd)) \
        .view(B, Sk, H, hd).transpose(1, 2)
    return F.scaled_dot_product_attention(q, k, v)


def time_stream(case, q, x, wk, wv, err):
    """The kernel against its plain version and the library calls at one
    main shape, bf16, by CUDA events and by the profiler's device time;
    each K/V tile must be generated once (regeneration 1).  Its launches
    are not counted."""
    Sq = q.shape[2]
    if regeneration(1, Sq) != 1:
        fail(f"stream_attention {case}: K/V regeneration "
             f"x{regeneration(1, Sq)}, expected 1")
    n0 = stream_attention.launches
    flops, nbytes = stream_work(q, x, wk, wv)
    ms = time_ms(lambda: stream_attention(q, x, wk, wv))
    dev, kernels, _ = device_ms(lambda: stream_attention(q, x, wk, wv))
    plain_ms = time_ms(lambda: blocked.stream_attention_plain(q, x, wk, wv))
    lib_ms = time_ms(lambda: stream_library(q, x, wk, wv))
    lib_dev = device_ms(lambda: stream_library(q, x, wk, wv))[0]
    stream_attention.launches = n0
    b_ms, b_by = bound(flops, nbytes, q.dtype)
    say(f"    timed {case}: kernel {ms:.4f} ms, device {dev:.4f} ms in "
        f"{kernels:g} launch; plain {plain_ms:.4f} ms; matmul K/V + SDPA "
        f"{lib_ms:.4f} ms (device {lib_dev:.4f}); bound {b_ms:.4f} ms "
        f"({b_by}): device {dev / b_ms:.1f}x bound; K/V regeneration x1")
    return dict(name=case, max_abs_err=err, ms=ms, device_ms=dev,
                plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
                flops=flops, bytes=nbytes, regeneration=1)


# ---------------------------------------------------------------------------
# Phase 3 (training): the backward kernels against their plain versions
# ---------------------------------------------------------------------------

# B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len (None = Sk)
FLASH_BWD_CASES = [
    (1, 4, 4, 128, 128, 128, 128, False, 0, None),   # MHA square
    (2, 8, 2, 256, 256, 128, 128, True, 0, None),    # GQA causal
    (1, 4, 2, 128, 384, 128, 128, True, 0, None),    # causal, offset KV
    (2, 4, 4, 128, 256, 64, 64, True, 100, None),    # sliding window
    (2, 4, 2, 100, 200, 64, 64, True, 50, 170),      # ragged Sq/Sk + kv_len
    (1, 4, 1, 77, 150, 96, 32, False, 0, None),      # hdv != hd, ragged
    (2, 4, 2, 96, 200, 32, 32, True, 64, 190),       # hd = 32, ragged
    # rows with no live key (see no_live_key)
    (1, 2, 1, 300, 300, 64, 64, False, 32, 100),
    (2, 8, 2, 130, 700, 128, 128, True, 8, 600),
]
# B, Hq, Hkv, Sq, Sk, hd, D, causal, window, rope, knorm, kv_len
STREAM_BWD_CASES = [
    (1, 4, 4, 128, 128, 128, 256, False, 0, False, False, None),
    (2, 8, 2, 128, 256, 128, 256, True, 0, True, False, None),
    (1, 4, 2, 128, 128, 128, 384, True, 0, True, True, None),
    (1, 4, 2, 128, 256, 128, 256, True, 96, True, False, None),
    (2, 4, 2, 100, 200, 64, 96, True, 0, True, True, 170),   # ragged
    (2, 4, 2, 96, 200, 32, 150, True, 0, True, True, 190),   # hd = 32
    (1, 4, 1, 77, 150, 96, 100, False, 0, False, True, None),  # hd = 96
    (1, 64, 8, 256, 256, 128, 5120, True, 0, True, True, None),  # qwen3
    # rows with no live key (see no_live_key)
    (1, 2, 1, 300, 300, 64, 128, False, 32, True, False, 100),
    (1, 8, 2, 130, 700, 128, 256, True, 8, True, True, 600),
]
# The training path's attention shapes (phase 10): vilbert-base at B = 2,
# N = 4096 in the text-only layers and the first co-TRM block, and at the
# kept counts of DTPU pruning in the later blocks (EXPECTED_COUNTS: 2816,
# 2048, 1408; both streams keep the same count, so flash's co-attention has
# the shape of the self-attention of its query stream); qwen3-32b at B = 1,
# S = 4096, causal GQA, whose TILE_STREAM layers resolve to flash
# (2 Hkv hd = 2048 < d 5120).
PRUNED = sorted({n for pair in EXPECTED_COUNTS[1:] for n in pair},
                reverse=True)
MAIN_FLASH_BWD = {  # name: (B, Hq, Hkv, Sq, Sk, hd, causal, window)
    "vision self 4096": (2, 8, 8, 4096, 4096, 128, False, 0),
    "text self 4096": (2, 12, 12, 4096, 4096, 64, False, 0),
    **{f"vision self/co {n}": (2, 8, 8, n, n, 128, False, 0)
       for n in PRUNED},
    **{f"text self/co {n}": (2, 12, 12, n, n, 64, False, 0)
       for n in PRUNED},
    "qwen3-32b train 4096": (1, 64, 8, 4096, 4096, 128, True, 0),
    # phase 22's h2o-danube3-4b at S = 8192: hd 120 and a 4096-key window,
    # so that whole kv tiles of a query span fall outside the window
    "h2o-danube3-4b train 8192": (1, 32, 8, 8192, 8192, 120, True, 4096),
}
# qwen3-32b's heads past 4096 keys (held on the seeds' draws only): the dQ
# pass sums up to S / 64 kv tiles a row.
LONG_FLASH_BWD = {f"qwen3-32b train {S}": (1, 64, 8, S, S, 128, True, 0)
                  for S in (8192, 16384)}
MAIN_STREAM_BWD = {  # name: (B, H, Sq, Sk, hd, D)
    f"{stream} {n}": (2, H, n, n, hd, D) for n in (4096, *PRUNED)
    for stream, H, hd, D in (("vision self", 8, 128, 1024),
                             ("text self", 12, 64, 768),
                             ("vision co", 8, 128, 768),
                             ("text co", 12, 64, 1024))}
BWD_TIMED = {"flash_attention_bwd": "vision self 4096",
             "stream_attention_bwd": "vision self 4096"}
# The tc backward at qwen3-32b's training shape on draws of their own
# besides phase 3's: dK and dV sum 8 heads x 4096 query rows a key, where
# one tensor-core accumulator carried over every span drifted past the
# bf16 limit on some draws (dV 1.1x); the kernel now adds sums of a few
# spans in f32 (DkvAcc::flush).
FLASH_BWD_SEEDS = (1, 2, 3, 4)


def compare_grads(name: str, case: str, got, want) -> float:
    """Each gradient against the plain version's, through ``compare``;
    returns the largest error."""
    return max(compare(name, f"{case} d{label}", g, w)
               for label, g, w in zip(GRAD_NAMES[name], got, want)
               if w is not None)


GRAD_NAMES = {"flash_attention_bwd": ("q", "k", "v"),
              "stream_attention_bwd": ("q", "x_kv", "wk", "wv", "gamma"),
              "ssd_scan_bwd": ("x", "dt", "a", "b", "c")}


def check_deterministic(name: str, case: str, fn, first) -> None:
    """A second call gives bitwise-equal gradients."""
    again = fn()
    for label, a, b in zip(GRAD_NAMES[name], first, again):
        if a is not None and not torch.equal(a, b):
            fail(f"{name} {case}: d{label} differs bitwise between two calls")


def flash_bwd_flops(B, H, Sq, Sk, hd, hdv, causal=False, window=0,
                    q_offset=0) -> int:
    """The backward's products, once each: S = Q K^T and dK = dS^T Q and
    dQ = dS K (hd wide), dP = dO V^T and dV = P^T dO (hdv wide), over the
    live (query, key) pairs."""
    pairs = live_pairs(Sq, Sk, causal=causal, window=window,
                       q_offset=q_offset)
    return 2 * B * H * pairs * (3 * hd + 2 * hdv)


def stream_bwd_flops(B, Hq, Hkv, Sq, Sk, hd, D, causal=False, window=0,
                     q_offset=0) -> int:
    """The attention backward's products over the live pairs plus K and V
    generated from x_kv (2 products) and their gradients (dx: 2, dW: 2)."""
    return (flash_bwd_flops(B, Hq, Sq, Sk, hd, hd, causal=causal,
                            window=window, q_offset=q_offset)
            + 6 * 2 * B * Sk * D * Hkv * hd)


@contextlib.contextmanager
def simt_route():
    """The backward wrappers with their route rule replaced by "simt": the
    parent's kernels (the first port's, kept as the simt route), for timing
    in turns.  Their launches are taken back out of the counters."""
    fns = (flash_attention_bwd, stream_attention_bwd)
    saved = (flash_vjp.flash_bwd_route, flash_vjp.stream_bwd_route,
             [(fn.launches, dict(fn.routes)) for fn in fns])
    flash_vjp.flash_bwd_route = flash_vjp.stream_bwd_route = \
        lambda *shape: "simt"
    try:
        yield
    finally:
        flash_vjp.flash_bwd_route, flash_vjp.stream_bwd_route, counters = saved
        for fn, (n, routes) in zip(fns, counters):
            fn.launches, fn.routes = n, routes


def check_bwd_route(name: str, case: str, fn, run, want: str) -> tuple:
    """run() through the wrapper ``fn``, which must take route ``want``."""
    before = dict(fn.routes)
    got = run()
    if fn.routes[want] != before[want] + 1:
        fail(f"{name} {case}: took route {dict(fn.routes)} (before "
             f"{before}), expected {want}")
    return got


def time_bwd(name: str, key: str, run, flops: int) -> dict:
    """The tc route against the simt route (the parent's kernels) in turns
    at one main shape, bf16, each also by its device time per kernel; at
    the timed shape (BWD_TIMED) the tc route must be the faster."""
    def parent():
        with simt_route():
            return run()

    ms, parent_ms, t = in_turns(parent, run)
    # a trace that lost launches (the profiler drops some) is taken again
    for _ in range(3):
        dev, _, parts = device_ms(run, reps=5)
        parent_dev, _, parent_parts = device_ms(parent, reps=3)
        if dev > ms / 2 and parent_dev > parent_ms / 2:
            break
    else:
        fail(f"{name} {key}: the profiler's device time ({dev:.3f}, simt "
             f"{parent_dev:.3f} ms) lost launches in three traces")

    def by_kernel(p):
        return ", ".join(f"{kernel_name(k)} {v:.3f}" for k, v in p.items())

    say(f"    timed {key}: tc {ms:.3f} ms ({t[1]:.3f}, {t[2]:.3f}), "
        f"device {dev:.3f} [{by_kernel(parts)}]; simt {parent_ms:.3f} ms "
        f"({t[0]:.3f}, {t[3]:.3f}), device {parent_dev:.3f} "
        f"[{by_kernel(parent_parts)}]; tc {parent_ms / ms:.1f}x faster, "
        f"{flops / dev / 1e9:.1f} TFLOP/s of the function")
    if key == BWD_TIMED[name] and not ms < parent_ms:
        fail(f"{name} {key}: the tc route ({ms:.3f} ms) is not faster than "
             f"the simt route ({parent_ms:.3f} ms)")
    return dict(name=key, ms=ms, device_ms=dev, parent_ms=parent_ms,
                parent_device_ms=parent_dev,
                kernels={kernel_name(k): v for k, v in parts.items()},
                parent_kernels={kernel_name(k): v
                                for k, v in parent_parts.items()})


def check_bwd_rules():
    """The libraries' route rules and the stream backward's slots against
    their Python mirrors (blocked.flash_bwd_route, stream_bwd_route,
    stream_bwd_slots) at every case and training shape."""
    for dt in DTYPES:
        code = _build.DTYPE_CODES[dt]
        shapes = {(hd, hdv) for *_, hd, hdv, _, _, _ in FLASH_BWD_CASES} | {
            (v[5], v[5]) for v in MAIN_FLASH_BWD.values()} | {
            (c[5], c[6]) for c in FLASH_BWD_WIDE_CASES}
        for hd, hdv in shapes:
            got = flash_vjp.library_route("flash", code, hd, hdv)
            if got != blocked.flash_bwd_route(dt, hd, hdv):
                fail(f"flash_attention_bwd route of {dt} {(hd, hdv)}: "
                     f"library {got}, blocked {blocked.flash_bwd_route(dt, hd, hdv)}")
        shapes = {(c[1], c[2], c[4], c[5], c[6]) for c in STREAM_BWD_CASES} | {
            (v[1], v[1], v[3], v[4], v[5]) for v in MAIN_STREAM_BWD.values()}
        for Hq, Hkv, Sk, hd, D in shapes:
            route = blocked.stream_bwd_route(dt, hd, D, Hkv)
            got = flash_vjp.library_route("stream", code, hd, D, Hkv)
            if got != route:
                fail(f"stream_attention_bwd route of {dt} {(Hkv, hd, D)}: "
                     f"library {got}, blocked {route}")
            for B in (1, 2):
                lib = flash_vjp.stream_slots(route, B, Sk, Hkv, hd)
                if lib != blocked.stream_bwd_slots(route, B, Sk, Hkv, hd):
                    fail(f"stream_attention_bwd slots of {route} "
                         f"{(B, Sk, Hkv, hd)}: library {lib}, blocked "
                         f"{blocked.stream_bwd_slots(route, B, Sk, Hkv, hd)}")
        for P, N in {(c[3], c[4]) for c in SSD_BWD_CASES} | {
                (v[3], v[4]) for v in MAIN_SSD_BWD.values()}:
            got = ssd_lib.library_bwd_route(code, P, N)
            if got != blocked.ssd_bwd_route(dt, P, N):
                fail(f"ssd_scan_bwd route of {dt} {(P, N)}: library {got}, "
                     f"blocked {blocked.ssd_bwd_route(dt, P, N)}")
    for gc in sorted({blocked.flash_bwd_wide_heads(B, Hq, Hkv, Sq, Sk)
                      for B, Hq, Hkv, Sq, Sk, *_ in FLASH_BWD_WIDE_CASES}
                     | {blocked.flash_bwd_wide_heads(B, Hq, Hkv, Sq, Sk)
                        for B, Hq, Hkv, Sq, Sk, *_
                        in MAIN_FLASH_BWD_WIDE.values()} | {1, 16, 64, 128}):
        if flash_vjp.wide_splits(gc) != blocked.flash_bwd_wide_splits(gc):
            fail(f"flash_attention_bwd wide splits of {gc} heads: library "
                 f"{flash_vjp.wide_splits(gc)}, blocked "
                 f"{blocked.flash_bwd_wide_splits(gc)}")
    say("  backward routes, slots and splits: the libraries' rules equal "
        "blocked's at every case and training shape")


def limit_share(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of ``got`` as a share of ``compare``'s limit."""
    atol, rtol, *_ = TOL[name][got.dtype]
    g, w = got.float(), want.float()
    return ((g - w).abs() / (atol + rtol * w.abs())).max().item()


def check_flash_bwd_seeds():
    """The tc backward at qwen3-32b's training shapes, 4096 and past it
    (LONG_FLASH_BWD), bf16, against its plain version on the
    FLASH_BWD_SEEDS draws; prints each gradient's largest error as a share
    of the limit."""
    name = "flash_attention_bwd"
    shapes = {"qwen3-32b train 4096": MAIN_FLASH_BWD["qwen3-32b train 4096"],
              **LONG_FLASH_BWD}
    for key, (B, H, Hkv, Sq, Sk, hd, causal, _) in shapes.items():
        kw = dict(causal=causal, q_offset=Sk - Sq if causal else 0)
        shares = []
        t0 = time.perf_counter()
        for seed in FLASH_BWD_SEEDS:
            g = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v, do = (randn(g, B, n, S, hd, dtype=torch.bfloat16)
                           for n, S in ((H, Sq), (Hkv, Sk), (Hkv, Sk),
                                        (H, Sq)))
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            want = blocked.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     **kw)
            compare_grads(name, f"bf16 {key} seed {seed}", got, want)
            shares.append(", ".join(
                f"d{label} {limit_share(name, a, b):.2f}" for label, a, b in
                zip(GRAD_NAMES[name], got, want)))
            del q, k, v, do, out, lse, got, want
            free()
        say(f"  {name} bfloat16 {key}, tc route, seeds {FLASH_BWD_SEEDS}: "
            f"largest error a share of the limit: " + "; ".join(shares)
            + f" ({time.perf_counter() - t0:.1f} s)")


def check_flash_bwd(gen, report):
    name = "flash_attention_bwd"
    shapes = []
    for dt in DTYPES:
        cases = [(c, False) for c in FLASH_BWD_CASES] + [
            ((B, H, Hkv, Sq, Sk, hd, hd, causal, window, None), key)
            for key, (B, H, Hkv, Sq, Sk, hd, causal, window)
            in MAIN_FLASH_BWD.items()]
        for (B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len), key \
                in cases:
            sc = 0.5 if not key else 1.0
            q = randn(gen, B, Hq, Sq, hd, dtype=dt, scale=sc)
            k = randn(gen, B, Hkv, Sk, hd, dtype=dt, scale=sc)
            v = randn(gen, B, Hkv, Sk, hdv, dtype=dt, scale=sc)
            do = randn(gen, B, Hq, Sq, hdv, dtype=dt)
            kw = dict(causal=causal, window=window,
                      q_offset=Sk - Sq if causal else 0, kv_len=kv_len)
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            _, lse_plain = blocked.flash_attention_plain(q, k, v,
                                                         return_lse=True, **kw)
            case = f"{dt} {key or 'case'} {(B, Hq, Hkv, Sq, Sk, hd, hdv)}"
            compare("flash_attention", f"{case} lse", lse, lse_plain)

            def run():
                return flash_attention_bwd(q, k, v, out, lse, do, **kw)

            route = blocked.flash_bwd_route(dt, hd, hdv)
            got = check_bwd_route(name, case, flash_attention_bwd, run, route)
            err = compare_grads(name, case, got, blocked.flash_attention_bwd_plain(
                q, k, v, out, lse, do, **kw))
            check_deterministic(name, case, run, got)
            say(f"  {name} {str(dt)[6:]} {key or 'case'} "
                f"{(B, Hq, Hkv, Sq, Sk, hd, hdv)} causal={causal} "
                f"window={window} kv_len={kv_len}, {route} route: max|err| "
                f"{err:.2e}, bitwise deterministic")
            if not (key and dt == torch.bfloat16):
                continue
            flops = flash_bwd_flops(B, Hq, Sq, Sk, hd, hdv, **{
                k_: kw[k_] for k_ in ("causal", "window", "q_offset")})
            shapes.append(dict(time_bwd(name, key, run, flops),
                               max_abs_err=err))
            if key == BWD_TIMED[name]:
                e = q.element_size()
                qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
                ref_out = F.scaled_dot_product_attention(qr, kr, vr)

                def library():
                    return torch.autograd.grad(ref_out, (qr, kr, vr), do,
                                               retain_graph=True)

                report[name] = dict(
                    shapes[-1],
                    plain_ms=time_ms(lambda: blocked.flash_attention_bwd_plain(
                        q, k, v, out, lse, do, **kw)),
                    library_ms=time_ms(library),
                    shape=f"q/k/v/dO {(B, Hq, Sq, hd)} bf16 (SDPA's backward "
                          f"as the library call)",
                    flops=flops,
                    bytes=(4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * e
                    + 4 * lse.numel(), dtype=dt)
                del ref_out
    check_flash_bwd_seeds()
    report.setdefault(name, {})["shapes"] = shapes


def check_stream_bwd(gen, report):
    name = "stream_attention_bwd"
    shapes = []
    for dt in DTYPES:
        cases = [(c, False) for c in STREAM_BWD_CASES] + [
            ((B, H, H, Sq, Sk, hd, D, False, 0, False, False, None), key)
            for key, (B, H, Sq, Sk, hd, D) in MAIN_STREAM_BWD.items()]
        for (B, Hq, Hkv, Sq, Sk, hd, D, causal, window, rope, knorm,
             kv_len), key in cases:
            sc = 0.5 if not key else 1.0
            q = randn(gen, B, Hq, Sq, hd, dtype=dt, scale=sc)
            x = randn(gen, B, Sk, D, dtype=dt, scale=sc)
            wk = randn(gen, D, Hkv, hd, dtype=dt, scale=D ** -0.5)
            wv = randn(gen, D, Hkv, hd, dtype=dt, scale=D ** -0.5)
            do = randn(gen, B, Hq, Sq, hd, dtype=dt)
            sin = cos = kg = None
            if rope:
                sin, cos = ref.rope_tables(Sk, hd, device="cuda")
            if knorm:
                kg = randn(gen, hd, scale=0.1) + 1.0
            kw = dict(sin=sin, cos=cos, k_gamma=kg, causal=causal,
                      window=window, q_offset=Sk - Sq if causal else 0,
                      kv_len=kv_len)
            out, lse = stream_attention(q, x, wk, wv, return_lse=True, **kw)
            _, lse_plain = blocked.stream_attention_plain(
                q, x, wk, wv, return_lse=True, **kw)
            case = f"{dt} {key or 'case'} {(B, Hq, Hkv, Sq, Sk, hd, D)}"
            compare("stream_attention", f"{case} lse", lse, lse_plain)

            def run():
                return stream_attention_bwd(q, x, wk, wv, out, lse, do, **kw)

            route = blocked.stream_bwd_route(dt, hd, D, Hkv)
            got = check_bwd_route(name, case, stream_attention_bwd, run,
                                  route)
            err = compare_grads(name, case, got,
                                blocked.stream_attention_bwd_plain(
                                    q, x, wk, wv, out, lse, do, **kw))
            check_deterministic(name, case, run, got)
            say(f"  {name} {str(dt)[6:]} {key or 'case'} "
                f"{(B, Hq, Hkv, Sq, Sk, hd, D)} causal={causal} "
                f"window={window} rope={rope} knorm={knorm} "
                f"kv_len={kv_len}, {route} route: max|err| {err:.2e}, "
                f"bitwise deterministic")
            if not (key and dt == torch.bfloat16):
                continue
            flops = stream_bwd_flops(B, Hq, Hkv, Sq, Sk, hd, D)
            G = Hq // Hkv
            scratch = {r: blocked.stream_bwd_scratch_bytes(r, B, Sk, D, Hkv,
                                                           hd)
                       for r in blocked.BWD_ROUTES}
            regen = {"tc": flash_vjp.regeneration(G, Sq),
                     "simt": -(-G * Sq // 64)}
            shapes.append(dict(time_bwd(name, key, run, flops),
                               max_abs_err=err, dw_scratch_bytes=scratch,
                               regeneration=regen))
            say(f"    {key}: dW_K, dW_V scratch {scratch['tc']:,} bytes "
                f"each (simt {scratch['simt']:,}); dQ K/V regeneration "
                f"x{regen['tc']} (simt x{regen['simt']})")
            if key == BWD_TIMED[name]:
                e = q.element_size()
                x2 = x.reshape(B * Sk, D)
                wk2, wv2 = wk.reshape(D, Hkv * hd), wv.reshape(D, Hkv * hd)

                def heads(t):
                    return t.view(B, Sk, Hkv, hd).transpose(1, 2)

                qr = q.detach().requires_grad_()
                kr = heads(x2 @ wk2).detach().requires_grad_()
                vr = heads(x2 @ wv2).detach().requires_grad_()
                ref_out = F.scaled_dot_product_attention(qr, kr, vr)

                def library():
                    # generation, SDPA's backward, then dx and dW
                    heads(x2 @ wk2), heads(x2 @ wv2)
                    _, dk, dv = torch.autograd.grad(
                        ref_out, (qr, kr, vr), do, retain_graph=True)
                    dk2 = dk.transpose(1, 2).reshape(B * Sk, Hkv * hd)
                    dv2 = dv.transpose(1, 2).reshape(B * Sk, Hkv * hd)
                    return (dk2 @ wk2.t() + dv2 @ wv2.t(), x2.t() @ dk2,
                            x2.t() @ dv2)

                report[name] = dict(
                    shapes[-1],
                    plain_ms=time_ms(lambda: blocked.stream_attention_bwd_plain(
                        q, x, wk, wv, out, lse, do, **kw)),
                    library_ms=time_ms(library),
                    shape=f"q/dO {(B, Hq, Sq, hd)}, x_kv {(B, Sk, D)} bf16 "
                          f"(library: matmul K/V generation, SDPA's "
                          f"backward, the dx/dW matmuls)",
                    flops=flops,
                    bytes=(4 * q.numel() + 2 * x.numel() + 2 * wk.numel()
                           + 2 * wv.numel()) * e + 4 * lse.numel(),
                    dtype=dt)
                del ref_out
    report.setdefault(name, {})["shapes"] = shapes


def check_gemm_rules():
    """The library's route and split rules against their Python mirrors
    (blocked.gemm_route, blocked.gemm_splits) at every case, main shape
    and M of 1..20 at the main paths' (K, N)."""
    shapes = set(GEMM_CASES) | set(MAIN_GEMM.values())
    shapes |= {(m, k, n) for m in range(1, 21)
               for _, k, n in MAIN_GEMM.values()}
    for M, K, N in sorted(shapes):
        for dt, code in _build.DTYPE_CODES.items():
            got = route_of(M, K, N, code)
            if got != blocked.gemm_route(M, K, N, dt):
                fail(f"tile_gemm route at {(M, K, N)} {dt}: library {got}, "
                     f"blocked.gemm_route {blocked.gemm_route(M, K, N, dt)}")
        if splits_of(K, N) != blocked.gemm_splits(K, N):
            fail(f"tile_gemm splits at {(K, N)}: library {splits_of(K, N)}, "
                 f"blocked.gemm_splits {blocked.gemm_splits(K, N)}")
    say(f"  tile_gemm: the library's route and split rules equal "
        f"blocked.gemm_route / gemm_splits at {len(shapes)} shapes")


def check_gemm_rows(gen):
    """splitk: row i of an M = 3 (and M = 4) call equals the M = 1 call on
    row i, bitwise, at qwen3-32b's decode shapes."""
    for dt in DTYPES:
        for proj, K, N in (("up", 5120, 25600), ("down", 25600, 5120)):
            w = randn(gen, K, N, dtype=dt, scale=K ** -0.5)
            x = randn(gen, 4, K, dtype=dt)
            for M in (3, 4):
                got = tile_gemm(x[:M], w)
                for i in range(M):
                    if not torch.equal(got[i:i + 1], tile_gemm(x[i:i + 1], w)):
                        fail(f"tile_gemm splitk {dt} mlp {proj}: row {i} of "
                             f"the M = {M} call differs from the M = 1 call")
            say(f"  tile_gemm splitk {str(dt)[6:]} qwen3 mlp {proj} {(K, N)}: "
                f"rows of M = 3 and 4 calls equal the M = 1 calls bitwise")


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous view 2 bytes past a 16-byte boundary:
    the wrapper then sends a bf16 product that wgmma would take to the mma
    route."""
    view = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return view.view(x.shape).copy_(x)


def parent_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The parent's kernel at any shape: the library's mma route (the
    first port's kernel, its source unchanged), launched through the C
    interface.  The wrapper never takes mma at M <= M_SMALL, so the timing
    in turns launches it here; it counts no launch."""
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _build.raise_on("tile_gemm (mma route)", tile_gemm_lib._lib()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[x.dtype], blocked.GEMM_ROUTES.index("mma"),
        M, N, K, None, None, _build.stream_ptr(x.device)))
    return out


def time_gemm(case, x, w, err, shapes):
    """Kernel, parent (the mma route) in turns, torch.matmul and bound at
    one main-path shape, bf16."""
    M, K = x.shape
    N = w.shape[1]
    route = blocked.gemm_route(M, K, N, x.dtype)
    turns = [time_ms(lambda: fn(x, w))
             for fn in (parent_gemm, tile_gemm, tile_gemm, parent_gemm)]
    ms, parent = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    lib = time_ms(lambda: torch.matmul(x, w))
    flops, nbytes = 2 * M * K * N, (M * K + K * N + M * N) * x.element_size()
    b_ms, b_by = bound(flops, nbytes, x.dtype)
    rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if b_by == "operations"
            else f"{nbytes / ms / 1e9:.3f} TB/s")
    say(f"    timed: {route} {ms:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}), "
        f"{rate}; parent (mma) {parent:.4f} ms ({turns[0]:.4f}, "
        f"{turns[3]:.4f}); torch.matmul {lib:.4f} ms; bound {b_ms:.4f} ms "
        f"({b_by}); {ms / lib:.2f}x matmul, {ms / b_ms:.2f}x bound")
    shapes.append(dict(name=case, shape=[M, K, N], route=route, ms=ms,
                       parent_ms=parent, library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=err))
    return ms, lib


def check_gemm(gen, report):
    name = "tile_gemm"
    check_gemm_rules()
    shapes = []
    for dt in DTYPES:
        cases = [(c, c) for c in GEMM_CASES] + list(MAIN_GEMM.items())
        for case, (M, K, N) in cases:
            x = randn(gen, M, K, dtype=dt)
            w = randn(gen, K, N, dtype=dt, scale=K ** -0.5)
            route = blocked.gemm_route(M, K, N, dt)
            before = tile_gemm.routes[route]
            got = tile_gemm(x, w)
            if tile_gemm.routes[route] != before + 1:
                fail(f"{name} {dt} {case}: did not take the {route} route")
            want = blocked.tile_gemm_plain(x, w)
            err = compare(name, f"{dt} {case} ({route})", got, want)
            line = (f"  {name} {str(dt)[6:]} {case} (M, K, N) = {(M, K, N)}, "
                    f"{route}: max|err| {err:.2e}")
            if route == "wgmma":     # also through mma, the parent's kernel
                before = tile_gemm.routes["mma"]
                got_mma = tile_gemm(misaligned(x), w)
                if tile_gemm.routes["mma"] != before + 1:
                    fail(f"{name} {dt} {case}: an x off 16-byte alignment "
                         f"did not take the mma route")
                line += ", mma route %.2e" % compare(
                    name, f"{dt} {case} (mma route)", got_mma, want)
            say(line)
            if dt != torch.bfloat16 or case not in GEMM_TIMED:
                continue
            ms, lib = time_gemm(case, x, w, err, shapes)
            if case == TIMED[name]:
                e = x.element_size()
                report[name] = dict(
                    max_abs_err=err, ms=ms,
                    device_ms=device_ms(lambda: tile_gemm(x, w))[0],
                    plain_ms=time_ms(lambda: blocked.tile_gemm_plain(x, w)),
                    library_ms=lib, shape=f"(M, K, N) {(M, K, N)} bf16",
                    flops=2 * M * K * N,
                    bytes=(M * K + K * N + M * N) * e, dtype=dt,
                    shapes=shapes)
    check_gemm_rows(gen)


# B, Hq, Hkv, W, hd, window, cache_len (an int: scalar for every row)
DECODE_CASES = [
    (3, 8, 2, 200, 32, 0, (0, 200, 77)),     # GQA, W % 64 != 0, 0 and W
    (2, 4, 4, 130, 24, 0, (1, 130)),         # MHA, hd = 24
    (4, 64, 8, 300, 128, 0, 257),            # scalar cache_len
    (3, 8, 2, 500, 128, 100, (500, 99, 300)),  # window
    (2, 16, 2, 1000, 64, 0, (1000, 513)),    # four W chunks, hd = 64
    (1, 8, 8, 64, 128, 17, (5,)),            # window wider than the row
]
# The decode steps of the main paths at W = max_len: name: (B, Hq, Hkv, W,
# hd, cache_len).  Phase 5 calls the kernel on qwen3-32b buckets of 3 and
# of 1 with a scalar cache_len; the timed one holds all four slots with
# phase 5's lengths, per row.  Phase 8 calls it on hymba-1.5b's ring of
# the 1024-key window, one slot at a time, full or not.
MAIN_DECODE = {
    "qwen3-32b bucket of 4": (4, 64, 8, 2048, 128, (1025, 1025, 1025, 1537)),
    "qwen3-32b bucket of 3": (3, 64, 8, 2048, 128, 1025),
    "qwen3-32b bucket of 1": (1, 64, 8, 2048, 128, 1537),
    "hymba-1.5b bucket of 1": (1, 25, 5, 1024, 64, 700),
    "hymba-1.5b bucket of 1, full ring": (1, 25, 5, 1024, 64, 1024),
    # phase 13: whisper-base's plain (B, 8, 65, 64) cache, MHA; phase 14:
    # qwen2-vl-2b's GQA 12/2 buckets over 2080 positions
    "whisper bucket of 4": (4, 8, 8, WHISPER_MAX_LEN, 64, 34),
    "whisper bucket of 4, last step": (4, 8, 8, WHISPER_MAX_LEN, 64,
                                       WHISPER_MAX_LEN - 1),
    "qwen2-vl bucket of 2": (2, 12, 2, QWEN2VL_MAX_LEN, 128, 1040),
    "qwen2-vl bucket of 1": (1, 12, 2, QWEN2VL_MAX_LEN, 128, 2079),
    # phase 15: grok-1-314b's GQA 48/8 buckets over MOE_MAX_LEN positions,
    # r0 and r1 at their last step, r2 alone
    "grok-1 bucket of 2": (2, 48, 8, MOE_MAX_LEN, 128, (1039, 1039)),
    "grok-1 bucket of 1": (1, 48, 8, MOE_MAX_LEN, 128, 271),
}
MAIN_DECODE.update(DENSE3_DECODE)       # phase 17's buckets (see above)
# decode attention is also timed at these, against the parent's kernel and
# SDPA in turns, with each one's device time from the profiler.
DECODE_TIMED = ("qwen3-32b bucket of 4", "hymba-1.5b bucket of 1")


def _decode_inputs(gen, B, Hq, Hkv, W, hd, clen, dt):
    q = randn(gen, B, Hq, 1, hd, dtype=dt)
    k = randn(gen, B, Hkv, W, hd, dtype=dt)
    v = randn(gen, B, Hkv, W, hd, dtype=dt)
    lens = torch.tensor(clen, dtype=torch.int32, device="cuda") \
        if isinstance(clen, tuple) else clen
    return q, k, v, lens


def check_batch_invariance(gen, name, case, q, k, v, lens, window=0):
    """Row i of the batched call equals the B = 1 call on row i, bitwise.
    A single row is also checked as row 0 of a batch of three, beside two
    rows with other lengths (1 and W)."""
    if q.shape[0] == 1:
        W = k.shape[2]
        q2, k2, v2 = (torch.cat([t, randn(gen, 2, *t.shape[1:],
                                          dtype=t.dtype)])
                      for t in (q, k, v))
        li = lens[0].item() if isinstance(lens, torch.Tensor) else lens
        lens2 = torch.tensor([li, 1, W], dtype=torch.int32, device="cuda")
        got = decode_attention(q2, k2, v2, lens2, window=window)
        if not torch.equal(got[:1], decode_attention(q, k, v, lens,
                                                     window=window)):
            fail(f"{name} {case}: the row in a batch of three differs from "
                 f"the B = 1 call")
        return
    got = decode_attention(q, k, v, lens, window=window)
    for i in range(q.shape[0]):
        li = lens[i:i + 1] if isinstance(lens, torch.Tensor) else lens
        solo = decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], li,
                                window=window)
        if not torch.equal(got[i:i + 1], solo):
            fail(f"{name} {case}: row {i} of the batched call differs from "
                 f"the B = 1 call")


def check_decode_rules():
    """The library's tc split rule against its Python mirror
    (blocked.decode_splits) at every case, main shape and W of 1..4096
    for 1..16, 25 and 64 kv heads."""
    shapes = {(W, Hkv) for W in range(1, 4097)
              for Hkv in (*range(1, 17), 25, 64)}
    shapes |= {(c[3], c[2]) for c in DECODE_CASES}
    shapes |= {(c[3], c[2]) for c in MAIN_DECODE.values()}
    for W, Hkv in sorted(shapes):
        got, want = decode_lib.splits_of(W, Hkv), blocked.decode_splits(W, Hkv)
        if got != want:
            fail(f"decode_attention splits at (W, Hkv) = {(W, Hkv)}: library "
                 f"{got}, blocked.decode_splits {want}")
    say(f"  decode_attention: the library's split rule equals "
        f"blocked.decode_splits at {len(shapes)} (W, Hkv); at the main "
        f"shapes (splits, tiles per split): "
        + ", ".join(f"{n} {blocked.decode_splits(c[3], c[2])}"
                    for n, c in MAIN_DECODE.items()))


def parent_decode(q, k, v, lens):
    """The parent's kernel: the library's simt route (the first port's
    kernel), launched through the C interface in the dtype it is given;
    it counts no launch."""
    B, Hq, _, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    clen, clen0 = decode_lib._row_lengths(lens, B, q.device)
    part = torch.empty(B * Hq * decode_lib._simt_splits(W) * (2 + hd),
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.raise_on("decode_attention (simt route)", decode_lib._lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if clen is None else clen.data_ptr(), out.data_ptr(),
        part.data_ptr(), None, blocked.DECODE_ROUTES.index("simt"),
        _build.DTYPE_CODES[q.dtype], B, Hq, Hkv, W, hd, hd ** -0.5, 0, clen0,
        _build.stream_ptr(q.device)))
    return out


def device_ms(fn, reps: int = 20, tries: int = 5):
    """(device time per call in ms, kernel launches per call, {kernel: ms
    per call}) of fn() under torch.profiler, after a warm-up outside the
    trace: the kernels' own time, without the host's share of a call.  A
    trace that gives no device time (the profiler now and then drops a
    trace's kernels, three times in a row once at a 0.3 ms call) is taken
    again, up to ``tries`` times, each twice as long as the last."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        reps_now = reps << attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps_now):
                fn()
            torch.cuda.synchronize()
        # Per kernel: its mean time a launch times its launches a call, the
        # count rounded, so that an event the trace drops changes neither.
        per_call = {e.key: (e.self_device_time_total / e.count / 1e3,
                            round(e.count / reps_now))
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.count}
        total = sum(ms * n for ms, n in per_call.values())
        if total > 0:
            return (total, sum(n for _, n in per_call.values()),
                    {k: ms * n for k, (ms, n) in per_call.items() if n})
        say(f"    torch.profiler gave no device time in trace {attempt + 1} "
            f"of {reps_now} calls")
    fail(f"torch.profiler gave no device time in {tries} traces")


def kernel_name(key: str) -> str:
    """A kernel's function name from its demangled profiler key."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", key)
    return m.group(1) if m else key[:24]


def in_turns(base, new):
    """time_ms of base, new, new, base: (new, base, the four times)."""
    t = [time_ms(f) for f in (base, new, new, base)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def time_decode(case, q, k, v, lens, err):
    """The kernel against the parent's kernel and SDPA, in turns (host
    clock per call, CUDA events) and by the profiler's device time, at
    one main shape, bf16.  The tc route must be one launch."""
    B, Hq, _, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    lens_t = (lens if isinstance(lens, torch.Tensor) else torch.full(
        (B,), lens, dtype=torch.int32, device="cuda"))
    mask = (torch.arange(W, device="cuda")[None, :] < lens_t[:, None]
            )[:, None, None, :]

    def ours():
        return decode_attention(q, k, v, lens)

    def parent():
        return parent_decode(q, k, v, lens)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    n0 = decode_attention.launches
    ms, parent_ms, tp = in_turns(parent, ours)
    _, sdpa_ms, ts = in_turns(sdpa, ours)
    dev, kernels, _ = device_ms(ours)
    parent_dev, parent_kernels, _ = device_ms(parent)
    sdpa_dev, sdpa_kernels, _ = device_ms(sdpa)
    decode_attention.launches = n0          # timing launches are not counted
    if kernels != 1:
        fail(f"decode_attention {case}: {kernels} kernels per call, the tc "
             f"route must be one launch")
    clen = lens_t.tolist()
    nbytes = (2 * sum(clen) * Hkv * hd + 2 * q.numel()) * q.element_size()
    b_ms, b_by = bound(4 * sum(clen) * Hq * hd, nbytes, q.dtype)
    say(f"    timed {case}: kernel {ms:.4f} ms ({tp[1]:.4f}, {tp[2]:.4f}; "
        f"with SDPA {ts[1]:.4f}, {ts[2]:.4f}), device {dev:.4f} ms in "
        f"{kernels:g} launch; parent {parent_ms:.4f} ms ({tp[0]:.4f}, "
        f"{tp[3]:.4f}), device {parent_dev:.4f} ms in {parent_kernels:g}; "
        f"SDPA {sdpa_ms:.4f} ms ({ts[0]:.4f}, {ts[3]:.4f}), device "
        f"{sdpa_dev:.4f} ms in {sdpa_kernels:g}; bound {b_ms:.4f} ms "
        f"({b_by}): device {dev / b_ms:.1f}x bound, "
        f"{nbytes / dev / 1e9:.2f} TB/s")
    return dict(name=case, max_abs_err=err, ms=ms, device_ms=dev,
                parent_ms=parent_ms, parent_device_ms=parent_dev,
                library_ms=sdpa_ms, library_device_ms=sdpa_dev,
                bound_ms=b_ms, bound_by=b_by, flops=4 * sum(clen) * Hq * hd,
                bytes=nbytes)


def check_decode(gen, report):
    name = "decode_attention"
    check_decode_rules()
    shapes = []
    for dt in DTYPES:
        want_route = "tc" if dt == torch.bfloat16 else "simt"
        cases = ([(f"case {c[:5]} window={c[5]} cache_len={c[6]}", c)
                  for c in DECODE_CASES]
                 + [(n, (*c[:5], 0, c[5])) for n, c in MAIN_DECODE.items()])
        for case, (B, Hq, Hkv, W, hd, window, clen) in cases:
            q, k, v, lens = _decode_inputs(gen, B, Hq, Hkv, W, hd, clen, dt)
            before = decode_attention.routes[want_route]
            got = decode_attention(q, k, v, lens, window=window)
            if decode_attention.routes[want_route] != before + 1:
                fail(f"{name} {dt} {case}: did not take the {want_route} "
                     f"route")
            err = compare(name, f"{dt} {case}", got,
                          blocked.decode_attention_plain(q, k, v, lens,
                                                         window=window))
            check_batch_invariance(gen, name, f"{dt} {case}", q, k, v, lens,
                                   window)
            say(f"  {name} {str(dt)[6:]} {case} {(B, Hq, Hkv, W, hd)}, "
                f"{want_route}: max|err| {err:.2e}, batch-invariant")
            if dt != torch.bfloat16 or case not in DECODE_TIMED:
                continue
            timed = time_decode(case, q, k, v, lens, err)
            shapes.append(timed)
            if case == TIMED[name]:
                report[name] = dict(
                    timed, plain_ms=time_ms(
                        lambda: blocked.decode_attention_plain(q, k, v, lens)),
                    shape=f"q {(B, Hq, 1, hd)}, k/v {(B, Hkv, W, hd)}, "
                          f"cache_len {clen} bf16", dtype=dt, shapes=shapes)


def mamba2_rates(gen, H):
    """Per-head step-size bias and decay rate from Mamba-2's initial
    ranges: head h steps around exp(lerp(log 1e-3, log 1e-1, h / (H - 1)))
    (the bias is softplus^-1 of that) and decays at a rate A in [1, 16],
    so head 0 carries its state across hundreds of rows.  The reference
    test's inputs (dt ~ 0.8, A ~ 1) and the JAX init (a_log = dt_bias = 0)
    forget the state within one 64-row chunk, which would leave the carry
    between chunks unchecked.  Returns (dt_bias, -A), both (H,) f32."""
    step = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                    device="cuda"))
    bias = step + torch.log(-torch.expm1(-step))          # softplus^-1
    return bias, -(1 + 15 * torch.rand(H, generator=gen, device="cuda"))


def _ssd_inputs(gen, B, S, H, P, N, dt):
    """x, b, c in ``dt`` as the reference test draws them; the step sizes
    (softplus of noise plus the bias) and decay rates (f32) from
    ``mamba2_rates`` instead."""
    bias, a = mamba2_rates(gen, H)
    return (randn(gen, B, S, H, P, dtype=dt, scale=0.5),
            F.softplus(randn(gen, B, S, H, scale=0.5) + bias), a,
            randn(gen, B, S, N, dtype=dt, scale=0.3),
            randn(gen, B, S, N, dtype=dt, scale=0.3))


def ssd_flops(B, S, H, P, N) -> int:
    """The fewest FLOPs the SSD takes in its chunked form, over every chunk
    length L (L = 1 is the sequential scan): per (b, chunk of l rows)
    C.B^T 2.l^2.N, once for all heads; per (b, h, chunk) M.U 2.l^2.P,
    C.state 2.l.N.P, the state update 2.l.P.N and its decay P.N.  The
    element-wise masks and exponentials are left out: a count from below."""
    def chunk(l):
        return 2 * l * l * N + H * (2 * l * l * P + 4 * l * N * P + P * N)

    def at(L):
        n, r = divmod(S, L)
        return B * (n * chunk(L) + (chunk(r) if r else 0))
    return min(at(L) for L in range(1, S + 1))


def parent_ssd(x, dt, a, b, c):
    """The parent's kernel: the library's simt route (the first port's
    kernel), launched through the C interface in the dtype it is given;
    it counts no launch."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    _build.raise_on("ssd_scan (simt route)", ssd_lib._lib()(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(), None,
        blocked.SSD_ROUTES.index("simt"), _build.DTYPE_CODES[x.dtype],
        B, S, H, P, N, _build.stream_ptr(x.device)))
    return y, state


def time_ssd(case, args, chunk, err):
    """The kernel against the parent's kernel in turns (host clock per
    call, CUDA events) and by the profiler's device time, at one main
    shape, bf16.  The bound: the larger of the bytes and the function's
    FLOPs at the bf16 peak.  Printed beside it, not as bounds: the FLOPs
    at the f32 peak (PR 13-15's bound) and the FLOPs three times (the tc
    route's hi.hi + hi.lo + lo.hi products) at the bf16 peak."""
    x, dtv, a, b, c = args
    B, S, H, P = x.shape
    N = b.shape[-1]

    def ours():
        return ssd_scan(*args, chunk=chunk)

    def parent():
        return parent_ssd(*args)

    n0 = ssd_scan.launches
    ms, parent_ms, t = in_turns(parent, ours)
    dev, kernels, stages = device_ms(ours)
    parent_dev, parent_kernels, _ = device_ms(parent)
    ssd_scan.launches = n0                  # timing launches are not counted
    flops = ssd_flops(B, S, H, P, N)
    nbytes = ((2 * x.numel() + 2 * b.numel()) * x.element_size()
              + (dtv.numel() + a.numel() + B * H * P * N) * 4)
    b_ms, b_by = bound(flops, nbytes, torch.bfloat16)
    f32_ms, _ = bound(flops, nbytes, torch.float32)
    split_ms = 3 * flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    say(f"    timed {case}: kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
        f"device {dev:.4f} ms in {kernels:g} launches; parent {parent_ms:.4f}"
        f" ms ({t[0]:.4f}, {t[3]:.4f}), device {parent_dev:.4f} ms in "
        f"{parent_kernels:g}; {parent_dev / dev:.2f}x faster; bound "
        f"{b_ms:.4f} ms ({b_by}; FLOPs at the f32 peak {f32_ms:.4f} ms, "
        f"split products at the bf16 peak {split_ms:.4f} ms): device "
        f"{dev / b_ms:.1f}x bound, {flops / dev / 1e9:.1f} TFLOP/s of the "
        f"function; by kernel: "
        + ", ".join(f"{kernel_name(k)} {v:.4f}" for k, v in stages.items()))
    return dict(name=case, shape=[B, S, H, P, N], max_abs_err=err, ms=ms,
                device_ms=dev, parent_ms=parent_ms,
                parent_device_ms=parent_dev, bound_ms=b_ms, bound_by=b_by,
                f32_bound_ms=f32_ms, split_products_ms=split_ms,
                flops=flops, bytes=nbytes)


def check_ssd(gen, report):
    name = "ssd_scan"
    shapes = []
    for dt in DTYPES:
        want_route = "tc" if dt == torch.bfloat16 else "simt"
        cases = [(c, c) for c in SSD_CASES] + list(MAIN_SSD.items())
        for case, (B, S, H, P, N, chunk) in cases:
            args = _ssd_inputs(gen, B, S, H, P, N, dt)
            before = ssd_scan.routes[want_route]
            y, st = ssd_scan(*args, chunk=chunk)
            if ssd_scan.routes[want_route] != before + 1:
                fail(f"{name} {dt} {case}: did not take the {want_route} "
                     f"route")
            want_y, want_st = blocked.ssd_chunked_plain(*args, chunk=chunk)
            err = compare(name, f"{dt} {case} y", y, want_y)
            st_err = compare(name, f"{dt} {case} final state", st, want_st)
            say(f"  {name} {str(dt)[6:]} {case} (B, S, H, P, N, chunk) = "
                f"{(B, S, H, P, N, chunk)}, {want_route}: max|err| y "
                f"{err:.2e}, state {st_err:.2e}")
            if dt != torch.bfloat16 or case not in MAIN_SSD:
                continue
            timed = time_ssd(case, args, chunk, max(err, st_err))
            shapes.append(timed)
            if case == TIMED[name]:
                x, b = args[0], args[3]
                report[name] = dict(
                    timed, plain_ms=time_ms(
                        lambda: blocked.ssd_chunked_plain(*args, chunk=chunk)),
                    library_ms=None,  # no single PyTorch call computes SSD
                    shape=f"x {tuple(x.shape)}, b/c {tuple(b.shape)} bf16, "
                          f"chunk {chunk}",
                    dtype=torch.bfloat16, shapes=shapes)


# ---------------------------------------------------------------------------
# Phase 3 (training of the other families): the SSD backward and the flash
# backward's wide route against their plain versions
# ---------------------------------------------------------------------------

# B, S, H, P, N, chunk, with d(final state): the forward's cases, a ragged
# S over chunks of 128, then phase 19's SSM layers (B = 1, S = 2048: mamba2
# H 48, P 64, N 128; hymba H 25, P 128, N 16) and a ragged S at mamba2's
# widths.  The inputs take Mamba-2's initial ranges (mamba2_rates), so the
# state and its gradient carry across chunks.
SSD_BWD_CASES = [(1, 128, 2, 32, 16, 64, False), (2, 256, 4, 64, 32, 64, True),
                 (1, 200, 3, 16, 8, 64, True), (1, 333, 3, 48, 16, 128, False)]
MAIN_SSD_BWD = {  # name: (B, S, H, P, N, chunk)
    "mamba2-780m train 2048": (1, 2048, 48, 64, 128, 256),
    "mamba2-780m ragged 2000": (1, 2000, 48, 64, 128, 256),
    "hymba-1.5b train 2048": (1, 2048, 25, 128, 16, 256),
}
SSD_BWD_TIMED = "mamba2-780m train 2048"
# B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len: the wide route
FLASH_BWD_WIDE_CASES = [
    (1, 4, 1, 64, 64, 576, 512, True, 0, None),      # MLA's widths, MQA
    (1, 8, 1, 130, 200, 576, 512, True, 0, None),    # ragged, query offset
    (2, 4, 2, 96, 96, 192, 160, False, 0, None),     # GQA, just over 128
    (1, 4, 1, 100, 300, 576, 512, True, 0, 250),     # kv_len
    (1, 2, 1, 300, 300, 576, 512, False, 32, 100),   # rows with no live key
]
# Phase 19's MLA attention (deepseek-v3, B = 1, S = 1024; 64 of the 128
# heads a group, two groups), and S = 4096 (4 heads a group).
MAIN_FLASH_BWD_WIDE = {  # name: (B, Hq, Hkv, Sq, Sk, hd, hdv, causal)
    "deepseek-v3 MLA train 1024": (1, 128, 1, 1024, 1024, 576, 512, True),
    "deepseek-v3 MLA train 4096": (1, 128, 1, 4096, 4096, 576, 512, True),
}
FLASH_BWD_WIDE_TIMED = "deepseek-v3 MLA train 1024"


def ssd_bwd_flops(B, S, H, P, N) -> int:
    """The fewest FLOPs of the SSD's gradient in its chunked form, over
    every chunk length L (L = 1: the sequential scan run backward): per
    (b, chunk of l rows) C.B^T 2.l^2.N, once for all heads; per (b, h,
    chunk) the intra-chunk products dy.u^T and W^T dy (2.l^2.P each) and
    Q B, Q^T C (2.l^2.N each), and six state products of 2.l.P.N (the
    state recomputed, the state gradient, S_in^T dy, dS^T u, dS b,
    dy.(S_in c)).  Exponentials and masks left out: a count from below."""
    def chunk(l):
        return 2 * l * l * N + H * (4 * l * l * P + 4 * l * l * N
                                    + 12 * l * P * N)

    def at(L):
        n, r = divmod(S, L)
        return B * (n * chunk(L) + (chunk(r) if r else 0))
    return min(at(L) for L in range(1, S + 1))


def parent_ssd_bwd(x, dt, a, b, c, dy, dstate=None):
    """The parent's kernels: the library's simt route (the first port's
    SIMT f32 kernels, bf16 instantiation), launched through the C
    interface in the dtype it is given; it counts no launch."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    ddt, da = torch.empty_like(dt), torch.empty_like(a)
    scratch = torch.empty(ssd_lib.bwd_scratch_floats(B, S, H, P, N),
                          dtype=torch.float32, device=x.device)
    _build.raise_on("ssd_scan_bwd (simt route)", ssd_lib._bwd_lib()(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        scratch.data_ptr(), blocked.SSD_ROUTES.index("simt"),
        _build.DTYPE_CODES[x.dtype], B, S, H, P, N,
        _build.stream_ptr(x.device)))
    return dx, ddt, da, db, dc


def check_ssd_bwd(gen, report):
    """ssd_scan_bwd against blocked.ssd_scan_bwd_plain in f32 and bf16, at
    the cases and phase 19's shapes, on its route (bf16 tc, f32 simt),
    bitwise deterministic; timed at MAIN_SSD_BWD in bf16 against the
    parent's kernels (the simt route through the C interface) in turns."""
    name = "ssd_scan_bwd"
    shapes = []
    for dt in DTYPES:
        cases = [(c[:6], c[6], "case") for c in SSD_BWD_CASES] + [
            (v, False, k) for k, v in MAIN_SSD_BWD.items()]
        for (B, S, H, P, N, chunk), with_state, key in cases:
            args = _ssd_inputs(gen, B, S, H, P, N, dt)
            dy = randn(gen, B, S, H, P, dtype=dt)
            ds = randn(gen, B, H, P, N) if with_state else None

            def run():
                return ssd_scan_bwd(*args, dy, ds, chunk=chunk)

            case = f"{dt} {key} {(B, S, H, P, N, chunk)}"
            before = ssd_scan_bwd.launches
            got = check_bwd_route(name, case, ssd_scan_bwd, run,
                                  blocked.ssd_bwd_route(dt, P, N))
            if ssd_scan_bwd.launches != before + 1:
                fail(f"{name} {dt} {key}: the kernel did not launch")
            err = compare_grads(name, case, got, blocked.ssd_scan_bwd_plain(
                *args, dy, ds, chunk=chunk))
            check_deterministic(name, case, run, got)
            say(f"  {name} {str(dt)[6:]} {key} (B, S, H, P, N, chunk) = "
                f"{(B, S, H, P, N, chunk)}, d(final state) "
                f"{'given' if with_state else 'None'}, "
                f"{blocked.ssd_bwd_route(dt, P, N)}: max|err| {err:.2e}, "
                f"bitwise deterministic")
            if dt != torch.bfloat16 or key not in MAIN_SSD_BWD:
                continue
            n0, routes0 = ssd_scan_bwd.launches, dict(ssd_scan_bwd.routes)

            def parent():
                return parent_ssd_bwd(*args, dy, ds)

            ms, parent_ms, t = in_turns(parent, run)
            dev, kernels, per = device_ms(run)
            parent_dev, _, parent_per = device_ms(parent, reps=5)
            ssd_scan_bwd.launches, ssd_scan_bwd.routes = n0, routes0
            flops = ssd_bwd_flops(B, S, H, P, N)
            # the function's bytes, each once: x, dy, dx; b, c, db, dc;
            # dt, ddt, a, da in f32 (the chunk states the kernel recomputes
            # into its scratch are its own, not the function's)
            e = args[0].element_size()
            nbytes = ((3 * args[0].numel() + 4 * args[3].numel()) * e
                      + (2 * args[1].numel() + 2 * H) * 4)
            b_ms, b_by = bound(flops, nbytes, torch.bfloat16)
            say(f"    timed {key}: tc {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
                f"device {dev:.4f} ms in {kernels:g} launches; parent (simt) "
                f"{parent_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), device "
                f"{parent_dev:.4f} ms; {parent_dev / dev:.2f}x faster; bound "
                f"{b_ms:.4f} ms ({b_by}): device {dev / b_ms:.1f}x bound, "
                f"{flops / dev / 1e9:.1f} TFLOP/s of the function; by kernel: "
                + ", ".join(f"{kernel_name(k)} {v:.4f}" for k, v in per.items())
                + "; parent: "
                + ", ".join(f"{kernel_name(k)} {v:.4f}"
                            for k, v in parent_per.items()))
            if key == SSD_BWD_TIMED and not ms < parent_ms:
                fail(f"{name} {key}: the tc route ({ms:.4f} ms) is not faster "
                     f"than the parent's simt kernels ({parent_ms:.4f} ms)")
            shapes.append(dict(name=key, shape=[B, S, H, P, N], ms=ms,
                               device_ms=dev, parent_ms=parent_ms,
                               parent_device_ms=parent_dev, max_abs_err=err,
                               bound_ms=b_ms, bound_by=b_by, flops=flops,
                               bytes=nbytes,
                               kernels={kernel_name(k): v
                                        for k, v in per.items()}))
            if key == SSD_BWD_TIMED:
                report[name] = dict(
                    shapes[-1], plain_ms=time_ms(
                        lambda: blocked.ssd_scan_bwd_plain(
                            *args, dy, ds, chunk=chunk)),
                    library_ms=None,   # no single PyTorch call
                    shape=f"x/dy {(B, S, H, P)}, b/c {(B, S, N)} bf16, chunk "
                          f"{chunk}", dtype=torch.bfloat16)
    report.setdefault(name, {})["shapes"] = shapes


def parent_flash_bwd_wide(q, k, v, out, lse, dout, *, causal=False,
                          window=0, q_offset=0, kv_len=None):
    """The parent's kernels: the wide route's first bf16 kernels
    (mma.sync, route 3 of the library's C interface), on the wrapper's
    head groups; it counts no launch."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk, hdv = k.shape[1], k.shape[2], v.shape[3]
    gc = blocked.flash_bwd_wide_heads(B, Hq, Hkv, Sq, Sk)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    scratch = torch.empty(flash_vjp.wide_scratch_floats(B, Hq, Hkv, Sq, Sk,
                                                        hd, hdv, gc),
                          dtype=torch.float32, device=q.device)
    _build.raise_on("flash_attention_bwd (wide route's parent)",
                    flash_vjp._flash_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), 3,
        _build.DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Sk, hd, hdv, hd ** -0.5,
        int(causal), window, q_offset, Sk if kv_len is None else kv_len, gc,
        _build.stream_ptr(q.device)))
    return dq, dk, dv


def check_flash_bwd_wide(gen, report):
    """The flash backward's wide route against its plain version in f32
    and bf16, at the cases and phase 19's MLA shapes, bitwise
    deterministic; timed at FLASH_BWD_WIDE_TIMED in bf16 beside SDPA's
    backward."""
    name = "flash_attention_bwd"
    shapes = []
    for dt in DTYPES:
        cases = [(c, "case") for c in FLASH_BWD_WIDE_CASES] + [
            ((B, H, Hkv, Sq, Sk, hd, hdv, causal, 0, None), key)
            for key, (B, H, Hkv, Sq, Sk, hd, hdv, causal)
            in MAIN_FLASH_BWD_WIDE.items()]
        for (B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len), key \
                in cases:
            q = randn(gen, B, Hq, Sq, hd, dtype=dt, scale=0.5)
            k = randn(gen, B, Hkv, Sk, hd, dtype=dt, scale=0.5)
            v = randn(gen, B, Hkv, Sk, hdv, dtype=dt, scale=0.5)
            do = randn(gen, B, Hq, Sq, hdv, dtype=dt)
            kw = dict(causal=causal, window=window,
                      q_offset=Sk - Sq if causal else 0, kv_len=kv_len)
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            case = f"{dt} {key} {(B, Hq, Hkv, Sq, Sk, hd, hdv)}"

            def run():
                return flash_attention_bwd(q, k, v, out, lse, do, **kw)

            got = check_bwd_route(name, case, flash_attention_bwd, run,
                                  "wide")
            err = compare_grads(name, case, got,
                                blocked.flash_attention_bwd_plain(
                                    q, k, v, out, lse, do, **kw))
            check_deterministic(name, case, run, got)
            if dt == torch.bfloat16 and key == "case":
                again = flash_attention_bwd(misaligned(q), k, v, out, lse,
                                            do, **kw)
                if not all(torch.equal(a, b) for a, b in zip(again, got)):
                    fail(f"{name} {case}: q 2 bytes past a 16-byte boundary "
                         f"changed the gradients")
            say(f"  {name} {str(dt)[6:]} {key} "
                f"{(B, Hq, Hkv, Sq, Sk, hd, hdv)} causal={causal} "
                f"window={window} kv_len={kv_len}, wide route "
                f"({blocked.flash_bwd_wide_heads(B, Hq, Hkv, Sq, Sk)} heads "
                f"a group): max|err| {err:.2e}, bitwise deterministic")
            if dt != torch.bfloat16 or key not in MAIN_FLASH_BWD_WIDE:
                continue
            n0 = flash_attention_bwd.launches
            routes0 = dict(flash_attention_bwd.routes)

            def parent():
                return parent_flash_bwd_wide(q, k, v, out, lse, do, **kw)

            ms, parent_ms, t = in_turns(parent, run)
            dev, kernels, per = device_ms(run, reps=5)
            parent_dev, _, parent_per = device_ms(parent, reps=3)
            flash_attention_bwd.launches = n0
            flash_attention_bwd.routes = routes0
            flops = flash_bwd_flops(B, Hq, Sq, Sk, hd, hdv, **{
                k_: kw[k_] for k_ in ("causal", "window", "q_offset")})
            e = q.element_size()
            nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
                      * e + lse.numel() * 4)
            b_ms, b_by = bound(flops, nbytes, dt)
            say(f"    timed {key}: kernel {ms:.3f} ms ({t[1]:.3f}, "
                f"{t[2]:.3f}), device {dev:.3f} ms in {kernels:g} launches; "
                f"parent (mma.sync) {parent_ms:.3f} ms ({t[0]:.3f}, "
                f"{t[3]:.3f}), device {parent_dev:.3f} ms; "
                f"{parent_dev / dev:.2f}x faster; bound {b_ms:.4f} ms "
                f"({b_by}): device {dev / b_ms:.1f}x bound, "
                f"{flops / dev / 1e9:.1f} TFLOP/s of the function; by "
                f"kernel: " + ", ".join(f"{kernel_name(k_)} {v_:.3f}"
                                        for k_, v_ in per.items())
                + "; parent: " + ", ".join(f"{kernel_name(k_)} {v_:.3f}"
                                           for k_, v_ in parent_per.items()))
            if key == FLASH_BWD_WIDE_TIMED and not ms < parent_ms:
                fail(f"{name} {key}: the wide route ({ms:.3f} ms) is not "
                     f"faster than its parent's kernels ({parent_ms:.3f} ms)")
            shapes.append(dict(name=key, ms=ms, device_ms=dev,
                               parent_ms=parent_ms,
                               parent_device_ms=parent_dev,
                               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                               flops=flops, bytes=nbytes,
                               kernels={kernel_name(k_): v_
                                        for k_, v_ in per.items()}))
            if key != FLASH_BWD_WIDE_TIMED:
                continue
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            backends = sdpa_backends(q, k, v, causal)
            ref_out = sdpa_gqa(qr, kr, vr, causal)

            def library():
                return torch.autograd.grad(ref_out, (qr, kr, vr), do,
                                           retain_graph=True)

            lib_ms = time_ms(library)
            del ref_out
            report["flash_attention_bwd_wide"] = dict(
                shapes[-1],
                plain_ms=time_ms(lambda: blocked.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, **kw)),
                library_ms=lib_ms, library_backend=backends[0],
                shape=f"q {(B, Hq, Sq, hd)}, k {(B, Hkv, Sk, hd)}, v "
                      f"{(B, Hkv, Sk, hdv)} bf16, causal (SDPA's backward "
                      f"on {backends[0]} as the library call)",
                dtype=dt)
            say(f"    SDPA backward {lib_ms:.3f} ms on {backends[0]} (the "
                f"backends that take the forward: {backends})")
    report.setdefault("flash_attention_bwd_wide", {})["shapes"] = shapes


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

# Kernels whose wrappers count launches per route as well.
ROUTED = {"tile_gemm": tile_gemm, "flash_attention": flash_attention,
          "decode_attention": decode_attention,
          "ssd_scan": ssd_scan, "flash_attention_bwd": flash_attention_bwd,
          "stream_attention_bwd": stream_attention_bwd,
          "ssd_scan_bwd": ssd_scan_bwd}
BWD = ("flash_attention_bwd", "stream_attention_bwd")


def reset_counts() -> None:
    for fn, _ in KERNELS.values():
        fn.launches = 0
    for fn in ROUTED.values():
        fn.routes = dict.fromkeys(fn.routes, 0)


def route_counts() -> dict:
    return {name: dict(fn.routes) for name, fn in ROUTED.items()}


def check_kernel_routes(what: str, routes: dict, got: dict) -> None:
    """Fail unless every launch of decode attention and of the SSD scan in
    a bf16 main-path run took the tc route (``routes``: the run's
    route_counts(), ``got``: its counts())."""
    for name in ("decode_attention", "ssd_scan"):
        if routes[name] != {"simt": 0, "tc": got[name]}:
            fail(f"{what}: {name} routes {routes[name]}; every one of its "
                 f"{got[name]} launches must take the tc route")


def flash_route_of(cfg, dtype: torch.dtype = torch.bfloat16) -> str:
    """The route every flash launch of ``cfg``'s path takes in ``dtype``
    (blocked.flash_route): MLA's latent attention (q/k kv_lora_rank +
    qk_rope_head_dim, v kv_lora_rank) the wide route in bf16, the other
    attention kinds' heads tc."""
    if cfg.attn_kind == AttnKind.MLA:
        return blocked.flash_route(dtype, cfg.kv_lora_rank
                                   + cfg.qk_rope_head_dim, cfg.kv_lora_rank)
    return blocked.flash_route(dtype, cfg.head_dim, cfg.head_dim)


def check_flash_routes(what: str, cfg, want_n: int) -> None:
    """Fail unless the flash launches since the last reset_counts() are
    ``want_n``, every one on ``flash_route_of(cfg)``."""
    route = flash_route_of(cfg)
    want = {**dict.fromkeys(flash_attention.routes, 0), route: want_n}
    if flash_attention.routes != want:
        fail(f"{what}: flash_attention routes {flash_attention.routes}, "
             f"expected {want}")


def bwd_routes(cfg, dtype: torch.dtype) -> dict:
    """The route every backward launch of ``cfg``'s training path takes in
    ``dtype``: tc in bf16 and simt in f32, but the flash backward at MLA's
    latent widths (wide, both dtypes); the SSD backward's by its rule
    (tc in bf16 at every SSM family's widths)."""
    base = "tc" if dtype == torch.bfloat16 else "simt"
    want = dict.fromkeys(BWD, base)
    if cfg.attn_kind == AttnKind.MLA:
        want["flash_attention_bwd"] = blocked.flash_bwd_route(
            dtype, cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg.kv_lora_rank)
    want["ssd_scan_bwd"] = (blocked.ssd_bwd_route(
        dtype, ssm_dims(cfg)[3], cfg.ssm_state) if cfg.ssm_state else "simt")
    return want


def check_bwd_routes(what: str, cfg, dtype: torch.dtype) -> None:
    """Fail unless every launch of the backward kernels since the last
    reset_counts() took its route of ``bwd_routes(cfg, dtype)``."""
    for name, want in bwd_routes(cfg, dtype).items():
        fn = ROUTED[name]
        if fn.routes != {**dict.fromkeys(fn.routes, 0), want: fn.launches}:
            fail(f"{what}: {name} routes {fn.routes}; every one of its "
                 f"{fn.launches} launches must take the {want} route")


def tally(launches: dict) -> dict:
    """Add the counters of a main-path run to ``launches`` (its
    "tile_gemm routes" too); returns the run's launches per kernel."""
    got = counts()
    for name, n in got.items():
        launches[name] += n
    for name, fn in ROUTED.items():
        for route, n in fn.routes.items():
            launches[f"{name} routes"][route] += n
    return got


def check_routes(what: str, routes: dict, want: str) -> None:
    """Fail unless tile_gemm launched in ``routes`` (route: launches), and
    every launch took route ``want``."""
    if routes.get(want, 0) == 0 or any(n for r, n in routes.items()
                                       if r != want):
        fail(f"{what}: tile_gemm routes {dict(routes)}; every launch must "
             f"take the {want} route")


def counts() -> dict:
    return {name: fn.launches for name, (fn, _) in KERNELS.items()}


def make_batch(cfg, B: int, n: int, gen) -> dict:
    return {"regions": torch.randn((B, n, cfg.d_model), generator=gen,
                                   device="cuda"),
            "tokens": torch.randint(0, cfg.vocab_size, (B, n), generator=gen,
                                    device="cuda")}


def device_breakdown(model, batch, mode, top: int = 4) -> str:
    """One more forward under torch.profiler: the device-busy share of its
    wall time and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(batch, mode=mode)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t in kernels)
    if busy == 0:
        return "profiler recorded no device time"
    kernels.sort(key=lambda kt: -kt[1])
    parts = ", ".join(f"{k[:48]} {t / 1e3:.1f} ms" for k, t in kernels[:top])
    return (f"device busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms "
            f"wall ({100 * busy / wall_us:.0f}%); top: {parts}")


def stream_gaps(got, want) -> tuple:
    """max |got - want| / max |want| for the vision and language streams."""
    return tuple(round(((g.float() - w.float()).abs().max()
                        / w.float().abs().max()).item(), 8)
                 for g, w in zip(got, want))


def main_path(launches: dict, smi: str, arch: str = "vilbert-base",
              expected: tuple = EXPECTED_COUNTS,
              f32_cut: dict = None) -> None:
    """``arch``'s VQA forward in bf16 (B = 2, N = 4096) in the three
    modes, with its kept counts (``expected``) and launch gates; then the
    three modes in f32 at N = 1024, B = 1, at ``f32_cut``'s depth (full
    depth without one)."""
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = ViLBERT(cfg, device="cuda", generator=gen)
    batch = make_batch(cfg, 2, 4096, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  {arch} bf16, {n_params / 1e6:.1f} M parameters, built in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{smi}]")
    logits, streams = {}, {}
    for mode in ExecutionMode:
        model(batch, mode=mode)                      # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out, kept = model(batch, mode=mode, return_token_counts=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = tally(launches)
        say(f"  {mode.value}: wall {wall:.1f} ms [{smi}], launches {got}, "
            f"tile_gemm routes {tile_gemm.routes}, kept {kept}")
        if out.shape != (2, 3129) or not torch.isfinite(out).all():
            fail(f"{mode.value}: logits {tuple(out.shape)} not finite "
                 f"(2, 3129)")
        if kept != expected:
            fail(f"{arch} {mode.value}: kept counts {kept} != {expected}")
        check_routes(f"{arch} {mode.value}", tile_gemm.routes, "wgmma")
        want_stream = mode == ExecutionMode.TILE_STREAM
        want_flash = mode == ExecutionMode.LAYER_STREAM
        if (got["stream_attention"] > 0) != want_stream \
                or (got["flash_attention"] > 0) != want_flash:
            fail(f"{arch} {mode.value}: attention launches {got} do not "
                 f"fit the mode")
        logits[mode] = out
        streams[mode] = model.encode(batch, mode=mode)[:2]
        say(f"    {mode.value} profile: "
            f"{device_breakdown(model, batch, mode)} [{smi}]")
    for mode in (ExecutionMode.LAYER_STREAM, ExecutionMode.TILE_STREAM):
        gap = (logits[mode] - logits[ExecutionMode.NON_STREAM]).abs().max()
        say(f"  bf16 {mode.value} vs non_stream: max |logit gap| "
            f"{gap.item():.3e}, stream gaps "
            f"{stream_gaps(streams[mode], streams[ExecutionMode.NON_STREAM])}"
            f" (not gated: a DTPU top-k may flip in bf16)")
    del model, batch, logits, streams

    free()

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                **(f32_cut or {}))
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = ViLBERT(cfg32, device="cuda", generator=gen)
    batch = make_batch(cfg32, 1, 1024, gen)
    outs = {m: model.encode(batch, mode=m) for m in ExecutionMode}
    base = outs[ExecutionMode.NON_STREAM]
    for mode, (x, y, kept) in outs.items():
        gaps = stream_gaps((x, y), base[:2])
        say(f"  f32 N=1024, {cfg32.num_layers} layers, "
            f"{cfg32.num_coattn_layers} co-TRM blocks, {mode.value}: "
            f"relative stream gaps to non_stream {gaps} (tol {MODE_TOL}), "
            f"kept {kept}")
        if kept != base[2] or max(gaps) > MODE_TOL \
                or not (torch.isfinite(x).all() and torch.isfinite(y).all()):
            fail(f"{arch} f32 modes disagree: {mode.value} gaps {gaps}")


# ---------------------------------------------------------------------------
# Phases 5 and 6: qwen3-32b served by the paged-KV Engine
# ---------------------------------------------------------------------------

# rid, prompt length, new tokens, arrival step: r0-r2 share a bucket, r3
# is admitted while they decode, r4 waits for a free slot.
SERVE_REQUESTS = [(0, 1024, 32, 0), (1, 1024, 32, 0), (2, 1024, 32, 0),
                  (3, 1536, 16, 2), (4, 512, 16, 4)]
# The f32 checks at 2 layers: shorter prompts, r1 and r2 share a bucket.
CHECK_REQUESTS = [(0, 256, 8, 0), (1, 128, 8, 0), (2, 128, 8, 0),
                  (3, 192, 6, 2), (4, 64, 6, 4)]
# Serving checks in f32: max |difference| over max |value| of logits.
# The same f32 function in other summation orders (batched vs per-slot
# GEMM rows, three attention kernels), through 2 layers.
SERVE_TOL = 1e-4


def make_requests(cfg, spec, gen):
    prompts = {rid: torch.randint(0, cfg.vocab_size, (plen,), generator=gen,
                                  device="cuda").cpu().numpy().astype(np.int32)
               for rid, plen, _, _ in spec}

    def fresh():
        return [Request(rid=rid, prompt=prompts[rid], max_new_tokens=n,
                        arrival_step=a) for rid, _, n, a in spec]
    return fresh


def _clone(tree):
    """A copy of a cache tree's tensors (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class Probe:
    """Wraps an Engine's prefill and decode calls: times each (host clock
    around work that ends in torch.cuda.synchronize()), checks that every
    logit is finite, keeps the logits on the host when asked, and keeps a
    copy of the inputs of the decode call numbered ``profile_call`` for
    ``profile_step`` after the run (profiling inside the run would inflate
    the engine's step walls)."""

    def __init__(self, eng, keep_logits=False, profile_call=None):
        self.prefills, self.decodes, self.saved = [], [], None
        # tile_gemm's launches per route, in prefill and in decode calls
        self.routes = {"prefill": defaultdict(int), "decode": defaultdict(int)}
        prefill_one, decode = eng._prefill_one, eng._decode
        self.prefill_fn, self.decode_fn = prefill_one, decode

        def timed_prefill(req):
            before = dict(tile_gemm.routes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill_one(req)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self._count_routes("prefill", before)
            self._check(logits, f"prefill of r{req.rid}")
            self.prefills.append((req.rid, len(req.prompt), ms,
                                  logits.cpu() if keep_logits else None))
            return logits, cache

        def timed_decode(cache, toks, **kw):
            if len(self.decodes) == profile_call:
                self.saved = (_clone(cache), toks.clone(), kw)
            before = dict(tile_gemm.routes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(cache, toks, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self._count_routes("decode", before)
            self._check(logits, f"decode call {len(self.decodes)}")
            self.decodes.append((toks.shape[0], ms,
                                 logits[:, 0].cpu() if keep_logits else None))
            return logits, cache

        eng._prefill_one, eng._decode = timed_prefill, timed_decode

    def _count_routes(self, phase, before):
        for route, n in tile_gemm.routes.items():
            self.routes[phase][route] += n - before[route]

    @staticmethod
    def _check(logits, what):
        if not torch.isfinite(logits).all():
            fail(f"{what}: non-finite logits")

    def decode_logits(self, eng):
        """{rid: [logits of decode 0, 1, ...]}, matched to the calls
        through the engine's step log (bucket order, or one call per
        decoded slot on the per-slot path)."""
        calls = iter(self.decodes)
        per_rid = defaultdict(list)
        for rec in eng.step_log:
            groups = ([rids for _, rids in rec.buckets] if rec.buckets
                      else [(rid,) for rid in rec.decoded])
            for rids in groups:
                rows = next(calls)[2]
                for i, rid in enumerate(rids):
                    per_rid[rid].append(rows[i])
        return per_rid


def profile_call(fn, *args, top: int = 5, **kw) -> str:
    """One more call of ``fn`` under torch.profiler, after a warm-up call
    outside the trace: the device-busy share of its wall time, the number
    of kernels it launched and those that took the most device time.  Its
    launches are not counted."""
    from torch.profiler import ProfilerActivity, profile
    counts0, routes0 = counts(), route_counts()
    fn(*args, **kw)                        # warm-up, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for name, n in counts0.items():        # not a launch of the main path
        KERNELS[name][0].launches = n
    for name, fn in ROUTED.items():
        fn.routes = routes0[name]
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events)
    if busy == 0:
        return "profiler recorded no device time"
    gemm = sum(e.self_device_time_total for e in events
               if TILE_GEMM_KERNELS.search(e.key))
    events.sort(key=lambda e: -e.self_device_time_total)
    parts = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms"
                      for e in events[:top])
    return (f"device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
            f"wall ({100 * busy / wall_us:.0f}%), "
            f"{sum(e.count for e in events)} kernels; tile_gemm "
            f"{gemm / 1e3:.2f} ms; top: {parts}")


# tile_gemm's kernels, by their names in a profiler trace
TILE_GEMM_KERNELS = re.compile(
    r"repro::gemm::gemm_|\(anonymous namespace\)::gemm_(bf16|f32)\b")


def profile_step(decode, cache, toks, kw) -> str:
    """One decode call under torch.profiler, on a saved copy of an engine
    step's inputs (``profile_call``)."""
    return f"B = {toks.shape[0]}: " + profile_call(decode, cache, toks, **kw)


def serve(cfg, model, fresh, *, keep_logits=False, profile_call=None,
          **engine_kw):
    eng = Engine(cfg, model, **engine_kw)
    probe = Probe(eng, keep_logits=keep_logits, profile_call=profile_call)
    reqs = fresh()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    tokens = {r.rid: list(r.out_tokens) for r in done}
    for r in reqs:
        if len(tokens.get(r.rid, ())) != r.max_new_tokens:
            fail(f"{cfg.name}: request r{r.rid} returned "
                 f"{len(tokens.get(r.rid, ()))} of {r.max_new_tokens} tokens")
    want_calls = sum(r.max_new_tokens - 1 for r in reqs)
    if eng.decode_calls != want_calls:
        fail(f"{cfg.name}: decode_calls {eng.decode_calls} != {want_calls}")
    if eng._pool is not None and eng._pool.pages_in_use:
        fail(f"{cfg.name}: {eng._pool.pages_in_use} pages still in use")
    return eng, probe, tokens


def dense_serving(arch: str, spec, max_len: int, smi: str,
                  launches: dict) -> None:
    """Serve ``spec`` on the dense (or VLM) decoder ``arch`` at full width
    and depth, bf16, random weights (CUDA generator, seed 0),
    Engine(slots=4, max_len, page_size=64): paged K/V, batched decode."""
    cfg = get_config(arch)
    free()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  {arch} bf16, {n_params / 1e9:.2f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB [{smi}]")
    fresh = make_requests(cfg, spec, gen)
    reset_counts()
    t0 = time.perf_counter()
    eng, probe, _ = serve(cfg, model, fresh, slots=4, max_len=max_len,
                          page_size=64, profile_call=2)
    wall = time.perf_counter() - t0
    got, routes = counts(), route_counts()
    check_kernel_routes(arch, routes, got)
    profile = profile_step(probe.decode_fn, *probe.saved)
    probe.saved = None
    first = fresh()[0]
    prefill_profile = profile_call(probe.prefill_fn, first)
    tally(launches)
    st = eng.stats()
    say(f"  served {st['requests']} requests in {wall:.1f} s wall, "
        f"{st['steps']} steps; decode_calls {eng.decode_calls}, "
        f"decode_batches {eng.decode_batches}; launches {got}; tile_gemm "
        f"routes: prefill {dict(probe.routes['prefill'])}, decode "
        f"{dict(probe.routes['decode'])}")
    check_routes(f"{arch} prefill", probe.routes["prefill"], "wgmma")
    check_routes(f"{arch} decode", probe.routes["decode"], "splitk")
    if eng.decode_batches >= eng.decode_calls:
        fail(f"{arch}: batched decode did not batch")
    if got["flash_attention"] == 0 or got["tile_gemm"] == 0 \
            or got["stream_attention"] != 0 \
            or got["decode_attention"] != cfg.num_layers * eng.decode_batches:
        fail(f"{arch}: launches {got} do not fit the path (decode "
             f"attention {cfg.num_layers} x {eng.decode_batches} batches)")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
        f" GiB [{smi}]")
    for rid, plen, ms, _ in probe.prefills:
        say(f"  prefill r{rid}, {plen} tokens: {ms:.1f} ms [{smi}]")
    ttft = st["wall"]["ttft"]
    say(f"  wall TTFT p50 {ttft['p50'] * 1e3:.1f} ms, max "
        f"{ttft['max'] * 1e3:.1f} ms [{smi}]")
    by_b = defaultdict(list)
    for b, ms, _ in probe.decodes:
        by_b[b].append(ms)
    for b in sorted(by_b):
        say(f"  decode step, bucket of {b}: mean {np.mean(by_b[b]):.1f} ms, "
            f"min {min(by_b[b]):.1f} ms over {len(by_b[b])} calls [{smi}]")
    tokens = sum(len(r.decoded) for r in eng.step_log
                 if r.decoded and not r.admitted)
    say(f"  decode: {tokens} tokens in {eng.decode_wall_s():.2f} s of "
        f"pure-decode steps, {tokens / eng.decode_wall_s():.1f} tokens/s "
        f"[{smi}]")
    say(f"  profiled decode call: {profile} [{smi}]")
    say(f"  profiled prefill of r{first.rid}, {len(first.prompt)} tokens: "
        f"{prefill_profile} [{smi}]")


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _token_gaps(label, got, want, logits_of) -> int:
    """Greedy tokens of two runs: fails on a mismatch whose reference
    top-2 logit gap exceeds the tolerance, logs one within it; returns
    the matching count."""
    agree = 0
    for rid, ref_toks in want.items():
        for t, (a, b) in enumerate(zip(got[rid], ref_toks)):
            if a == b:
                agree += 1
                continue
            row = logits_of(rid, t)
            top2 = torch.topk(row, 2).values
            gap = (top2[0] - top2[1]).item()
            limit = 2 * SERVE_TOL * row.abs().max().item()
            msg = (f"{label}: r{rid} token {t}: {a} vs {b}, reference "
                   f"top-2 gap {gap:.3e} (tolerance {limit:.3e})")
            if gap > limit:
                fail(msg)
            say(f"  near tie, not gated: {msg}")
            break                       # later tokens follow other inputs
    return agree


def serving_checks(smi: str, arch: str = "qwen3-32b",
                   modes: bool = True) -> None:
    """f32 at ``arch``'s full width, 2 layers, on CHECK_REQUESTS: batched
    against per-slot decode, and with ``modes`` the NON/LAYER/TILE
    prefills against each other."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", param_dtype="float32")
    free()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = Transformer(cfg, device="cuda", generator=gen)
    fresh = make_requests(cfg, CHECK_REQUESTS, gen)
    kw = dict(slots=4, max_len=512, page_size=64, keep_logits=True)
    V = cfg.vocab_size

    runs = {}
    for batched in (True, False):
        eng, probe, tokens = serve(cfg, model, fresh, batch_decode=batched,
                                   **kw)
        runs[batched] = (eng, probe.decode_logits(eng), tokens,
                         {rid: lg[0, :V] for rid, _, _, lg in probe.prefills})
    eng_b, dec_b, tok_b, pre_b = runs[True]
    _, dec_s, tok_s, pre_s = runs[False]
    if eng_b.decode_batches >= eng_b.decode_calls:
        fail(f"{arch} f32 checks: batched decode did not batch")
    worst = 0.0
    for rid in tok_s:
        for t, (a, b) in enumerate(zip(dec_b[rid], dec_s[rid])):
            if tok_b[rid][:t + 1] != tok_s[rid][:t + 1]:
                break                   # inputs differ from here on
            worst = max(worst, _rel(a[:V], b[:V]))
    agree = _token_gaps(
        "batched vs per-slot", tok_b, tok_s,
        lambda rid, t: pre_s[rid] if t == 0 else dec_s[rid][t - 1][:V])
    say(f"  {arch} f32 batched vs per-slot decode: max relative logit gap "
        f"{worst:.2e} (tol {SERVE_TOL}); greedy tokens agree "
        f"{agree}/{sum(map(len, tok_s.values()))}; decode_batches "
        f"{eng_b.decode_batches} < decode_calls {eng_b.decode_calls}")
    if worst > SERVE_TOL:
        fail(f"{arch} f32 batched vs per-slot decode logits differ by "
             f"{worst:.2e}")
    if not modes:
        return

    by_mode = {}
    for mode in ExecutionMode:
        reset_counts()
        eng, probe, tokens = serve(
            cfg, model, fresh,
            plan=plan_model(cfg, mode=mode, force_mode=True), **kw)
        got = counts()
        if (got["stream_attention"] > 0) != (mode == ExecutionMode.TILE_STREAM):
            fail(f"f32 {mode.value}: launches {got} do not fit the mode")
        by_mode[mode] = (tokens, {rid: lg[0, :V]
                                for rid, _, _, lg in probe.prefills},
                       probe.decode_logits(eng))
    base_tok, base_pre, base_dec = by_mode[ExecutionMode.NON_STREAM]
    for mode, (tokens, pre, _) in by_mode.items():
        gap = max(_rel(pre[rid], base_pre[rid]) for rid in base_pre)
        agree = _token_gaps(
            f"{mode.value} vs non_stream", tokens, base_tok,
            lambda rid, t: base_pre[rid] if t == 0
            else base_dec[rid][t - 1][:V])
        say(f"  f32 {mode.value}: prefill last-token logits vs non_stream, "
            f"max relative gap {gap:.2e} (tol {SERVE_TOL}); greedy tokens "
            f"agree {agree}/{sum(map(len, base_tok.values()))}")
        if gap > SERVE_TOL:
            fail(f"f32 {mode.value} prefill logits differ by {gap:.2e}")


# ---------------------------------------------------------------------------
# Phases 7, 8 and 9: mamba2-780m and hymba-1.5b served, and their f32 checks
# ---------------------------------------------------------------------------

def ssm_serving(arch: str, spec, smi: str, launches: dict) -> None:
    """Serve ``spec`` on ``arch`` at full width and depth, bf16, random
    weights (CUDA generator, seed 0), Engine(slots=4, max_len=4096)."""
    cfg = get_config(arch)
    free()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  {arch} bf16, {n_params / 1e9:.3f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB [{smi}]")
    fresh = make_requests(cfg, spec, gen)
    reset_counts()
    t0 = time.perf_counter()
    eng, probe, _ = serve(cfg, model, fresh, slots=4, max_len=4096,
                          profile_call=2)
    wall = time.perf_counter() - t0
    got, routes = counts(), route_counts()
    check_kernel_routes(arch, routes, got)
    profile = profile_step(probe.decode_fn, *probe.saved)
    probe.saved = None
    first = fresh()[0]
    prefill_profile = profile_call(probe.prefill_fn, first)
    tally(launches)
    st = eng.stats()
    say(f"  served {st['requests']} requests in {wall:.2f} s wall, "
        f"{st['steps']} steps; decode_calls {eng.decode_calls}, "
        f"decode_batches {eng.decode_batches}; launches {got}")
    if eng._pool is not None or eng.decode_batches != eng.decode_calls \
            or any(r.buckets is not None for r in eng.step_log):
        fail(f"{arch}: decode did not fall back per slot")
    L, prefills = cfg.num_layers, len(probe.prefills)
    want = {name: 0 for name in KERNELS}
    want["ssd_scan"] = L * prefills
    if cfg.family == Family.HYBRID:
        want.update(flash_attention=L * prefills,
                    decode_attention=L * eng.decode_calls,
                    tile_gemm=3 * L * (prefills + eng.decode_calls))
    if got != want:
        fail(f"{arch}: launches {got} do not fit the path: expected {want}")
    if cfg.family == Family.HYBRID:
        say(f"  tile_gemm routes: prefill {dict(probe.routes['prefill'])}, "
            f"decode {dict(probe.routes['decode'])}")
        check_routes(f"{arch} prefill", probe.routes["prefill"], "wgmma")
        check_routes(f"{arch} decode", probe.routes["decode"], "splitk")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"  peak device memory {peak:.2f} GiB [{smi}]")
    for rid, plen, ms, _ in probe.prefills:
        say(f"  prefill r{rid}, {plen} tokens: {ms:.1f} ms [{smi}]")
    ttft = st["wall"]["ttft"]
    say(f"  wall TTFT p50 {ttft['p50'] * 1e3:.1f} ms, max "
        f"{ttft['max'] * 1e3:.1f} ms [{smi}]")
    ms = [m for _, m, _ in probe.decodes]
    say(f"  decode call (B = 1): mean {np.mean(ms):.2f} ms, min "
        f"{min(ms):.2f} ms, max {max(ms):.2f} ms over {len(ms)} calls "
        f"[{smi}]")
    tokens = sum(len(r.decoded) for r in eng.step_log
                 if r.decoded and not r.admitted)
    say(f"  decode: {tokens} tokens in {eng.decode_wall_s():.3f} s of "
        f"pure-decode steps, {tokens / eng.decode_wall_s():.1f} tokens/s "
        f"[{smi}]")
    say(f"  profiled decode call: {profile} [{smi}]")
    say(f"  profiled prefill of r{first.rid}, {len(first.prompt)} tokens: "
        f"{prefill_profile} [{smi}]")


@contextlib.contextmanager
def plain_ssd():
    """The SSM mixers take the SSD scan's plain version on the card, for
    the check of kernel against plain prefill (phase 9 only)."""
    real = ops.ssd
    ops.ssd = lambda x, dt, a, b, c, *, chunk: blocked.ssd_chunked_plain(
        x, dt, a, b, c, chunk=chunk)
    try:
        yield
    finally:
        ops.ssd = real


def _leaves(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def ssm_checks(smi: str) -> None:
    """f32 at full widths, 2 layers: relative gaps (max |diff| / max |value|)
    within SERVE_TOL."""
    for arch, S in (("mamba2-780m", 1000), ("hymba-1.5b", 1500)):
        cfg = dataclasses.replace(get_config(arch), num_layers=2,
                                  dtype="float32", param_dtype="float32")
        free()
        gen = torch.Generator(device="cuda").manual_seed(2)
        model = Transformer(cfg, device="cuda", generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (1, S + 1), generator=gen,
                             device="cuda")
        with torch.no_grad():                  # the carry between chunks
            for m in model.modules():
                if isinstance(m, SSM):
                    bias, a = mamba2_rates(gen, m.a_log.numel())
                    m.dt_bias.copy_(bias)
                    m.a_log.copy_(torch.log(-a))
        V, max_len = cfg.vocab_size, S + 8
        before = ssd_scan.launches
        full, cache = model.prefill({"tokens": toks}, max_len)
        _, part = model.prefill({"tokens": toks[:, :S]}, max_len)
        step, _ = model.decode_step(part, toks[:, S:])
        if ssd_scan.launches - before != 2 * cfg.num_layers:
            fail(f"f32 {arch}: the prefills did not run ssd_scan")
        gap = _rel(step[0, 0, :V], full[0, -1, :V])
        say(f"  f32 {arch}: prefill({S}) + decode vs prefill({S + 1}), last "
            f"logits: relative gap {gap:.2e} (tol {SERVE_TOL})")
        if gap > SERVE_TOL or not torch.isfinite(full).all():
            fail(f"f32 {arch}: prefill + decode differs from the longer "
                 f"prefill by {gap:.2e}")
        with plain_ssd():
            plain, pcache = model.prefill({"tokens": toks}, max_len)
        if ssd_scan.launches - before != 2 * cfg.num_layers:
            fail(f"f32 {arch}: the plain prefill launched ssd_scan")
        gaps = {"logits": _rel(full[..., :V], plain[..., :V])}
        want = _leaves(pcache["layers"])
        for name, t in _leaves(cache["layers"]).items():
            gaps[name] = _rel(t, want[name])
        say(f"  f32 {arch}: kernel vs plain-version prefill, relative gaps "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
            + f" (tol {SERVE_TOL})")
        if max(gaps.values()) > SERVE_TOL:
            fail(f"f32 {arch}: kernel and plain prefills differ: {gaps}")
        if cfg.family != Family.HYBRID:
            continue
        modes = {}
        for mode in ExecutionMode:
            reset_counts()
            modes[mode], _ = model.prefill(
                {"tokens": toks}, max_len,
                plan=plan_model(cfg, seq_len=S + 1, mode=mode,
                                force_mode=True))
            got = counts()
            tile = mode == ExecutionMode.TILE_STREAM
            if (got["stream_attention"] > 0) != tile:
                fail(f"f32 {arch} {mode.value}: launches {got} do not fit "
                     f"the mode")
        base = modes[ExecutionMode.NON_STREAM][..., :V]
        for mode, logits in modes.items():
            gap = _rel(logits[..., :V], base)
            say(f"  f32 {arch} {mode.value} prefill vs non_stream, all "
                f"logits: relative gap {gap:.2e} (tol {SERVE_TOL})")
            if gap > SERVE_TOL:
                fail(f"f32 {arch} {mode.value} prefill differs by {gap:.2e}")
    ssm_bf16_checks()


def ssm_bf16_checks() -> None:
    """bf16 at full widths, 2 layers, the SSD scan's tc route: the first
    layer's final SSD state after the kernel's prefill against the plain
    version's.  Both read the same bf16 inputs and keep the state in f32,
    so it takes the f32 limit (relative gap within SERVE_TOL); the later
    layer's inputs and the logits differ by bf16 roundings (printed, not
    gated)."""
    for arch, S in (("mamba2-780m", 1000), ("hymba-1.5b", 1500)):
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        free()
        gen = torch.Generator(device="cuda").manual_seed(3)
        model = Transformer(cfg, device="cuda", generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                             device="cuda")
        with torch.no_grad():                  # the carry between chunks
            for m in model.modules():
                if isinstance(m, SSM):
                    bias, a = mamba2_rates(gen, m.a_log.numel())
                    m.dt_bias.copy_(bias)
                    m.a_log.copy_(torch.log(-a))
        V, before = cfg.vocab_size, dict(ssd_scan.routes)
        full, cache = model.prefill({"tokens": toks}, S + 8)
        if ssd_scan.routes["tc"] - before["tc"] != cfg.num_layers:
            fail(f"bf16 {arch}: the prefill did not run ssd_scan's tc route")
        with plain_ssd():
            plain, pcache = model.prefill({"tokens": toks}, S + 8)
        want = _leaves(pcache["layers"])
        gaps = {name: (_rel(t[0], want[name][0]), _rel(t[1], want[name][1]))
                for name, t in _leaves(cache["layers"]).items()
                if name.endswith("state")}
        logits = _rel(full[..., :V].float(), plain[..., :V].float())
        say(f"  bf16 {arch}: kernel vs plain-version prefill, final SSD "
            f"state relative gaps (layer 0, layer 1): "
            + ", ".join(f"{k} {g[0]:.2e}, {g[1]:.2e}" for k, g in gaps.items())
            + f" (layer 0 tol {SERVE_TOL}); logits {logits:.2e} (not gated)")
        if not gaps or max(g[0] for g in gaps.values()) > SERVE_TOL \
                or not torch.isfinite(full).all():
            fail(f"bf16 {arch}: the first layer's SSD state from the kernel "
                 f"differs from the plain version's: {gaps}")


# ---------------------------------------------------------------------------
# Phases 10 and 11: training (make_train_step) at full width, then f32
# gradient checks
# ---------------------------------------------------------------------------

# vilbert-base: 10 steps per mode on one repeated batch; qwen3-32b at full
# width, 4 of its 64 layers (bf16 parameters and gradients with f32 AdamW
# moments: 12 bytes a parameter, ~42 GB at 3.5 B parameters), 5 steps.
TRAIN_RUNS = (("vilbert-base", {}, 2, 4096, 10, tuple(ExecutionMode)),
              ("qwen3-32b", {"num_layers": 4}, 1, 4096, 5,
               (ExecutionMode.LAYER_STREAM, ExecutionMode.TILE_STREAM)))
TRAIN_OPT = OPT.OptimizerConfig(learning_rate=1e-3, warmup_steps=0)
# The f32 checks (phase 11): max |difference| over max |value| of each
# parameter's gradient, the kernel path against the plain path, and the
# three modes against each other: f32 sums in other orders, as phase 4's
# MODE_TOL.  vilbert keeps one co-TRM block: at random weights its streams
# grow about tenfold a block (each co-attention reads the other stream
# un-normed), the softmax sharpens, and the W_Q/W_K gradients, which come
# through dS = P (dP - delta), lose their f32 digits; with two blocks the
# plain path itself lands 5e-4 from NON_STREAM (measured), with one 2e-5.
# One limit, GRAD_TOL, for both comparisons (each entry's last field).
GRAD_TOL = 1e-4
TRAIN_CHECKS = (("vilbert-base", {"num_layers": 2, "num_coattn_layers": 1},
                 1, 1024, tuple(ExecutionMode), GRAD_TOL),
                ("qwen3-32b", {"num_layers": 2}, 1, 1024,
                 tuple(ExecutionMode), GRAD_TOL))


def train_model(arch: str, cut: dict, dtype: str = "bfloat16", seed: int = 0):
    """The model of ``arch`` with the depth cuts ``cut`` in ``dtype``, its
    weights from ``seed``, its parameters requiring grad."""
    cfg = get_config(arch)
    cut = dict(cut)
    if dtype != cfg.dtype:
        cut.update(dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(cfg, **cut)
    return cfg, build_model(cfg, torch.device("cuda"), seed)


def train_batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    """One batch of the data pipeline's synthetic source, on the card."""
    shape = ShapeConfig("chip", S, B, "train")
    return to_device(SyntheticLM(cfg, shape, seed=seed).batch(0), cfg,
                     torch.device("cuda"))


def train_launches(cfg, mode: ExecutionMode, positions: bool = False
                   ) -> dict:
    """The kernel launches one train step must make.  A remat step (every
    family but the encoder-decoder, whose loss recomputes nothing, as in
    JAX) runs each layer's forward twice (the forward, then its recompute
    in the backward) and every backward kernel once.  Attention under the
    planner's resolved mode launches flash (LAYER_STREAM), stream
    (TILE_STREAM) or nothing (NON_STREAM); MLA, and a VLM batch with
    ``positions``, take flash in every mode.  An MLP makes three (gated)
    or two (GELU) projections through tile_gemm, an MoE layer only its
    shared expert's; an SSM mixer launches the SSD scan and its backward.
    The backward's projection products are torch.matmul (ProjectionFn)."""
    want = {name: 0 for name in KERNELS}
    mlp = 3 if cfg.act == "silu" else 2

    def attend(n, m, fwd=2):
        att = {ExecutionMode.LAYER_STREAM: "flash_attention",
               ExecutionMode.TILE_STREAM: "stream_attention"}.get(m)
        if att:
            want[att] += fwd * n
            want[f"{att}_bwd"] += n

    def resolve(d_kv):
        return resolve_layer_mode(
            mode, d_kv=d_kv, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, attn_kind=cfg.attn_kind,
            fuse_kv_generation=cfg.fuse_kv_generation)

    n = cfg.num_layers
    if cfg.family == Family.CROSSMODAL:
        attend(n - cfg.num_coattn_layers + 4 * cfg.num_coattn_layers,
               resolve(cfg.d_model_y))
        want["tile_gemm"] = 2 * 2 * (n + cfg.num_coattn_layers)
    elif cfg.family == Family.ENCDEC:
        attend(cfg.num_encoder_layers + 2 * n, resolve(cfg.d_model), fwd=1)
        want["tile_gemm"] = mlp * (cfg.num_encoder_layers + n)
    elif cfg.family == Family.SSM:
        want["ssd_scan"], want["ssd_scan_bwd"] = 2 * n, n
    else:
        if cfg.attn_kind == AttnKind.MLA or (cfg.family == Family.VLM
                                             and positions):
            attend(n, ExecutionMode.LAYER_STREAM)
        else:
            attend(n, resolve(cfg.d_model))
        if cfg.family == Family.HYBRID:
            want["ssd_scan"], want["ssd_scan_bwd"] = 2 * n, n
        mlps = n
        if cfg.family == Family.MOE:
            dense = min(cfg.first_dense_layers, n)
            mlps = dense + (n - dense) * (cfg.num_shared_experts > 0)
        want["tile_gemm"] = 2 * mlp * mlps
    return want


def profiled_step(model, cfg, mode, batch, state) -> tuple:
    """One more train step with each part (forward + loss, backward,
    optimizer; no optimizer where ``state`` is None) under its own
    torch.profiler trace: each part's device time against its wall time,
    the step's busy share and top kernels.  Returns (the report, how many
    parameters got a non-zero gradient, how many there are)."""
    from torch.profiler import ProfilerActivity, profile
    mod = registry.model_module(cfg)
    params = {k: p for k, p in model.named_parameters()}
    out, parts, kernels = {}, [], defaultdict(float)

    def traced(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.key] += e.self_device_time_total / 1e3
                dev += e.self_device_time_total / 1e3
        parts.append((name, dev, wall))

    traced("forward + loss",
           lambda: mod.loss_fn(model, batch, mode=mode, remat=True))
    traced("backward", lambda: torch.autograd.grad(
        out["forward + loss"], list(params.values()), allow_unused=True))
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), out["backward"])]
    if state is not None:
        traced("optimizer", lambda: OPT.apply(
            TRAIN_OPT, params, dict(zip(params, grads)), state))
    live = sum(int(bool(g.any())) for g in grads)
    busy, wall = sum(d for _, d, _ in parts), sum(w for _, _, w in parts)
    top = ", ".join(f"{kernel_name(k)} {t:.1f} ms" for k, t in sorted(
        kernels.items(), key=lambda kt: -kt[1])[:5])
    split = ", ".join(f"{n} {d:.1f} of {w:.1f} ms" for n, d, w in parts)
    return (f"device time of wall time: {split}; busy {busy:.1f} of "
            f"{wall:.1f} ms ({100 * busy / wall:.0f}%); top: {top}; {live} of "
            f"{len(grads)} parameters have a non-zero gradient",
            live, len(grads))


def training(smi: str, launches: dict) -> None:
    for arch, cut, B, S, steps, modes in TRAIN_RUNS:
        for mode in modes:
            cfg, model = train_model(arch, cut)
            batch = train_batch(cfg, B, S)
            params = dict(model.named_parameters())
            n_params = sum(p.numel() for p in params.values())
            state = OPT.init(params)
            step = ST.make_train_step(cfg, TRAIN_OPT, mode=mode)
            want = train_launches(cfg, mode)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = [], []
            for i in range(steps):
                reset_counts()
                t0 = time.perf_counter()
                model, state, m = step(model, state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                got = tally(launches)
                if got != want:
                    fail(f"train {arch} {mode.value} step {i + 1}: launches "
                         f"{got}, expected {want}")
                check_routes(f"train {arch} {mode.value}", tile_gemm.routes,
                             "wgmma")
                check_bwd_routes(f"train {arch} {mode.value} step {i + 1}",
                                 cfg, torch.bfloat16)
                if not (math.isfinite(m["loss"])
                        and math.isfinite(m["grad_norm"])):
                    fail(f"train {arch} {mode.value} step {i + 1}: loss "
                         f"{m['loss']}, grad norm {m['grad_norm']}")
                losses.append(m["loss"])
                say(f"  {arch} {mode.value} step {i + 1}: loss "
                    f"{m['loss']:.4f}, grad norm {m['grad_norm']:.3f}, "
                    f"{ms[-1]:.1f} ms")
            if not losses[-1] < losses[0]:
                fail(f"train {arch} {mode.value}: the loss on the repeated "
                     f"batch went from {losses[0]:.4f} to {losses[-1]:.4f}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            step_ms = float(np.mean(ms[1:]))
            rate = (f"{B * S / step_ms * 1e3:.0f} tokens/s"
                    if cfg.family != Family.CROSSMODAL
                    else f"{B / step_ms * 1e3:.2f} samples/s")
            say(f"  {arch} ({cfg.num_layers} layers, {n_params / 1e9:.3f} B "
                f"parameters) {mode.value}, B = {B}, S = {S}: step "
                f"{step_ms:.1f} ms mean of steps 2-{steps}, {rate}, peak "
                f"memory {peak:.2f} GiB, launches a step {want} [{smi}]")
            text, live, n = profiled_step(model, cfg, mode, batch, state)
            say(f"    profiled step: {text} [{smi}]")
            # vilbert at random weights: its streams reach ~1e6, the
            # pooler's tanh is flat, and only the VQA head gets a gradient
            # (see check_loss): its encoder step differentiates the
            # streams; the decoder's loss reaches every parameter
            if cfg.family == Family.CROSSMODAL:
                text = encoder_step(model, cfg, mode, batch, launches, want)
                say(f"    {text} [{smi}]")
            elif live != n:
                fail(f"train {arch} {mode.value}: {n - live} of {n} "
                     f"parameters got no gradient")
            del model, state, batch, params, step
            free()


def encoder_step(model, cfg, mode, batch, launches: dict, want: dict) -> str:
    """One more backward of vilbert, through check_loss's projection of the
    final streams, whose gradient reaches the encoder: the backward kernels
    run on non-zero upstream gradients at every training shape.  Gates the
    launches (those of a train step) and that every attention parameter of
    the text-only layers and the co-TRM blocks gets a finite, non-zero
    gradient."""
    what = f"train {cfg.name} {mode.value} encoder step"
    reset_counts()
    t0 = time.perf_counter()
    grads = grads_of(model, cfg, batch, mode)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = tally(launches)
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    check_routes(what, tile_gemm.routes, "wgmma")
    check_bwd_routes(what, cfg, torch.bfloat16)
    attn = {k: g for k, g in grads.items() if "attn." in k}
    dead = [k for k, g in attn.items() if g is None or not bool(g.any())
            or not bool(g.float().isfinite().all())]
    if dead:
        fail(f"{what}: no finite, non-zero gradient for {dead}")
    small = min(attn, key=lambda k: attn[k].float().abs().max().item())
    return (f"encoder step (check_loss): {ms:.1f} ms, launches as a train "
            f"step; all {len(attn)} attention parameters have a finite, "
            f"non-zero gradient (smallest max |g| "
            f"{attn[small].float().abs().max().item():.2e}, {small})")


def plain_ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """The SSD scan's plain version behind the wrapper's autograd rule:
    under grad through SSDScanFn (whose backward plain_kernels makes
    plain too)."""
    if _build.needs_grad(x, dt, a, b, c):
        return ssd_lib.SSDScanFn.apply(x, dt, a, b, c, chunk)
    return blocked.ssd_chunked_plain(x, dt, a, b, c, chunk=chunk)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel replaced by its plain version on the card: the training
    path's forward and backward attention and SSD scan (phases 11 and 20's
    plain path), the serving path's attention and decode attention (phase
    14), and the projection.  No kernel launches in it."""
    plain = {(flash_vjp, "flash_attention"): blocked.flash_attention_plain,
             (flash_vjp, "stream_attention"): blocked.stream_attention_plain,
             (flash_vjp, "flash_attention_bwd"):
                 blocked.flash_attention_bwd_plain,
             (flash_vjp, "stream_attention_bwd"):
                 blocked.stream_attention_bwd_plain,
             (ops, "flash_attention"): blocked.flash_attention_plain,
             (ops, "stream_attention"): blocked.stream_attention_plain,
             (ops, "decode_attention"): blocked.decode_attention_plain,
             (ops, "tile_gemm"): ref.ref_tile_gemm,
             (ops, "ssd_scan"): plain_ssd_scan,
             (ssd_lib, "ssd_scan"): plain_ssd_scan,
             (ssd_lib, "ssd_scan_bwd"): blocked.ssd_scan_bwd_plain}
    saved = {key: getattr(*key) for key in plain}
    for (mod, n), fn in plain.items():
        setattr(mod, n, fn)
    try:
        yield
    finally:
        for (mod, n), fn in saved.items():
            setattr(mod, n, fn)


def check_loss(model, cfg, batch, mode) -> torch.Tensor:
    """What phase 11 differentiates: the decoder's training loss; for
    vilbert (here and in phase 10's encoder step) the two final streams
    against fixed random weights.  Its VQA
    loss's gradient stops at the pooler: with random weights the streams
    reach ~1e6 (each co-attention reads the other stream un-normed,
    vilbert.py:126), tanh is flat there, and only the VQA head gets a
    gradient."""
    if cfg.family != Family.CROSSMODAL:
        return registry.model_module(cfg).loss_fn(model, batch, mode=mode,
                                                  remat=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, y, _ = model._encode(batch, mode=mode, remat=True)
    return sum((t.float() * torch.randn(t.shape, generator=gen,
                                        device="cuda")).sum() for t in (x, y))


def grads_of(model, cfg, batch, mode) -> dict:
    params = dict(model.named_parameters())
    loss = check_loss(model, cfg, batch, mode)
    return dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True)))


def to_host(grads: dict) -> dict:
    return {k: None if g is None else g.cpu() for k, g in grads.items()}


def grad_gap(got: dict, want: dict) -> tuple:
    """The largest max |difference| / max |value| over the parameters that
    have a gradient, and that parameter; fails if one has a gradient on one
    path only, or if none has a non-zero gradient."""
    gaps = []
    for k, g in got.items():
        if (g is None) != (want[k] is None):
            fail(f"{k}: a gradient on one path only")
        if g is None or not want[k].any():
            continue
        g, w = g.to("cuda").float(), want[k].to("cuda").float()
        gaps.append((((g - w).abs().max() / w.abs().max()).item(), k))
    if not gaps:
        fail("no parameter has a non-zero gradient")
    return max(gaps)


def training_checks(smi: str, checks=TRAIN_CHECKS) -> None:
    """Per configuration and mode: the kernel path's gradients against the
    plain path's, then against the first mode's (kept while the other
    modes run; each other mode's gradients are dropped once compared).
    The kernel path's gradients wait in host memory while the plain path
    runs (grok-1's layer holds 26 GB of them in f32).  The plain paths of
    two modes, the same function summed in other orders, are compared too:
    printed, the f32 floor of the configuration."""
    for arch, cut, B, S, modes, tol in checks:
        cfg, model = train_model(arch, cut, dtype="float32", seed=1)
        batch = family_batch(cfg, B, S, seed=1)
        positions = "positions" in batch
        base = plain_base = None
        for mode in modes:
            reset_counts()
            kernel = to_host(grads_of(model, cfg, batch, mode))
            got, want = counts(), train_launches(cfg, mode, positions)
            if got != want:
                fail(f"f32 {arch} {mode.value}: launches {got}, expected "
                     f"{want}")
            check_bwd_routes(f"f32 {arch} {mode.value}", cfg, torch.float32)
            with plain_kernels():
                reset_counts()
                plain = grads_of(model, cfg, batch, mode)
                if any(counts().values()):
                    fail(f"f32 {arch} {mode.value}: the plain path launched "
                         f"{counts()}")
            gap, name = grad_gap(kernel, plain)
            live = sum(int(g is not None and bool(g.any()))
                       for g in kernel.values())
            say(f"  f32 {arch} ({cfg.num_layers} layers, B = {B}, S = {S}) "
                f"{mode.value}: kernel against plain gradients, largest gap "
                f"{gap:.2e} ({name}; tol {tol}) over the {live} of "
                f"{len(kernel)} parameters with a non-zero gradient; "
                f"launches {got}")
            if plain_base is None:
                plain_base = to_host(plain)
            else:
                floor, fname = grad_gap(plain, plain_base)
                say(f"  f32 {arch} {mode.value}: its plain path against "
                    f"{base_mode.value}'s, {floor:.2e} ({fname})")
            del plain
            if not gap <= tol:
                fail(f"f32 {arch} {mode.value}: kernel gradients differ from "
                     f"the plain path's by {gap:.2e} ({name})")
            if base is None:
                base, base_mode = kernel, mode
                continue
            gap, name = grad_gap(kernel, base)
            del kernel
            say(f"  f32 {arch} {mode.value} against {base_mode.value}: "
                f"largest gradient gap {gap:.2e} ({name}; tol {tol})")
            if not gap <= tol:
                fail(f"f32 {arch}: {mode.value} gradients differ from "
                     f"{base_mode.value}'s by {gap:.2e} ({name})")
        del model, base, plain_base, batch
        free()


# ---------------------------------------------------------------------------
# Phases 19 and 20: training of the other families (SSM, hybrid, VLM,
# encoder-decoder, MLA, MoE) at full width, then f32 gradient checks
# ---------------------------------------------------------------------------

# arch, depth cut, B, S, steps, optimizer step.  AdamW at 1e-4: at phase
# 10's 1e-3 the loss on the repeated batch swings up over these steps
# (hymba 10.67 -> 17.60, deepseek-v3 12.33 -> 22.52 -> 8.81 on an H100)
# on the kernels and on the plain versions alike, within 1.3% at every
# step (chip_train_readings.py lr): the optimizer's steps on these
# randomly drawn models, not the kernels; at 1e-4 both paths fall.  Full
# depth but for deepseek-v3 (its 3 dense-prefix layers: MLA + the
# 18,432-wide MLP, ~3.6 B parameters, ~43 GB of bf16 parameters and
# gradients and f32 AdamW moments) and grok-1: one MoE layer is ~6.6 B
# parameters, ~79 GB with the optimizer's state, over one card's 80 GB,
# so it runs forward + backward without the optimizer step.  whisper-base
# at its encoder's 1500 frames and 448 decoder tokens (its positions'
# length in whisper), B = 4.
FAMILY_TRAIN_RUNS = (
    ("mamba2-780m", {}, 1, 2048, 5, True),
    ("hymba-1.5b", {}, 1, 2048, 5, True),
    ("qwen2-vl-2b", {}, 1, 2048, 5, True),
    ("whisper-base", {}, 4, 448, 5, True),
    ("deepseek-v3-671b", {"num_layers": 3}, 1, 1024, 5, True),
    ("grok-1-314b", {"num_layers": 1}, 1, 1024, 2, False),
)
FAMILY_OPT = OPT.OptimizerConfig(learning_rate=1e-4, warmup_steps=0)
FAMILY_MODE = ExecutionMode.TILE_STREAM
# Phase 20, f32 at 1-2 layers: kernel against plain gradients in every
# mode that changes what runs (hymba's attention and whisper's three
# attention kinds; the SSM has none, the VLM's M-RoPE attention and MLA are
# flash in every mode); deepseek-v3 at 2 dense-prefix layers (an MoE layer
# of its 256 experts holds 45 GB of f32 parameters).  The last entry is
# the limit of both comparisons.  whisper's is 2e-4, the JAX package's f32
# tolerance of its flash VJP's gradients (tests/test_kernels.py:193; its
# stream VJP's is 5e-4): whisper's decoder's cross-attention gradients
# (W_K, W_Q) come through dS = P (dP - delta) over 1500 encoder keys, and
# the f32 SIMT backward kernels' sums put them 4.3e-5 to 1.00e-4 from the
# plain path's, where the plain paths of two modes are 0.9e-5 to 2.5e-5
# apart, and the same kernels fed bf16-rounded operands 1.3e-2 to 0.61
# (seeds 1-4 on an H100: chip_train_readings.py whisper, which fails if
# such a control passes this limit).
WHISPER_GRAD_TOL = 2e-4
FAMILY_CHECKS = (
    ("mamba2-780m", {"num_layers": 2}, 1, 1024, (FAMILY_MODE,), GRAD_TOL),
    ("hymba-1.5b", {"num_layers": 2}, 1, 1024, tuple(ExecutionMode),
     GRAD_TOL),
    ("qwen2-vl-2b", {"num_layers": 2}, 1, 1024, (FAMILY_MODE,), GRAD_TOL),
    ("whisper-base", {"num_layers": 2, "num_encoder_layers": 2}, 2, 256,
     tuple(ExecutionMode), WHISPER_GRAD_TOL),
    ("deepseek-v3-671b", {"num_layers": 2, "first_dense_layers": 2}, 1, 1024,
     (FAMILY_MODE,), GRAD_TOL),
    ("grok-1-314b", {"num_layers": 1}, 1, 512, (FAMILY_MODE,), GRAD_TOL),
)
# qwen2-vl's M-RoPE streams a training batch carries: text, an image grid,
# text (grid_positions' arguments) for each sequence length used here.
FAMILY_GRIDS = {2048: (256, 32, 48, 256), 1024: (256, 16, 32, 256)}
# Parameters the loss never reads: deepseek-v3's mtp_proj is drawn and
# carried unused, as in JAX (its gradient is zero there too).
UNUSED = ("mtp_proj",)


def family_batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    """train_batch, with image-grid M-RoPE positions for a VLM."""
    batch = train_batch(cfg, B, S, seed)
    if cfg.family == Family.VLM:
        batch["positions"] = grid_positions(*FAMILY_GRIDS[S]).expand(
            3, B, S).contiguous()
    return batch


def forward_backward(model, cfg, mode, batch) -> dict:
    """One loss and its gradients, no optimizer step: the loss, the
    gradients' global norm and the gradients."""
    params = dict(model.named_parameters())
    loss = registry.model_module(cfg).loss_fn(model, batch, mode=mode,
                                              remat=True)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    norm = math.sqrt(sum(float(g.float().pow(2).sum()) for g in grads
                         if g is not None))
    return {"loss": loss.item(), "grad_norm": norm}


def family_training(smi: str, launches: dict) -> None:
    """Phase 19: each run of FAMILY_TRAIN_RUNS in bf16 at full width on one
    repeated batch, in FAMILY_MODE with FAMILY_OPT (train_run)."""
    for arch, cut, B, S, steps, update in FAMILY_TRAIN_RUNS:
        train_run(smi, launches, arch, cut, B, S, steps, FAMILY_MODE,
                  FAMILY_OPT, update)


def train_run(smi: str, launches: dict, arch: str, cut: dict, B: int, S: int,
              steps: int, mode: ExecutionMode, opt, update: bool = True
              ) -> None:
    """``steps`` train steps of ``arch`` (depth cut ``cut``) in bf16 at full
    width on one repeated batch of B x S, with exact launch and route gates
    per step, a falling loss (where the optimizer steps: ``update``), a
    profiled step, gradients on every parameter the loss reads (vilbert:
    every attention parameter, through encoder_step), the peak device
    memory."""
    t0 = time.perf_counter()
    cfg, model = train_model(arch, cut)
    batch = family_batch(cfg, B, S)
    want = train_launches(cfg, mode, "positions" in batch)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    state = OPT.init(params) if update else None
    step = ST.make_train_step(cfg, opt, mode=mode)
    what = f"train {arch} ({cfg.num_layers} layers) {mode.value}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(steps):
        reset_counts()
        t1 = time.perf_counter()
        if update:
            model, state, m = step(model, state, batch)
        else:
            m = forward_backward(model, cfg, mode, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        got = tally(launches)
        if got != want:
            fail(f"{what} step {i + 1}: launches {got}, expected {want}")
        if want["tile_gemm"]:
            check_routes(what, tile_gemm.routes, "wgmma")
        check_kernel_routes(what, route_counts(), got)
        check_bwd_routes(f"{what} step {i + 1}", cfg, torch.bfloat16)
        check_flash_routes(f"{what} step {i + 1}", cfg,
                           want["flash_attention"])
        if not (math.isfinite(m["loss"])
                and math.isfinite(m["grad_norm"])):
            fail(f"{what} step {i + 1}: loss {m['loss']}, grad norm "
                 f"{m['grad_norm']}")
        losses.append(m["loss"])
        say(f"  {arch} {mode.value} step {i + 1}: loss {m['loss']:.4f}, "
            f"grad norm {m['grad_norm']:.3f}, {ms[-1]:.1f} ms")
    if update and not losses[-1] < losses[0]:
        fail(f"{what}: the loss on the repeated batch went from "
             f"{losses[0]:.4f} to {losses[-1]:.4f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = float(np.mean(ms[1:]))
    rate = (f"{B * S / step_ms * 1e3:.0f} tokens/s"
            if cfg.family != Family.CROSSMODAL
            else f"{B / step_ms * 1e3:.2f} samples/s")
    say(f"  {arch} ({cfg.num_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters) {mode.value}, B = {B}, S = {S}"
        + ("" if update else ", forward + backward only (the optimizer's "
           "state of one layer does not fit the card)")
        + f": step {step_ms:.1f} ms mean of steps 2-{steps}, {rate}, peak "
        f"memory {peak:.2f} GiB, launches a step {want}, routes "
        f"{ {k: v for k, v in bwd_routes(cfg, torch.bfloat16).items()} }"
        f", flash {flash_route_of(cfg)} x {want['flash_attention']} "
        f"[{smi}]")
    text, live, n = profiled_step(model, cfg, mode, batch, state)
    say(f"    profiled step: {text} [{smi}]")
    # vilbert at random weights: only the VQA head gets a gradient of the
    # VQA loss (see check_loss); its encoder step differentiates the
    # streams and gates every attention parameter
    if cfg.family == Family.CROSSMODAL:
        text = encoder_step(model, cfg, mode, batch, launches, want)
        say(f"    {text} [{smi}]")
    else:
        unused = [k for k in params if k.split(".")[0] in UNUSED]
        if live != n - len(unused):
            fail(f"{what}: {n - len(unused) - live} of {n - len(unused)} "
                 f"parameters the loss reads got no gradient")
    say(f"  {arch} {mode.value} took {time.perf_counter() - t0:.1f} s")
    del model, state, batch, params, step
    free()


# ---------------------------------------------------------------------------
# Phase 22: training of the last four archs (vilbert-large, minitron-4b,
# starcoder2-7b, h2o-danube3-4b) at full width, then f32 gradient checks
# ---------------------------------------------------------------------------

# arch, depth cut, B, S, steps, modes, optimizer.  bf16 parameters and
# gradients with f32 AdamW moments take 12 bytes a parameter:
# vilbert-large (~0.7 B) runs at full depth as vilbert-base in TRAIN_RUNS
# (B = 2, N = 4096, TRAIN_OPT); minitron-4b at 16 of its 32 layers;
# starcoder2-7b at 24 of its 32 layers (~5.7 B; at full depth ~7.2 B,
# ~86 GB, over one card's 80 GB; at 16 layers its step peaked at 45.7 GiB
# on an H100, and each layer adds ~2.4 GiB); h2o-danube3-4b at 12 of its
# 24 layers and S = 8192, past its 4096-key window.  minitron-4b and
# h2o-danube3-4b ran at full depth (~4.2 B, ~50 GB; ~4.0 B, ~48 GB; 18 s
# and 2 x 17 s of the run) until phase 23's rows of the SSM, vilbert and
# whisper took that time: each layer of a stack repeats the same kernels
# at the same shapes.
# The three decoders' TILE_STREAM attention resolves to flash
# (2 Hkv hd < d_model, the planner's rule), as qwen3-32b's does;
# h2o-danube3 runs LAYER_STREAM too.  The decoders step AdamW at phase
# 19's 1e-4.
LAST_TRAIN_RUNS = (
    ("vilbert-large", {}, 2, 4096, 5,
     (ExecutionMode.LAYER_STREAM, ExecutionMode.TILE_STREAM), TRAIN_OPT),
    ("minitron-4b", {"num_layers": 16}, 1, 2048, 5,
     (ExecutionMode.TILE_STREAM,), FAMILY_OPT),
    ("starcoder2-7b", {"num_layers": 24}, 1, 2048, 5,
     (ExecutionMode.TILE_STREAM,), FAMILY_OPT),
    ("h2o-danube3-4b", {"num_layers": 12}, 1, 8192, 5,
     (ExecutionMode.LAYER_STREAM, ExecutionMode.TILE_STREAM), FAMILY_OPT),
)
# f32 at 2 layers (vilbert-large at one co-TRM block, as TRAIN_CHECKS'
# vilbert-base), GRAD_TOL: h2o-danube3 at S = 8192, past its window, in
# both modes; the other three in one mode each.
LAST_CHECKS = (
    ("h2o-danube3-4b", {"num_layers": 2}, 1, 8192,
     (ExecutionMode.LAYER_STREAM, ExecutionMode.TILE_STREAM), GRAD_TOL),
    ("vilbert-large", {"num_layers": 2, "num_coattn_layers": 1}, 1, 1024,
     (ExecutionMode.TILE_STREAM,), GRAD_TOL),
    ("minitron-4b", {"num_layers": 2}, 1, 1024,
     (ExecutionMode.TILE_STREAM,), GRAD_TOL),
    ("starcoder2-7b", {"num_layers": 2}, 1, 1024,
     (ExecutionMode.TILE_STREAM,), GRAD_TOL),
)


def last_training(smi: str, launches: dict) -> None:
    """Phase 22: each run of LAST_TRAIN_RUNS in each of its modes
    (train_run), then LAST_CHECKS' f32 gradients (training_checks)."""
    for arch, cut, B, S, steps, modes, opt in LAST_TRAIN_RUNS:
        for mode in modes:
            train_run(smi, launches, arch, cut, B, S, steps, mode, opt)
    training_checks(smi, LAST_CHECKS)


# ---------------------------------------------------------------------------
# Phases 13 and 14: whisper-base and qwen2-vl-2b
# ---------------------------------------------------------------------------

def resolved(cfg, mode: ExecutionMode) -> ExecutionMode:
    """The planner's mode for an attention layer of ``cfg`` whose K/V come
    from activations of width d_model."""
    return resolve_layer_mode(mode, d_kv=cfg.d_model,
                              num_kv_heads=cfg.num_kv_heads,
                              head_dim=cfg.head_dim)


def whisper_launches(cfg, mode: ExecutionMode, what: str) -> dict:
    """The launches of one whisper ``encode``, ``prefill`` or
    ``decode_step``: attention under the resolved mode launches flash
    (LAYER_STREAM), stream (TILE_STREAM) or nothing (NON_STREAM); the
    prompt's causal self-attention is flash in every mode; a decode step's
    self-attention is decode attention and its cross-attention the
    resolved TILE_STREAM; two MLP projections a layer."""
    want = dict.fromkeys(KERNELS, 0)
    kernel = {ExecutionMode.LAYER_STREAM: "flash_attention",
              ExecutionMode.TILE_STREAM: "stream_attention"}

    def attend(n, m):
        if resolved(cfg, m) in kernel:
            want[kernel[resolved(cfg, m)]] += n

    enc, dec = cfg.num_encoder_layers, cfg.num_layers
    if what in ("encode", "prefill"):
        attend(enc, mode)
        want["tile_gemm"] += 2 * enc
    if what == "prefill":
        want["flash_attention"] += dec
        attend(dec, mode)
        want["tile_gemm"] += 2 * dec
    if what == "decode":
        want["decode_attention"] += dec
        attend(dec, ExecutionMode.TILE_STREAM)
        want["tile_gemm"] += 2 * dec
    return want


def check_call(what: str, launches: dict, want: dict, gemm_route: str
               ) -> None:
    """Tally one call's launches and fail unless they equal ``want``,
    every tile_gemm launch took ``gemm_route`` and every decode attention
    launch the tc route."""
    got = tally(launches)
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    if tile_gemm.routes != {**dict.fromkeys(tile_gemm.routes, 0),
                            gemm_route: want["tile_gemm"]}:
        fail(f"{what}: tile_gemm routes {tile_gemm.routes}; all "
             f"{want['tile_gemm']} must take the {gemm_route} route")
    check_kernel_routes(what, route_counts(), got)


def whisper_inputs(cfg, B: int, S: int, seed: int):
    """B clips of frames and S prompt tokens from the data pipeline."""
    data = SyntheticLM(cfg, ShapeConfig("whisper", S, B, "prefill"),
                       seed=seed).batch(0)
    return {"frames": torch.from_numpy(data["frames"]).cuda(),
            "tokens": torch.from_numpy(data["tokens"]).long().cuda()}


def whisper_path(smi: str, launches: dict) -> None:
    """whisper-base at full width and depth, bf16: encode and prefill of
    B = 4 clips with a 4-token prompt in each mode, then WHISPER_STEPS
    greedy decode steps, every call's launches gated exactly."""
    cfg = get_config("whisper-base")
    free()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = EncDec(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  whisper-base bf16, {n_params / 1e6:.1f} M parameters (the "
        f"32768-row position table included), built in "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    batch = whisper_inputs(cfg, WHISPER_B, WHISPER_PROMPT, seed=0)
    V, tokens = cfg.vocab_size, {}
    for mode in ExecutionMode:
        model.prefill(batch, WHISPER_MAX_LEN, mode=mode)      # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        enc = model.encode(batch["frames"], mode=mode)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        check_call(f"whisper encode {mode.value}", launches,
                   whisper_launches(cfg, mode, "encode"), "wgmma")
        if enc.shape != (WHISPER_B, cfg.encoder_seq, cfg.d_model) \
                or not torch.isfinite(enc).all():
            fail(f"whisper encode {mode.value}: {tuple(enc.shape)} states, "
                 f"or not finite")
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch, WHISPER_MAX_LEN, mode=mode)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        check_call(f"whisper prefill {mode.value}", launches,
                   whisper_launches(cfg, mode, "prefill"), "wgmma")
        if not torch.isfinite(logits).all():
            fail(f"whisper prefill {mode.value}: non-finite logits")
        tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None]
        out, step_ms, saved = [tok], [], None
        for step in range(WHISPER_STEPS):
            if step == 1:
                saved = (_clone(cache), tok.clone())
            reset_counts()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check_call(f"whisper decode step {step} ({mode.value} prefill)",
                       launches, whisper_launches(cfg, mode, "decode"),
                       "splitk")
            if logits.shape[:2] != (WHISPER_B, 1) \
                    or not torch.isfinite(logits).all():
                fail(f"whisper decode step {step}: logits "
                     f"{tuple(logits.shape)} or not finite")
            tok = torch.argmax(logits[:, 0, :V], dim=-1)[:, None]
            out.append(tok)
        tokens[mode] = torch.cat(out, dim=1)
        if not ((tokens[mode] >= 0) & (tokens[mode] < V)).all():
            fail(f"whisper {mode.value}: a token outside [0, {V})")
        say(f"  {mode.value}: encode {enc_ms:.2f} ms, prefill (encode "
            f"included) {pre_ms:.2f} ms, decode step mean "
            f"{np.mean(step_ms):.2f} ms, min {min(step_ms):.2f} ms over "
            f"{WHISPER_STEPS} steps, B = {WHISPER_B} [{smi}]")
        if mode == ExecutionMode.TILE_STREAM:
            say(f"    profiled decode step (cache len "
                f"{WHISPER_PROMPT + 1}): "
                f"{profile_call(model.decode_step, *saved)} [{smi}]")
            say(f"    profiled encode: "
                f"{profile_call(model.encode, batch['frames'], mode=mode)} "
                f"[{smi}]")
    base = tokens[ExecutionMode.NON_STREAM]
    agree = {m.value: int((t == base).sum()) for m, t in tokens.items()}
    say(f"  {WHISPER_STEPS + 1} greedy tokens per clip; agreement with "
        f"non_stream {agree} of {base.numel()} (not gated: bf16 near ties)"
        f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{smi}]")


def whisper_checks(smi: str) -> None:
    """f32 at whisper-base's full width, 2 encoder and 2 decoder layers:
    prefill(S) then one decode step against the teacher-forced decoder at
    S + 1 (tests/test_archs.py:49-73), and the modes against each other."""
    cfg = dataclasses.replace(get_config("whisper-base"), num_layers=2,
                              num_encoder_layers=2, dtype="float32",
                              param_dtype="float32")
    free()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = EncDec(cfg, device="cuda", generator=gen)
    S, V = 16, cfg.vocab_size
    batch = whisper_inputs(cfg, 2, S + 1, seed=1)
    prompt = {"frames": batch["frames"], "tokens": batch["tokens"][:, :S]}
    full = {}
    for mode in ExecutionMode:
        full[mode] = model(batch, mode=mode)[..., :V]
        logits, cache = model.prefill(prompt, S + 5, mode=mode)
        step, _ = model.decode_step(cache, batch["tokens"][:, S:S + 1])
        gaps = (_rel(logits[..., :V], full[mode][:, :S]),
                _rel(step[:, 0, :V], full[mode][:, S]))
        mode_gap = _rel(full[mode], full[ExecutionMode.NON_STREAM])
        say(f"  f32 {mode.value}: prefill({S}) and decode step against "
            f"decode_train({S + 1}), relative gaps {gaps[0]:.2e}, "
            f"{gaps[1]:.2e}; forward against non_stream {mode_gap:.2e} "
            f"(tol {SERVE_TOL})")
        if max(gaps + (mode_gap,)) > SERVE_TOL:
            fail(f"whisper f32 {mode.value}: gaps {gaps}, against "
                 f"non_stream {mode_gap:.2e}")


#: qwen2-vl-2b's forward: 512 text tokens, a 48 x 64 grid of image
#: patches, 512 text tokens (S = 4096).
QWEN2VL_LAYOUT = (512, 48, 64, 512)


def grid_positions(text: int, grid_h: int, grid_w: int, after: int
                   ) -> torch.Tensor:
    """(3, 1, S) t/h/w position streams as Qwen2-VL assigns them: text
    tokens with all three equal, an image grid with t constant, h the row
    and w the column (offset by the text before it), then text from the
    next free position."""
    t = list(range(text))
    h, w = list(t), list(t)
    for r in range(grid_h):
        for c in range(grid_w):
            t.append(text)
            h.append(text + r)
            w.append(text + c)
    nxt = text + max(grid_h, grid_w)
    tail = list(range(nxt, nxt + after))
    return torch.tensor([t + tail, h + tail, w + tail],
                        device="cuda")[:, None]


def qwen2vl_forward(smi: str, launches: dict) -> None:
    """qwen2-vl-2b's M-RoPE forward at full width and depth, bf16, B = 1,
    S = 4096: flash in every mode (the three logits bitwise equal), three
    MLP projections a layer on wgmma, nothing else; against the same
    forward with every kernel's plain version on the card."""
    cfg = get_config("qwen2-vl-2b")
    free()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer(cfg, device="cuda", generator=gen)
    positions = grid_positions(*QWEN2VL_LAYOUT)
    S = positions.shape[-1]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, S),
                                     generator=gen, device="cuda"),
             "positions": positions}
    L = cfg.num_layers
    want = {**dict.fromkeys(KERNELS, 0), "flash_attention": L,
            "tile_gemm": 3 * L}
    model(batch)                                          # warm-up
    first = None
    for mode in ExecutionMode:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits = model(batch, mode=mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_call(f"qwen2-vl forward {mode.value}", launches, want, "wgmma")
        if not torch.isfinite(logits).all():
            fail(f"qwen2-vl forward {mode.value}: non-finite logits")
        if first is None:
            first = logits
        elif not torch.equal(logits, first):
            fail(f"qwen2-vl forward {mode.value}: the M-RoPE path must not "
                 f"depend on the mode")
        say(f"  forward {mode.value}, S = {S} (text {QWEN2VL_LAYOUT[0]}, "
            f"image grid {QWEN2VL_LAYOUT[1]} x {QWEN2VL_LAYOUT[2]}, text "
            f"{QWEN2VL_LAYOUT[3]}): {ms:.1f} ms wall [{smi}]")
        del logits
    say(f"    profile: {device_breakdown(model, batch, None)} [{smi}]")
    with plain_kernels():
        reset_counts()
        plain = model(batch)
        if any(counts().values()):
            fail(f"qwen2-vl: the plain forward launched {counts()}")
    V = cfg.vocab_size
    gap, limit = _rel(first[..., :V], plain[..., :V]), 2 ** -7 * L ** 0.5
    agree = (first[0, :, :V].argmax(-1) == plain[0, :, :V].argmax(-1)).float()
    say(f"  kernel against plain forward: max relative logit gap {gap:.2e} "
        f"(limit {limit:.2e}: one bf16 rounding, 2^-7, per layer's "
        f"attention output, independent across the {L} layers); greedy "
        f"tokens agree at {agree.mean().item() * 100:.2f}% of positions")
    if not gap <= limit:
        fail(f"qwen2-vl: kernel and plain forwards differ by {gap:.2e}")
    del first, plain, model
    free()

    # f32, 2 layers: equal streams give the 1-D RoPE forward; an image grid
    # does not.
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = Transformer(cfg32, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    one_d = model({"tokens": tokens}, mode=ExecutionMode.LAYER_STREAM)
    equal = torch.arange(1024, device="cuda")[None, None].expand(3, 1, -1)
    eq_gap = _rel(model({"tokens": tokens, "positions": equal}), one_d)
    grid = grid_positions(256, 16, 32, 256)
    grid_gap = _rel(model({"tokens": tokens, "positions": grid}), one_d)
    say(f"  f32, 2 layers, S = 1024: M-RoPE with equal streams against the "
        f"1-D RoPE forward {eq_gap:.2e} (tol {SERVE_TOL}); with an image "
        f"grid {grid_gap:.2e} (must differ)")
    if eq_gap > SERVE_TOL or grid_gap <= 10 * SERVE_TOL:
        fail(f"qwen2-vl f32: M-RoPE gaps {eq_gap:.2e}, {grid_gap:.2e}")


# ---------------------------------------------------------------------------
# Phases 15 and 16: the MoE family, grok-1-314b and deepseek-v3-671b
# ---------------------------------------------------------------------------

# Depth cuts on one H100 80 GB, widths unchanged: grok-1 runs 4 of its 64
# layers in bf16 (21.3 B parameters, 42.6 GB), deepseek-v3 its 3
# dense-prefix layers and 2 of its 58 MoE layers, mtp_proj kept (26.7 B,
# 53.4 GB); the f32 checks run grok-1 at 2 layers and deepseek-v3 at 1
# dense + 1 MoE layer (~45 and ~56 GB), the bf16 model freed first.
MOE_CUTS = {"grok-1-314b": {"num_layers": 4},
            "deepseek-v3-671b": {"num_layers": 5}}
MOE_F32_CUTS = {"grok-1-314b": {"num_layers": 2},
                "deepseek-v3-671b": {"num_layers": 2,
                                     "first_dense_layers": 1}}
MOE_CHECK_S = 256               # the f32 checks' prompt


def moe_model(arch: str, dtype: str, cut: dict, seed: int):
    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              param_dtype=dtype, **cut)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, Transformer(cfg, device="cuda", generator=gen), gen


def moe_gemms(cfg) -> int:
    """tile_gemm launches of one forward or decode call: the dense
    prefix's MLPs and the shared experts (the routed experts are batched
    products outside any kernel, as in JAX)."""
    per_mlp = 3 if cfg.act == "silu" else 2
    n_dense = cfg.first_dense_layers
    return (n_dense * per_mlp
            + (cfg.num_layers - n_dense) * 3 * bool(cfg.num_shared_experts))


def attention_kernel(cfg, mode: ExecutionMode, plan_mode=None):
    """The kernel an attention layer of ``cfg`` launches under ``mode``
    (resolved by the planner's rule) or under a plan's resolved
    ``plan_mode``: MLA's latent attention is flash in every mode; a GQA
    layer flash (LAYER_STREAM), stream (TILE_STREAM) or none."""
    if cfg.attn_kind == AttnKind.MLA:
        return "flash_attention"
    return {ExecutionMode.LAYER_STREAM: "flash_attention",
            ExecutionMode.TILE_STREAM: "stream_attention"}.get(
                plan_mode or resolved(cfg, mode))


def moe_forward_launches(cfg, mode: ExecutionMode) -> dict:
    want = dict.fromkeys(KERNELS, 0)
    kernel = attention_kernel(cfg, mode)
    if kernel:
        want[kernel] = cfg.num_layers
    want["tile_gemm"] = moe_gemms(cfg)
    return want


@contextlib.contextmanager
def record_routing():
    """Every MoE layer's routing while active, a list of (each token's
    expert set, sorted (T, K); the margin of its K-th gate over the
    (K+1)-th (T,)) per call of ``layers.moe_route``."""
    real, seen = model_layers.moe_route, []

    def recording(p, cfg, xt, cap, router=None):
        out = real(p, cfg, xt, cap, router)
        K = cfg.experts_per_token
        router = p.router if router is None else router
        gates = torch.softmax(torch.einsum("gtd,de->gte", xt.float(),
                                           router.float()), dim=-1)
        top = torch.topk(gates, K + 1, dim=-1).values.reshape(-1, K + 1)
        seen.append((out[2].reshape(-1, K).sort(-1).values,
                     top[:, K - 1] - top[:, K]))
        return out

    model_layers.moe_route = recording
    try:
        yield seen
    finally:
        model_layers.moe_route = real


def routing_gap(got, want) -> tuple:
    """(tokens whose expert set differs, the smallest top-k gate margin of
    ``want`` over all tokens, the smallest among the differing ones)."""
    if len(got) != len(want):
        fail(f"routing records of {len(got)} and {len(want)} MoE calls")
    flips, low, low_flip = 0, math.inf, math.inf
    for (eg, _), (ew, mw) in zip(got, want):
        d = (eg != ew).any(-1)
        flips += int(d.sum())
        low = min(low, mw.min().item())
        if d.any():
            low_flip = min(low_flip, mw[d].min().item())
    return flips, low, low_flip


def moe_path(arch: str, smi: str, launches: dict) -> None:
    """``arch`` (MoE family) at full width and MOE_CUTS' depth, bf16,
    random weights (seed 0): the forward at S = MOE_S in each mode (the
    resolved attention per layer, exact launches; deepseek's modes
    bitwise equal: MLA is one path), against the plain versions (expert
    sets that differ printed), then served by the Engine (grok-1: paged
    K/V, batched decode on decode attention; deepseek-v3: the latent
    cache, per-slot decode) with exact launch and route gates."""
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, gen = moe_model(arch, "bfloat16", MOE_CUTS[arch], seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L, V = cfg.num_layers, cfg.vocab_size
    say(f"  {arch} bf16, {L} of {get_config(arch).num_layers} layers at "
        f"full width, {n_params / 1e9:.2f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB [{smi}]")
    batch = {"tokens": torch.randint(0, V, (1, MOE_S), generator=gen,
                                     device="cuda")}
    model(batch)                                          # warm-up
    first, routes = None, {}
    for mode in ExecutionMode:
        torch.cuda.synchronize()
        reset_counts()
        with record_routing() as seen:
            t0 = time.perf_counter()
            logits = model(batch, mode=mode)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        want = moe_forward_launches(cfg, mode)
        check_call(f"{arch} forward {mode.value}", launches, want, "wgmma")
        check_flash_routes(f"{arch} forward {mode.value}", cfg,
                           want["flash_attention"])
        if logits.shape[:2] != (1, MOE_S) or not torch.isfinite(logits).all():
            fail(f"{arch} forward {mode.value}: logits "
                 f"{tuple(logits.shape)} or not finite")
        routes[mode] = seen
        say(f"  forward {mode.value}, S = {MOE_S}: {ms:.1f} ms wall, "
            f"attention {attention_kernel(cfg, mode) or 'plain (NON)'} in "
            f"each of the {L} layers, launches {want}, flash routes "
            f"{dict(flash_attention.routes)} [{smi}]")
        if first is None:
            first = logits
        elif cfg.attn_kind == AttnKind.MLA and not torch.equal(logits, first):
            fail(f"{arch} forward {mode.value}: MLA runs one path in every "
                 f"mode; the logits must be bitwise equal")
        else:
            say(f"    against non_stream: max relative logit gap "
                f"{_rel(logits[..., :V], first[..., :V]):.2e}, tokens whose "
                f"expert set differs {routing_gap(seen, routes[ExecutionMode.NON_STREAM])[0]}"
                f" (not gated in bf16)")
        del logits
    say(f"    profile (layer_stream): "
        f"{device_breakdown(model, batch, ExecutionMode.LAYER_STREAM)} "
        f"[{smi}]")
    with plain_kernels(), record_routing() as seen:
        reset_counts()
        plain = model(batch, mode=ExecutionMode.LAYER_STREAM)
        if any(counts().values()):
            fail(f"{arch}: the plain forward launched {counts()}")
    flips, low, low_flip = routing_gap(
        seen, routes[ExecutionMode.LAYER_STREAM])
    say(f"  kernel against plain forward (bf16, layer_stream): max relative "
        f"logit gap {_rel(first[..., :V], plain[..., :V]):.2e}; tokens "
        f"whose expert set differs {flips} of {MOE_S} x {L - cfg.first_dense_layers}"
        f" MoE layers (smallest top-k gate margin {low:.2e}, among those "
        f"{low_flip:.2e}; not gated in bf16)")
    if not torch.isfinite(plain).all():
        fail(f"{arch}: the plain forward is not finite")
    del first, plain
    free()

    fresh = make_requests(cfg, MOE_REQUESTS, gen)
    reset_counts()
    t0 = time.perf_counter()
    eng, probe, tokens = serve(cfg, model, fresh, slots=4,
                               max_len=MOE_MAX_LEN, page_size=64,
                               profile_call=2)
    wall = time.perf_counter() - t0
    got, kroutes = counts(), route_counts()
    check_kernel_routes(arch, kroutes, got)
    profile = profile_step(probe.decode_fn, *probe.saved)
    probe.saved = None
    first_req = fresh()[0]
    prefill_profile = profile_call(probe.prefill_fn, first_req)
    tally(launches)
    paged = cfg.attn_kind != AttnKind.MLA
    n_pre, n_dec = len(probe.prefills), eng.decode_batches
    want = dict.fromkeys(KERNELS, 0)
    for _, plen, _, _ in MOE_REQUESTS:
        for lp in eng.plan_for(plen).layers:
            kernel = attention_kernel(cfg, None, ExecutionMode(lp.mode.value))
            if kernel:
                want[kernel] += 1
    want["decode_attention"] = L * n_dec if paged else 0
    want["tile_gemm"] = moe_gemms(cfg) * (n_pre + n_dec)
    st = eng.stats()
    say(f"  served {st['requests']} requests in {wall:.1f} s wall, "
        f"{st['steps']} steps; decode_calls {eng.decode_calls}, "
        f"decode_batches {n_dec} ({'paged, batched' if paged else 'per-slot'}"
        f"); launches {got} (expected {want}); per prefill: "
        f"{want['flash_attention'] // n_pre} flash, "
        f"{want['stream_attention'] // n_pre} stream, {moe_gemms(cfg)} "
        f"tile_gemm; per decode call: "
        f"{want['decode_attention'] // n_dec} decode attention, "
        f"{moe_gemms(cfg)} tile_gemm; flash routes "
        f"{kroutes['flash_attention']}; tile_gemm routes: prefill "
        f"{dict(probe.routes['prefill'])}, decode "
        f"{dict(probe.routes['decode'])}")
    if got != want:
        fail(f"{arch} serving: launches {got}, expected {want}")
    if kroutes["flash_attention"] != {
            **dict.fromkeys(kroutes["flash_attention"], 0),
            flash_route_of(cfg): want["flash_attention"]}:
        fail(f"{arch} serving: flash_attention routes "
             f"{kroutes['flash_attention']}; all {want['flash_attention']} "
             f"must take the {flash_route_of(cfg)} route")
    if (eng._pool is not None) != paged \
            or (n_dec < eng.decode_calls) != paged:
        fail(f"{arch} serving: pool {eng._pool is not None}, decode_batches "
             f"{n_dec} of {eng.decode_calls} calls; expected "
             f"{'paged batched' if paged else 'per-slot'} decode")
    if moe_gemms(cfg):
        check_routes(f"{arch} prefill", probe.routes["prefill"], "wgmma")
        check_routes(f"{arch} decode", probe.routes["decode"], "splitk")
    for rid, toks in tokens.items():
        if not all(0 <= t < V for t in toks):
            fail(f"{arch}: r{rid} emitted a token outside [0, {V})")
    say(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB [{smi}]")
    for rid, plen, ms, _ in probe.prefills:
        say(f"  prefill r{rid}, {plen} tokens: {ms:.1f} ms [{smi}]")
    ttft = st["wall"]["ttft"]
    say(f"  wall TTFT p50 {ttft['p50'] * 1e3:.1f} ms, max "
        f"{ttft['max'] * 1e3:.1f} ms [{smi}]")
    by_b = defaultdict(list)
    for b, ms, _ in probe.decodes:
        by_b[b].append(ms)
    for b in sorted(by_b):
        say(f"  decode call, B = {b}: mean {np.mean(by_b[b]):.1f} ms, min "
            f"{min(by_b[b]):.1f} ms over {len(by_b[b])} calls [{smi}]")
    n_tok = sum(len(r.decoded) for r in eng.step_log
                if r.decoded and not r.admitted)
    say(f"  decode: {n_tok} tokens in {eng.decode_wall_s():.2f} s of "
        f"pure-decode steps, {n_tok / eng.decode_wall_s():.1f} tokens/s "
        f"[{smi}]")
    say(f"  profiled decode call: {profile} [{smi}]")
    say(f"  profiled prefill of r{first_req.rid}, {len(first_req.prompt)} "
        f"tokens: {prefill_profile} [{smi}]")
    del eng, probe, model
    free()


def _stack_caches(a, b):
    """Two B = 1 caches of one length as one B = 2 cache."""
    return {"layers": {k: torch.cat([a["layers"][k], b["layers"][k]], 1)
                       for k in a["layers"]}, "len": a["len"]}


def moe_checks(arch: str, smi: str) -> None:
    """f32 at ``arch``'s full width and MOE_F32_CUTS' depth, within
    SERVE_TOL: the modes against each other (deepseek: bitwise), the
    kernels against their plain versions (with the expert sets that differ
    and the smallest top-k gate margin, so that a routing flip can be told
    from a fault), and, with nothing dropped (moe_capacity=100), prefill(S)
    + a decode step against prefill(S + 1) and a batched decode step of two
    requests against each one's own."""
    free()
    cfg, model, gen = moe_model(arch, "float32", MOE_F32_CUTS[arch], seed=1)
    S, V = MOE_CHECK_S, cfg.vocab_size
    tokens = torch.randint(0, V, (2, S + 1), generator=gen, device="cuda")
    one = {"tokens": tokens[:1]}
    outs, routes = {}, {}
    for mode in ExecutionMode:
        with record_routing() as seen:
            outs[mode] = model(one, mode=mode)[..., :V]
        routes[mode] = seen
    base = outs[ExecutionMode.NON_STREAM]
    for mode, out in outs.items():
        gap = _rel(out, base)
        flips = routing_gap(routes[mode], routes[ExecutionMode.NON_STREAM])
        say(f"  f32 {cfg.num_layers} layers, S = {S + 1}, {mode.value} "
            f"against non_stream: {gap:.2e} (tol {SERVE_TOL}), tokens whose "
            f"expert set differs {flips[0]}")
        if gap > SERVE_TOL or (cfg.attn_kind == AttnKind.MLA
                               and not torch.equal(out, base)):
            fail(f"{arch} f32 {mode.value}: modes differ by {gap:.2e}"
                 + (" (MLA: must be bitwise equal)"
                    if cfg.attn_kind == AttnKind.MLA else ""))
    with plain_kernels(), record_routing() as seen:
        plain = model(one, mode=ExecutionMode.LAYER_STREAM)[..., :V]
    flips, low, low_flip = routing_gap(
        seen, routes[ExecutionMode.LAYER_STREAM])
    gap = _rel(outs[ExecutionMode.LAYER_STREAM], plain)
    say(f"  f32 kernels against plain versions: {gap:.2e} (tol "
        f"{SERVE_TOL}); tokens whose expert set differs {flips}, smallest "
        f"top-k gate margin {low:.2e} (among those {low_flip:.2e})")
    if gap > SERVE_TOL:
        fail(f"{arch} f32 kernels against plain versions: {gap:.2e}, "
             f"{flips} tokens routed otherwise")
    del outs, plain
    with runtime.flags(moe_capacity=100.0):
        longer, _ = model.prefill({"tokens": tokens[:1]}, S + 8)
        _, cache = model.prefill({"tokens": tokens[:1, :S]}, S + 8)
        step, _ = model.decode_step(cache, tokens[:1, S:])
        gap_pd = _rel(step[:, 0, :V], longer[:, -1, :V])
        caches = [model.prefill({"tokens": tokens[i:i + 1, :S]}, S + 8)[1]
                  for i in range(2)]
        batched, _ = model.decode_step(
            _stack_caches(*[_clone(c) for c in caches]), tokens[:, S:])
        single = torch.cat([model.decode_step(c, tokens[i:i + 1, S:])[0]
                            for i, c in enumerate(caches)])
        gap_b = _rel(batched[:, 0, :V], single[:, 0, :V])
    say(f"  f32, moe_capacity=100: prefill({S}) + decode step against "
        f"prefill({S + 1}) {gap_pd:.2e}; a decode step of B = 2 against "
        f"two of B = 1 {gap_b:.2e} (tol {SERVE_TOL})")
    if gap_pd > SERVE_TOL or gap_b > SERVE_TOL:
        fail(f"{arch} f32: prefill + decode {gap_pd:.2e}, batched "
             f"{gap_b:.2e}")
    del model
    free()


# ---------------------------------------------------------------------------
# Phase 17: the last three decoder configs, minitron-4b, starcoder2-7b and
# h2o-danube3-4b
# ---------------------------------------------------------------------------

def dense3_gemms(cfg) -> int:
    """tile_gemm launches of one forward or decode call: the MLP's
    projections (GELU: up, down; SwiGLU: gate, up, down) in every layer."""
    return (3 if cfg.act == "silu" else 2) * cfg.num_layers


def dense3_path(arch: str, smi: str, launches: dict) -> None:
    """``arch`` at full width and depth, bf16, random weights (seed 0): the
    forward at S = DENSE3_S in each mode (the resolved attention per layer,
    exact launches, tile_gemm on wgmma), then served by the paged Engine
    (batched decode on decode attention's tc route, tile_gemm splitk) with
    exact launch and route gates, TTFT, decode ms a call and profiled
    calls."""
    free()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L, V = cfg.num_layers, cfg.vocab_size
    say(f"  {arch} bf16, {L} layers at full width (d {cfg.d_model}, GQA "
        f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim}, {cfg.act} "
        f"MLP {cfg.d_ff}, vocab {V}"
        + (f", window {cfg.sliding_window}"
           if cfg.attn_kind == AttnKind.SLIDING else "")
        + f"), {n_params / 1e9:.2f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB [{smi}]")
    batch = {"tokens": torch.randint(0, V, (1, DENSE3_S), generator=gen,
                                     device="cuda")}
    model(batch)                                          # warm-up
    first = None
    for mode in ExecutionMode:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits = model(batch, mode=mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = dict.fromkeys(KERNELS, 0)
        kernel = attention_kernel(cfg, mode)
        if kernel:
            want[kernel] = L
        want["tile_gemm"] = dense3_gemms(cfg)
        check_call(f"{arch} forward {mode.value}", launches, want, "wgmma")
        if logits.shape[:2] != (1, DENSE3_S) \
                or not torch.isfinite(logits).all():
            fail(f"{arch} forward {mode.value}: logits "
                 f"{tuple(logits.shape)} or not finite")
        say(f"  forward {mode.value}, S = {DENSE3_S}: {ms:.1f} ms wall, "
            f"attention {kernel or 'plain (NON)'} in each of the {L} layers "
            f"(resolved {resolved(cfg, mode).value}), launches {want} "
            f"[{smi}]")
        if first is None:
            first = logits
        else:
            say(f"    against non_stream: max relative logit gap "
                f"{_rel(logits[..., :V], first[..., :V]):.2e} (bf16, not "
                f"gated; f32 below)")
        del logits
    say(f"    profile (layer_stream): "
        f"{device_breakdown(model, batch, ExecutionMode.LAYER_STREAM)} "
        f"[{smi}]")
    del first
    free()

    spec = DENSE3_REQUESTS[arch]
    fresh = make_requests(cfg, spec, gen)
    reset_counts()
    t0 = time.perf_counter()
    eng, probe, tokens = serve(cfg, model, fresh, slots=4,
                               max_len=DENSE3_MAX_LEN[arch], page_size=64,
                               profile_call=2)
    wall = time.perf_counter() - t0
    got, kroutes = counts(), route_counts()
    check_kernel_routes(arch, kroutes, got)
    profile = profile_step(probe.decode_fn, *probe.saved)
    probe.saved = None
    first_req = fresh()[0]
    prefill_profile = profile_call(probe.prefill_fn, first_req)
    tally(launches)
    n_pre, n_dec = len(probe.prefills), eng.decode_batches
    want = dict.fromkeys(KERNELS, 0)
    for _, plen, _, _ in spec:
        for lp in eng.plan_for(plen).layers:
            kernel = attention_kernel(cfg, None, ExecutionMode(lp.mode.value))
            if kernel:
                want[kernel] += 1
    want["decode_attention"] = L * n_dec
    want["tile_gemm"] = dense3_gemms(cfg) * (n_pre + n_dec)
    st = eng.stats()
    say(f"  served {st['requests']} requests (prompts "
        f"{[p for _, p, _, _ in spec]}) in {wall:.1f} s wall, {st['steps']} "
        f"steps; decode_calls {eng.decode_calls}, decode_batches {n_dec}; "
        f"launches {got} (expected {want}); tile_gemm routes: prefill "
        f"{dict(probe.routes['prefill'])}, decode "
        f"{dict(probe.routes['decode'])}")
    if got != want:
        fail(f"{arch} serving: launches {got}, expected {want}")
    if eng._pool is None or n_dec >= eng.decode_calls:
        fail(f"{arch} serving: pool {eng._pool is not None}, decode_batches "
             f"{n_dec} of {eng.decode_calls} calls; expected paged batched "
             f"decode")
    longest = max(kv for r in eng.step_log for kv in r.kv_lens)
    if cfg.attn_kind == AttnKind.SLIDING and not (
            eng._pool.width == cfg.sliding_window < longest):
        fail(f"{arch} serving: pool width {eng._pool.width}, longest row "
             f"{longest}; expected the {cfg.sliding_window}-key ring, "
             f"wrapped")
    check_routes(f"{arch} prefill", probe.routes["prefill"], "wgmma")
    check_routes(f"{arch} decode", probe.routes["decode"], "splitk")
    for rid, toks in tokens.items():
        if not all(0 <= t < V for t in toks):
            fail(f"{arch}: r{rid} emitted a token outside [0, {V})")
    say(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB [{smi}]")
    for rid, plen, ms, _ in probe.prefills:
        say(f"  prefill r{rid}, {plen} tokens: {ms:.1f} ms [{smi}]")
    ttft = st["wall"]["ttft"]
    say(f"  wall TTFT p50 {ttft['p50'] * 1e3:.1f} ms, max "
        f"{ttft['max'] * 1e3:.1f} ms [{smi}]")
    by_b = defaultdict(list)
    for b, ms, _ in probe.decodes:
        by_b[b].append(ms)
    for b in sorted(by_b):
        say(f"  decode call, B = {b}: mean {np.mean(by_b[b]):.1f} ms, min "
            f"{min(by_b[b]):.1f} ms over {len(by_b[b])} calls [{smi}]")
    n_tok = sum(len(r.decoded) for r in eng.step_log
                if r.decoded and not r.admitted)
    say(f"  decode: {n_tok} tokens in {eng.decode_wall_s():.2f} s of "
        f"pure-decode steps, {n_tok / eng.decode_wall_s():.1f} tokens/s "
        f"[{smi}]")
    say(f"  profiled decode call: {profile} [{smi}]")
    say(f"  profiled prefill of r{first_req.rid}, {len(first_req.prompt)} "
        f"tokens: {prefill_profile} [{smi}]")
    del eng, probe, model
    free()


def dense3_checks(arch: str, smi: str) -> None:
    """f32 at ``arch``'s full width, 2 layers, within SERVE_TOL: the forward
    in each mode against NON_STREAM's, the kernels against their plain
    versions, prefill(S) + a decode step against prefill(S + 1), and a
    batched decode step of two requests against each one's own.  S =
    DENSE3_CHECK_S: past h2o-danube3's window, so that its ring has
    wrapped."""
    free()
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = Transformer(cfg, device="cuda", generator=gen)
    S, V = DENSE3_CHECK_S[arch], cfg.vocab_size
    tokens = torch.randint(0, V, (2, S + 1), generator=gen, device="cuda")
    one = {"tokens": tokens[:1]}
    outs = {mode: model(one, mode=mode)[..., :V] for mode in ExecutionMode}
    base = outs[ExecutionMode.NON_STREAM]
    for mode, out in outs.items():
        gap = _rel(out, base)
        say(f"  f32 2 layers, S = {S + 1}, {mode.value} against non_stream: "
            f"{gap:.2e} (tol {SERVE_TOL})")
        if gap > SERVE_TOL:
            fail(f"{arch} f32 {mode.value}: modes differ by {gap:.2e}")
    with plain_kernels():
        reset_counts()
        plain = model(one, mode=ExecutionMode.LAYER_STREAM)[..., :V]
        if any(counts().values()):
            fail(f"{arch}: the plain forward launched {counts()}")
    gap = _rel(outs[ExecutionMode.LAYER_STREAM], plain)
    say(f"  f32 kernels against plain versions: {gap:.2e} (tol {SERVE_TOL})")
    if gap > SERVE_TOL:
        fail(f"{arch} f32 kernels against plain versions: {gap:.2e}")
    del outs, plain
    max_len = S + 8
    longer, _ = model.prefill({"tokens": tokens[:1]}, max_len)
    _, cache = model.prefill({"tokens": tokens[:1, :S]}, max_len)
    step, _ = model.decode_step(cache, tokens[:1, S:])
    gap_pd = _rel(step[:, 0, :V], longer[:, -1, :V])
    caches = [model.prefill({"tokens": tokens[i:i + 1, :S]}, max_len)[1]
              for i in range(2)]
    batched, _ = model.decode_step(
        _stack_caches(*[_clone(c) for c in caches]), tokens[:, S:])
    single = torch.cat([model.decode_step(c, tokens[i:i + 1, S:])[0]
                        for i, c in enumerate(caches)])
    gap_b = _rel(batched[:, 0, :V], single[:, 0, :V])
    W = caches[0]["layers"]["k"].shape[3]
    say(f"  f32: prefill({S}) + decode step against prefill({S + 1}) "
        f"{gap_pd:.2e}; a decode step of B = 2 against two of B = 1 "
        f"{gap_b:.2e} (tol {SERVE_TOL}); cache width {W}"
        + (f", ring wrapped ({S} > {cfg.sliding_window})"
           if cfg.attn_kind == AttnKind.SLIDING else ""))
    if gap_pd > SERVE_TOL or gap_b > SERVE_TOL:
        fail(f"{arch} f32: prefill + decode {gap_pd:.2e}, batched "
             f"{gap_b:.2e}")
    if cfg.attn_kind == AttnKind.SLIDING and not S > W == cfg.sliding_window:
        fail(f"{arch} f32: the ring ({W} slots) did not wrap at S = {S}")
    del model
    free()


# ---------------------------------------------------------------------------
# Phase 18: record/replay of the paper's model on the card
# ---------------------------------------------------------------------------

# vilbert-base planned at the paper's N = 4096, every layer forced to one
# mode; every plan op recorded once in bf16 at batch 1 (CUDA events, the
# median of REPLAY_ITERS after REPLAY_WARMUP calls).
REPLAY_N = 4096
REPLAY_WARMUP, REPLAY_ITERS = 2, 5
# qwen3-32b at 2 layers served under a recording, phase 17's request
# shape: r0 and r1 share a bucket, r2 arrives while they decode, so two
# steps decode in two buckets.
REPLAY_DECODE_SPEC = [(0, 1024, 4, 0), (1, 1024, 4, 0), (2, 256, 4, 1)]


def check_traced(what: str, plan, traced, rec) -> None:
    """The gates on a recorded plan: one op-level trace per plan op, the
    record of each op name op-level (a kernel-level record carries a
    ``parent/kernel`` or bare kernel label and never shadows an op name),
    every cycles > 0 and timed by CUDA events."""
    names = [p.name for p in tuple(plan.layers) + tuple(plan.gemms)]
    kernels = {"tile_gemm", "stream_attention"}
    op_level = [t for t in rec.records if t.op in names]
    nested = [t for t in rec.records
              if t.op not in names and "/" not in t.op
              and t.op not in kernels]
    if sorted(t.op for t in op_level) != sorted(names) or nested:
        fail(f"{what}: {len(op_level)} op-level records for {len(names)} "
             f"plan ops; records of no op and no kernel: "
             f"{[t.op for t in nested][:5]}")
    if traced.traced_ops != tuple(names):
        fail(f"{what}: traced ops {len(traced.traced_ops)} of "
             f"{len(names)}")
    bad = [t.op for t in rec.records
           if t.cycles <= 0 or t.source != "cuda_events"]
    if bad:
        fail(f"{what}: records without positive CUDA-event cycles: {bad[:5]}")


def check_replay(what: str, traced) -> int:
    """A traced plan's JSON round trip is equal and replays to the same
    makespan, and each traced op's replayed compute event lasts exactly
    its recorded cycles; returns the replayed makespan."""
    back = type(traced).from_json(traced.to_json())
    if back != traced:
        fail(f"{what}: the JSON round trip of the traced plan differs")
    res, res_back = simulate_plan(traced), simulate_plan(back)
    if res.cycles != res_back.cycles \
            or res.replayed_ops != len(traced.traced_ops):
        fail(f"{what}: replayed makespan {res.cycles} vs {res_back.cycles} "
             f"after the round trip, {res.replayed_ops} replayed ops")
    comp = {e.op: e.cycles for e in res.trace.events
            if e.kind == "compute" and e.tag.endswith(":replay")}
    for p in tuple(traced.layers) + tuple(traced.gemms):
        if comp.get(p.name) != p.trace.cycles:
            fail(f"{what}: {p.name} replays {comp.get(p.name)} cycles, "
                 f"recorded {p.trace.cycles}")
    return res.cycles


def replay_phase(smi: str, report: dict) -> None:
    """vilbert-base (the paper's model) planned at N = 4096 in each forced
    mode, every op recorded on the card in bf16, attached, round-tripped
    through JSON, replayed through the simulator and fitted (how far the
    fit reproduces the recordings, reported); the replayed
    makespans beside the analytic ``compare_modes`` ordering; then
    ``served_decode_records``."""
    free()
    cfg = get_config("vilbert-base")
    analytic = compare_modes(cfg, seq_len=REPLAY_N)
    replayed, self_ms, cals = {}, {}, {}
    for mode in ExecutionMode:
        plan = plan_model(cfg, seq_len=REPLAY_N, mode=mode, force_mode=True)
        t0 = time.perf_counter()
        traced, rec = record_plan(plan, dtype=torch.bfloat16,
                                  warmup=REPLAY_WARMUP, iters=REPLAY_ITERS,
                                  device="cuda")
        wall = time.perf_counter() - t0
        what = f"vilbert-base {mode.value} N = {REPLAY_N}"
        check_traced(what, plan, traced, rec)
        replayed[mode] = check_replay(what, traced)
        if mode == ExecutionMode.TILE_STREAM:
            check_stream_grids(what, traced)
        cal = fit_calibration(traced)
        if not all(math.isfinite(s) and s > 0 for s in cal.scale.values()):
            fail(f"{what}: calibration scales {cal.scale}")
        cals[mode] = cal
        # How well the fit reproduces the recordings, reported and not
        # gated: the fit (the JAX package's, which the port equals) does
        # not reproduce the card's LAYER_STREAM records (PERF.md), and its
        # per-resource scales are under-determined, so they are not
        # printed as a result.
        fit = calibration_fit(traced, cal)
        calibrated = simulate_plan(plan, calibration=cal).cycles
        ms = {k: sum(p.trace.wall_time_s for p in
                     tuple(traced.layers) + tuple(traced.gemms)
                     if p.trace.kind == k) * 1e3
              for k in cal.per_class}
        self_ms[mode] = traced.layer("cox0_self").trace
        ratios = ", ".join(
            f"{k} {c['count']} ops {ms[k]:.2f} ms, recorded/analytic "
            f"{c['ratio']:.4g} (mean |rel err| {c['mean_abs_rel_err']:.4g})"
            for k, c in cal.per_class.items())
        say(f"  {what}: {len(traced.traced_ops)} ops recorded in {wall:.1f} "
            f"s; {ratios}; the fit models them at "
            f"{ {k: round(f, 4) for k, f in fit.items()} } x recorded; the "
            f"calibrated simulator's makespan {calibrated} cycles, "
            f"{calibrated / replayed[mode]:.4f} x replayed [{smi}]")
    order = sorted(ExecutionMode, key=lambda m: replayed[m])
    a_order = sorted(ExecutionMode, key=lambda m: analytic[m].cycles)
    for mode in ExecutionMode:
        say(f"  {mode.value}: replayed makespan {replayed[mode]} cycles "
            f"({replayed[mode] / 1e6:.3f} ms at 1 GHz, the H100's recorded "
            f"op times end to end), analytic {analytic[mode].cycles} cycles "
            f"[{smi}]")
    say(f"  order, fastest first: replayed on the H100 "
        f"{[m.value for m in order]}; analytic simulator "
        f"{[m.value for m in a_order]}")
    tile, layer = (self_ms[ExecutionMode.TILE_STREAM],
                   self_ms[ExecutionMode.LAYER_STREAM])
    say(f"  recorded vision self-attention (cox0_self, B = 1, q "
        f"(1, 8, {REPLAY_N}, 128)): tile_stream {tile.wall_time_s * 1e3:.3f}"
        f" ms (grid {tile.grid}, rows {tile.block_q}), layer_stream (K/V "
        f"materialized + flash) {layer.wall_time_s * 1e3:.3f} ms (grid "
        f"{layer.grid}); phase 3's kernels at vision self 4096, B = 2: "
        f"stream {report['stream_attention']['ms']:.3f} ms, flash "
        f"{report['flash_attention']['ms']:.3f} ms [{smi}]")
    free()

    calibrated_dse(smi, cals[ExecutionMode.TILE_STREAM])
    served_decode_records(smi, report)


# The DSE on the card's calibration: design points of the sweep (the three
# presets first, then the grid), at the recorded plan's N.
DSE_POINTS = 6
DSE_CHIPS = 4


def calibrated_dse(smi: str, cal) -> None:
    """The JAX package's record -> calibrate -> sweep workflow on the
    card's fit: vilbert-base's TILE_STREAM CalibrationReport written to
    JSON and read back, the DSE swept under the analytic and the
    calibrated timing (the analytic rows must equal a sweep without
    calibration, the calibrated ones be finite and positive), both
    frontiers and the design points that move on or off it; then one
    sharded plan (TILE_STREAM, DSE_CHIPS simulated chips) simulated with
    the same calibration and rendered by timeline_from_sharded.  Host
    work: it touches no device."""
    t0 = time.perf_counter()
    path = ROOT / "build" / "calibration_vilbert_tile.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(cal.to_json(indent=1))
    back = CalibrationReport.from_json(path.read_text())
    if back != cal:
        fail(f"the calibration's JSON round trip differs: {back} vs {cal}")
    kw = dict(models=["vilbert-base"], points=DSE_POINTS,
              seq_lens=(REPLAY_N,))
    res = run_sweep(calibrations=(None, back), **kw)
    plain = run_sweep(**kw)
    label = res.calibrations()[1]
    if [r.to_dict() for r in res.rows if r.calibration == "analytic"] != \
            [r.to_dict() for r in plain.rows]:
        fail("the calibrated sweep's analytic rows differ from a sweep "
             "without calibration")
    rows = res.rows_for("vilbert-base", calibration=label)
    if len(rows) != DSE_POINTS or not all(
            0 < r.latency_cycles and 0 < r.energy_pj < math.inf
            and math.isfinite(r.edp) for r in rows):
        fail(f"calibrated DSE rows not finite and positive: "
             f"{[(r.hw, r.latency_cycles, r.energy_pj) for r in rows]}")
    fronts = {}
    for c in res.calibrations():
        front = res.pareto("vilbert-base", calibration=c)
        fronts[c] = [r.hw for r in front]
        say(f"  DSE vilbert-base N = {REPLAY_N}, {c} timing: "
            + "; ".join(f"{r.hw} {r.latency_cycles} cycles "
                        f"{r.energy_pj / 1e6:.1f} uJ"
                        for r in res.rows_for("vilbert-base",
                                              calibration=c))
            + f"; frontier {fronts[c]}")
    on = [h for h in fronts[label] if h not in fronts["analytic"]]
    off = [h for h in fronts["analytic"] if h not in fronts[label]]
    say(f"  DSE frontier under the card's calibration ({label}, scale "
        f"{ {k: round(v, 4) for k, v in back.scale.items()} }): moved on "
        f"{on}, moved off {off} [{smi}]")
    plan = plan_model(get_config("vilbert-base"), seq_len=REPLAY_N,
                      mode=ExecutionMode.TILE_STREAM, force_mode=True)
    splan = shard_plan(plan, MeshSpec(chips=DSE_CHIPS))
    sharded = simulate_sharded_plan(splan, calibration=back)
    analytic = simulate_sharded_plan(splan)
    tl = timeline_from_sharded(sharded)
    validate_timeline(tl)
    procs = {e["args"]["name"] for e in tl["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    if not {f"chip{i}" for i in range(DSE_CHIPS)} | {"noc"} <= procs:
        fail(f"timeline_from_sharded: processes {sorted(procs)}")
    say(f"  sharded vilbert-base tile_stream on {DSE_CHIPS} simulated chips "
        f"({splan.axis} axis): {sharded.cycles} cycles calibrated, "
        f"{analytic.cycles} analytic, collective bytes "
        f"{sharded.collective_bytes}; timeline {len(tl['traceEvents'])} "
        f"events over {len(procs)} processes; DSE and shard took "
        f"{time.perf_counter() - t0:.1f} s of host time")


def calibration_fit(traced, cal) -> dict:
    """Per op class, the fit's model of the traced ops over their recorded
    cycles: sum over ops of analytic busy cycles per resource times the
    fitted scale, over the sum of recorded cycles."""
    prof = analytic_op_profile(traced)
    model, recorded = defaultdict(float), defaultdict(int)
    for p in tuple(traced.layers) + tuple(traced.gemms):
        model[p.trace.kind] += sum(b * cal.scale[r] for r, b in
                                   prof[p.name]["busy"].items())
        recorded[p.trace.kind] += p.trace.cycles
    return {k: model[k] / recorded[k] for k in recorded}


def check_stream_grids(what: str, traced) -> None:
    """Each TILE_STREAM op's recorded grid and rows, as the stream library
    noted them at its launch, against the library's exported launch
    configuration (``stream_attention_config``): whole clusters of
    row tiles, per kv head, batch 1."""
    for lp in traced.layers:
        G = lp.heads // lp.kv_heads
        rows, cluster, _ = stream_config(G, lp.seq_q)
        tiles = -(-G * lp.seq_q // rows)
        want = (-(-tiles // cluster) * cluster, lp.kv_heads, 1)
        if (lp.trace.grid, lp.trace.block_q) != (want, rows):
            fail(f"{what}: {lp.name} recorded grid {lp.trace.grid}, rows "
                 f"{lp.trace.block_q}; the library's configuration gives "
                 f"{want}, rows {rows}")


def served_decode_records(smi: str, report: dict) -> None:
    """qwen3-32b (2 layers, bf16, full width) served under a recording with
    REPLAY_DECODE_SPEC: every decode_step call's records attach to the
    plan of its own bucket (``Engine.traced_plans``), two steps run two
    buckets; then the per-slot ``ops.decode_attention_by_plan`` (flash at
    a decode shape) recorded once against its plain version."""
    qcfg = dataclasses.replace(get_config("qwen3-32b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer(qcfg, device="cuda", generator=gen)
    fresh = make_requests(qcfg, REPLAY_DECODE_SPEC, gen)
    eng = Engine(qcfg, model, slots=3,
                 max_len=max(p + n for _, p, n, _ in REPLAY_DECODE_SPEC) + 8,
                 page_size=64)
    for r in fresh():
        eng.submit(r)
    with recording(KernelRecorder(warmup=REPLAY_WARMUP,
                                  iters=REPLAY_ITERS)) as rec:
        eng.run()
    multi = []
    for step in (r for r in eng.step_log if r.decoded):
        plans = eng.traced_plans.get(step.step, ())
        if len(plans) != len(step.buckets):
            fail(f"qwen3-32b decode step {step.step}: {len(plans)} traced "
                 f"plans for buckets {step.buckets}")
        for plan, (kv, rids) in zip(plans, step.buckets):
            names = tuple(lp.name for lp in plan.layers)
            if plan.traced_ops != names or any(
                    lp.seq_kv != (kv,) * len(rids)
                    or lp.trace.kind != "decode" or lp.trace.cycles <= 0
                    or lp.trace.source != "cuda_events"
                    for lp in plan.layers):
                fail(f"qwen3-32b decode step {step.step}, bucket kv {kv} "
                     f"x {len(rids)}: traced {plan.traced_ops} of {names}, "
                     f"or a record without positive CUDA-event cycles")
            if type(plan).from_json(plan.to_json()) != plan:
                fail(f"qwen3-32b decode step {step.step}: the JSON round "
                     f"trip of a traced bucket plan differs")
        if len(plans) > 1:
            multi.append((step, plans))
    if len(multi) < 2:
        fail(f"qwen3-32b decode: {len(multi)} steps ran more than one "
             f"bucket, expected 2")
    step, plans = multi[-1]
    per = "; ".join(
        f"bucket kv {kv} x {len(rids)}: " + ", ".join(
            f"{lp.name} {lp.trace.wall_time_s * 1e6:.1f} us (grid "
            f"{lp.trace.grid}, {lp.trace.hbm_bytes} B predicted)"
            for lp in plan.layers)
        for plan, (kv, rids) in zip(plans, step.buckets))
    say(f"  qwen3-32b (2 layers) served under a recording: "
        f"{len(eng.traced_plans)} decode steps traced, {len(multi)} of them "
        f"in two buckets; step {step.step}: {per}; {len(rec.records)} "
        f"records in the run "
        f"({sum(t.kind == 'gemm' for t in rec.records)} kernel-level "
        f"tile_gemm); phase 3's decode attention at the qwen3-32b bucket "
        f"of 4: {report['decode_attention']['ms']:.4f} ms [{smi}]")
    del eng, model
    free()

    S = REPLAY_DECODE_SPEC[0][1]
    dlp = plan_decode_step(qcfg, (S,)).layers[0]
    q = randn(gen, 1, qcfg.num_heads, 1, qcfg.head_dim, dtype=torch.bfloat16)
    k, v = (randn(gen, 1, qcfg.num_kv_heads, S, qcfg.head_dim,
                  dtype=torch.bfloat16) for _ in range(2))
    before = flash_attention.launches
    with recording(KernelRecorder(warmup=REPLAY_WARMUP,
                                  iters=REPLAY_ITERS)) as rec:
        got = ops.decode_attention_by_plan(dlp, q, k, v)
    launched = flash_attention.launches - before
    err = compare("flash_attention", f"decode_attention_by_plan kv {S}",
                  got, blocked.flash_attention_plain(q, k, v))
    (t,) = rec.records
    if launched != REPLAY_WARMUP + REPLAY_ITERS or t.op != dlp.name \
            or t.kind != "decode" or t.cycles <= 0 \
            or t.source != "cuda_events" or t.grid[1:] != (
                qcfg.num_kv_heads, 1):
        fail(f"decode_attention_by_plan: {launched} flash launches, record "
             f"{t}")
    say(f"  ops.decode_attention_by_plan (per slot, flash) at q (1, "
        f"{qcfg.num_heads}, 1, {qcfg.head_dim}), kv {S}, bf16: max |err| "
        f"{err:.2e} against the plain version, {launched} flash launches, "
        f"recorded {t.wall_time_s * 1e6:.1f} us, grid {t.grid}, rows "
        f"{t.block_q} [{smi}]")


# ---------------------------------------------------------------------------
# Phase 21: the rest of single-card inference
# ---------------------------------------------------------------------------

# launch.serve at starcoder2-7b's full CONFIG (the launcher's own request
# draw: 8 prompts of 4-63 tokens, 16 new tokens each)
LAUNCH_ARGV = ["--arch", "starcoder2-7b", "--requests", "8", "--max-new",
               "16", "--slots", "4", "--max-len", "256"]
# ops.projection under quantize_proj, bf16: vilbert-base's text MLP and
# starcoder2-7b's MLP at a prefill's rows and at a decode bucket's (M = 4,
# which the wrapper pads to 32 rows for torch._int_mm)
INT8_SHAPES = {"vilbert-base mlp up": (8192, 768, 3072),
               "vilbert-base mlp down": (8192, 3072, 768),
               "starcoder2-7b mlp up 1024": (1024, 4608, 18432),
               "starcoder2-7b mlp down 1024": (1024, 18432, 4608),
               "starcoder2-7b mlp up 4": (4, 4608, 18432),
               "starcoder2-7b mlp down 4": (4, 18432, 4608)}
# rows of each shape that also go through the whole CPU path (its int32
# product runs at ~10 GOP/s on the host; the card's int32 sums are held
# to an exact f64 product on every row)
INT8_CPU_ROWS = 64
INT8_PEAK = 1979e12          # H100 SXM dense int8 tensor-core ops/s
QUANT_MODE = ExecutionMode.LAYER_STREAM
EXAMPLE_RUNS = (["examples/torch_quickstart.py"],
                ["examples/torch_crossmodal_pruning.py"],
                ["examples/torch_serve_batch.py"])
OBS_RUNS = (["-m", "repro_torch.obs", "--rewrite-stall", "--critpath"],
            ["-m", "repro_torch.obs", "--model", "vilbert-base", "--mode",
             "tile_stream", "--critpath", "--whatif", "ATTN:2"])


def served_tokens(what: str, cfg, reqs, done) -> dict:
    """{rid: tokens}; fails unless every request returned its token budget
    of ids inside the vocabulary."""
    tokens = {r.rid: list(r.out_tokens) for r in done}
    for r in reqs:
        got = tokens.get(r.rid, [])
        if len(got) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in got):
            fail(f"{what}: request r{r.rid} returned {got} "
                 f"({r.max_new_tokens} tokens in [0, {cfg.vocab_size}) "
                 f"expected)")
    return tokens


def serve_parity(what: str, eng, reqs):
    """simulate_serve over ``reqs`` with the engine's own prefill and
    decode plans, held to ``eng.stats()`` by assert_serve_parity."""
    sim = simulate_serve(eng.cfg, [ServeRequest(r.rid, len(r.prompt),
                                                r.max_new_tokens,
                                                r.arrival_step)
                                   for r in reqs],
                         slots=eng.slots, plan_fn=eng.plan_for,
                         decode_plan_fn=eng.decode_plan_for)
    try:
        assert_serve_parity(eng.stats(), sim.metrics)
    except AssertionError as e:
        fail(f"{what}: engine and simulate_serve disagree: {e}")
    return sim


def serve_wall_s(eng) -> float:
    """The engine's serving wall time: first step's start to last step's
    end, on its own clock."""
    walls = eng._step_walls.values()
    return max(e for _, e in walls) - min(s for s, _ in walls)


def profiled_serve(cfg, model, reqs, **engine_kw) -> str:
    """The same requests served once more by a fresh Engine under
    torch.profiler (device activity only): device time, wall time, busy
    share, kernel count.  The run launches ~2e5 kernels, so the device
    times are summed from the raw records: building the profiler's event
    tree for them (``key_averages``) takes minutes."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(cfg, model, **engine_kw)
    for r in reqs:
        eng.submit(dataclasses.replace(r, out_tokens=None))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    durs = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]
    busy = sum(durs) / 1e3
    if busy == 0:
        return "profiler recorded no device time"
    return (f"device {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
            f"({100 * busy / wall_us:.0f}% busy), {len(durs)} kernels and "
            f"copies")


def launcher_serving(smi: str, launches: dict):
    """(a) ``launch.serve.run`` at starcoder2-7b's full CONFIG with exact
    launch gates and engine==simulator parity; returns its engine, the
    drawn requests and their tokens."""
    args = launch_serve.parse(LAUNCH_ARGV)
    cfg = get_config(args.arch)
    free()
    reset_counts()
    i0 = quant.int8_mm.launches
    t0 = time.perf_counter()
    eng, done = launch_serve.run(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got, routes = counts(), route_counts()
    tally(launches)
    reqs = launch_serve.draw_requests(cfg, args.requests, args.max_len,
                                      args.max_new)
    tokens = served_tokens("launch.serve", cfg, reqs, done)
    check_kernel_routes("launch.serve", routes, got)
    gemm = routes["tile_gemm"]
    if got["tile_gemm"] == 0 or gemm["mma"] or gemm["simt"] \
            or got["flash_attention"] == 0 or got["stream_attention"] \
            or quant.int8_mm.launches != i0 \
            or got["decode_attention"] != cfg.num_layers * eng.decode_batches:
        fail(f"launch.serve: launches {got}, tile_gemm routes {gemm}, "
             f"int8 products {quant.int8_mm.launches - i0} do not fit the "
             f"path (decode attention {cfg.num_layers} x "
             f"{eng.decode_batches} batches)")
    serve_parity("launch.serve", eng, reqs)
    wall = serve_wall_s(eng)
    n = sum(len(t) for t in tokens.values())
    gb = sum(p.numel() * p.element_size()
             for p in eng.model.parameters()) / 1e9
    say(f"  launch.serve --arch {args.arch}: {len(done)} requests, {n} new "
        f"tokens in {wall:.2f} s of serving ({n / wall:.1f} tokens/s; "
        f"{total:.1f} s with the build of its {gb:.1f} GB of weights), "
        f"{eng.stats()['steps']} steps, decode_batches "
        f"{eng.decode_batches}; launches {got}, tile_gemm routes {gemm}; "
        f"assert_serve_parity against simulate_serve with the engine's "
        f"plans holds [{smi}]")
    profile = profiled_serve(cfg, eng.model, reqs, slots=args.slots,
                             max_len=args.max_len)
    say(f"  the same requests served again under torch.profiler: "
        f"{profile} [{smi}]")
    return eng, reqs, tokens


def check_int8(gen, smi: str) -> list:
    """(b) ops.projection under quantize_proj at INT8_SHAPES in bf16: int8
    operands, scales and output bitwise equal to the CPU plain path's on
    the same inputs; timed beside tile_gemm, torch._int_mm alone,
    torch.matmul and the bound."""
    rows = []
    for name, (M, K, N) in INT8_SHAPES.items():
        x = randn(gen, M, K, dtype=torch.bfloat16)
        w = randn(gen, K, N, dtype=torch.bfloat16, scale=K ** -0.5)
        g0 = tile_gemm.launches
        i0 = quant.int8_mm.launches
        with runtime.flags(quantize_proj=True):
            out = ops.projection(x, w)
        if quant.int8_mm.launches != i0 + 1 or tile_gemm.launches != g0:
            fail(f"int8 {name}: ops.projection under quantize_proj did not "
                 f"take the int8 path")
        xq, sx = quant.quantize_rows(x.float())
        wq, sw = quant.quantize_cols(w.float())
        acc = quant.int8_mm(xq, wq)
        xc, wc = x.cpu(), w.cpu()
        cxq, csx = quant.quantize_rows(xc.float())
        cwq, csw = quant.quantize_cols(wc.float())
        for what, a, b in (("x int8", xq, cxq), ("x scales", sx, csx),
                           ("w int8", wq, cwq), ("w scales", sw, csw)):
            if not torch.equal(a.cpu(), b):
                fail(f"int8 {name}: {what} differ from the CPU path's")
        if acc.dtype != torch.int32 or not torch.equal(
                acc.double(), xq.double() @ wq.double()):
            fail(f"int8 {name}: the int32 sums are not the exact product")
        if not torch.equal(out.cpu(),
                           (acc.cpu().float() * csx * csw).to(x.dtype)):
            fail(f"int8 {name}: output differs from the CPU dequantization")
        r = min(M, INT8_CPU_ROWS)
        with runtime.flags(quantize_proj=True):
            plain = ops.projection(xc[:r], wc)
        if not torch.equal(out[:r].cpu(), plain):
            fail(f"int8 {name}: the first {r} rows differ from the CPU "
                 f"plain path's")
        with runtime.flags(quantize_proj=True):
            ms = time_ms(lambda: ops.projection(x, w))
        mm_ms = time_ms(lambda: quant.int8_mm(xq, wq))
        # the same product with w's int8 copy column-major (K contiguous:
        # the layout cuBLASLt's int8 tensor-core kernels read), not what
        # the port runs: a measurement for its own int8 kernel
        wq_t = wq.t().contiguous().t()
        tn_ms = (time_ms(lambda: torch._int_mm(xq, wq_t)) if M > 16 and
                 K % 8 == 0 and N % 8 == 0 else None)
        quant_ms = time_ms(lambda: quant.quantize_cols(w.float()))
        gemm_ms = time_ms(lambda: tile_gemm(x, w))
        lib_ms = time_ms(lambda: torch.matmul(x, w))
        n_ops, nbytes = 2 * M * K * N, 2 * (M * K + K * N + M * N)
        t_ops, t_bytes = n_ops / INT8_PEAK, nbytes / HBM_BYTES_PER_S
        rows.append({"name": name, "shape": [M, K, N], "ms": ms,
                     "int_mm_ms": mm_ms, "int_mm_col_major_w_ms": tn_ms,
                     "quantize_cols_ms": quant_ms,
                     "tile_gemm_ms": gemm_ms,
                     "tile_gemm_route": route_of(M, K, N, 1),
                     "library_ms": lib_ms,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "bitwise_rows_cpu": r})
        say(f"  int8 projection {name} ({M}, {K}) @ ({K}, {N}) bf16: "
            f"bitwise equal to the CPU path ({r} rows whole, every row's "
            f"int8 operands, scales, int32 sums and dequantization); "
            f"{ms:.4f} ms (torch._int_mm alone {mm_ms:.4f}, with w "
            f"column-major {'-' if tn_ms is None else f'{tn_ms:.4f}'}, "
            f"quantize_cols {quant_ms:.4f}), tile_gemm bf16 {gemm_ms:.4f} "
            f"({rows[-1]['tile_gemm_route']}), torch.matmul {lib_ms:.4f}, "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}) "
            f"[{smi}]")
        del x, w, out, xq, wq, wq_t, acc, xc, wc, cxq, cwq, plain
        free()
    return rows


def quantized_paths(smi: str, launches: dict, eng, reqs, tokens) -> None:
    """(c) vilbert-base's forward and starcoder2-7b's serving under
    quantize_proj: no tile_gemm launch, every MLP product on the int8
    path, finite logits, parity, tokens in range."""
    cfg = get_config("vilbert-base")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = ViLBERT(cfg, device="cuda", generator=gen)
    batch = make_batch(cfg, 2, 4096, gen)
    base = model(batch, mode=QUANT_MODE)
    mlps = cfg.num_layers - cfg.num_coattn_layers + 2 * cfg.num_coattn_layers
    want_int8 = mlps * (3 if cfg.act == "silu" else 2)
    with runtime.flags(quantize_proj=True):
        model(batch, mode=QUANT_MODE)                    # warm-up
        torch.cuda.synchronize()
        reset_counts()
        i0 = quant.int8_mm.launches
        t0 = time.perf_counter()
        out, kept = model(batch, mode=QUANT_MODE, return_token_counts=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    got = tally(launches)
    n_int8 = quant.int8_mm.launches - i0
    if out.shape != (2, 3129) or not torch.isfinite(out).all():
        fail("vilbert-base under quantize_proj: logits not finite (2, 3129)")
    if got["tile_gemm"] or n_int8 != want_int8 or kept != EXPECTED_COUNTS \
            or got["flash_attention"] == 0:
        fail(f"vilbert-base under quantize_proj: launches {got}, {n_int8} "
             f"int8 products ({want_int8} expected: {mlps} MLPs), kept "
             f"{kept}")
    say(f"  vilbert-base {QUANT_MODE.value} under quantize_proj (B = 2, N = "
        f"4096, bf16): wall {wall:.1f} ms, launches {got}, {n_int8} int8 "
        f"products, no tile_gemm; logits' max gap to the bf16 forward "
        f"{_rel(out.float(), base.float()):.3e} of its largest [{smi}]")
    del model, batch, base, out
    free()

    cfg = eng.cfg
    qeng = Engine(cfg, eng.model, slots=eng.slots, max_len=eng.max_len)
    for r in reqs:
        qeng.submit(dataclasses.replace(r, out_tokens=None))
    reset_counts()
    i0 = quant.int8_mm.launches
    with runtime.flags(quantize_proj=True):
        done = qeng.run()
    got, routes = counts(), route_counts()
    tally(launches)
    n_int8 = quant.int8_mm.launches - i0
    want_int8 = 2 * cfg.num_layers * (len(reqs) + qeng.decode_batches)
    qtokens = served_tokens("starcoder2-7b under quantize_proj", cfg, reqs,
                            done)
    check_kernel_routes("starcoder2-7b under quantize_proj", routes, got)
    if got["tile_gemm"] or n_int8 != want_int8:
        fail(f"starcoder2-7b under quantize_proj: launches {got}, {n_int8} "
             f"int8 products ({want_int8} expected)")
    serve_parity("starcoder2-7b under quantize_proj", qeng, reqs)
    pairs = [(a, b) for rid in tokens for a, b in zip(tokens[rid],
                                                      qtokens[rid])]
    same = sum(a == b for a, b in pairs)
    wall = serve_wall_s(qeng)
    n = len(pairs)
    say(f"  starcoder2-7b served under quantize_proj: {n} tokens in "
        f"{wall:.2f} s ({n / wall:.1f} tokens/s), launches {got}, {n_int8} "
        f"int8 products, no tile_gemm, parity holds; {same} of {n} greedy "
        f"tokens ({100 * same / n:.0f}%) equal to the bf16 run's [{smi}]")


def run_scripts(smi: str) -> None:
    """(d) the three examples on the card and the obs CLI, as
    subprocesses from the checkout root, all started together (the
    examples' printed times therefore share the card); each must exit 0
    (the quickstart asserts its three modes within 1e-4 in f32)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [(argv, subprocess.Popen(
        [sys.executable, *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for argv in EXAMPLE_RUNS + OBS_RUNS]
    for argv, proc in procs:
        what = " ".join(argv)
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            out, err = "", "no exit within 600 s"
        if proc.returncode != 0:
            for _, p in procs:
                p.kill()
            fail(f"{what}: exit {proc.returncode}\n{out[-2000:]}\n"
                 f"{err[-4000:]}")
        lines = [ln for ln in out.splitlines() if ln.strip()]
        agree = "all three execution systems agree (allclose) ✓"
        if argv[0] == "examples/torch_quickstart.py" and agree not in lines:
            fail(f"{what}: the three modes' check did not run")
        say(f"  {what}: exit 0, done {time.perf_counter() - t0:.1f} s after "
            f"the start [{smi}]")
        for ln in lines[:3] + (["  ..."] if len(lines) > 6 else []) \
                + lines[max(3, len(lines) - 3):]:
            say(f"    | {ln}")


def rest_of_inference(smi: str, launches: dict, report: dict) -> None:
    """Phase 21: the launcher, the int8 projection, quantized forwards and
    serving, the examples and the obs CLI."""
    t0 = time.perf_counter()
    eng, reqs, tokens = launcher_serving(smi, launches)
    say(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    report["int8_projection"] = check_int8(
        torch.Generator(device="cuda").manual_seed(21), smi)
    say(f"  (b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    quantized_paths(smi, launches, eng, reqs, tokens)
    del eng
    free()
    say(f"  (c) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    run_scripts(smi)
    say(f"  (d) took {time.perf_counter() - t1:.1f} s")
    say(f"  phase 21 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 23: multi-GPU on torch.distributed
# ---------------------------------------------------------------------------

# (a) The one-rank NCCL host mesh on the card: Engine(mesh=...) against
# Engine(mesh=None) with the same per-slot decode (B = 1 a call, as serving
# on a mesh keeps it), at full width and depth (phases 14 and 17 serve both
# archs there), three requests each; train(mesh=...) against
# train(mesh=None) at phase 10's qwen3-32b cut (4 layers, B = 1, S = 4096).
MESH_ARCHS = ("starcoder2-7b", "qwen2-vl-2b")
MESH_REQUESTS = [(0, 1024, 16, 0), (1, 1024, 16, 0), (2, 256, 16, 1)]
MESH_MAX_LEN = 1024 + 16 + 8
MESH_TRAIN = ("qwen3-32b", {"num_layers": 4}, 1, 4096, 3)
# (c) The dry run on the host: one cell per family on the fake (16, 16)
# world and one on (2, 16, 16), each in its own process, all at once, at
# full depth with the CLI's defaults; the train cells of DRYRUN_OPTIONS
# cut in depth.
# qwen3-32b's train_4k cell, the production mesh's training arch, runs at
# full depth with one microbatch: the automatic count (16) traces every
# layer 16 times, ~16x the trace time, for the same FLOPs a device.
DRYRUN_CELLS = (("starcoder2-7b", "decode_32k", False),
                ("deepseek-v3-671b", "decode_32k", False),
                ("qwen2-vl-2b", "train_4k", False),
                ("mamba2-780m", "long_500k", False),
                ("hymba-1.5b", "decode_32k", False),
                ("whisper-base", "decode_32k", False),
                ("whisper-base", "train_4k", True),
                ("qwen3-32b", "train_4k", False),
                ("deepseek-v3-671b", "train_4k", False),
                ("grok-1-314b", "train_4k", False),
                ("starcoder2-7b", "train_4k", False),
                ("mamba2-780m", "train_4k", False),
                ("whisper-base", "train_4k", False),
                ("vilbert-large", "train_4k", False))
DRYRUN_MICROBATCHES = {("qwen3-32b", "train_4k", False): 1}
# the train cells of the MoE family, of context-parallel attention and of
# the families split over 'model' since the SSM projections, cut in depth
# (their FLOPs a device against the model's do not depend on it much):
# each its options for run_cell_subprocess and the most FLOPs a device it
# may count, in multiples of the model's (the parent trees', which
# computed experts, MLA and starcoder2's attention whole on every 'model'
# rank: 27.79x, 15.68x, 6.70x; and the SSM projections, whisper and
# vilbert: 4.640x, 19.126x, 9.936x)
DRYRUN_OPTIONS = {
    ("deepseek-v3-671b", "train_4k", False): ({"depth": 4}, 3.0),
    ("grok-1-314b", "train_4k", False): ({"depth": 2}, 2.5),
    ("starcoder2-7b", "train_4k", False): (
        {"depth": 4, "optimized": True}, 2.5),
    ("mamba2-780m", "train_4k", False): ({"depth": 1}, 2.0),
    ("whisper-base", "train_4k", False): (
        {"depth": 1, "optimized": True}, 3.0),
    ("vilbert-large", "train_4k", False): ({"depth": 1}, 1.5)}
DRYRUN_TIMEOUT_S = 300
# the qwen3-32b train cell's gates: FLOPs a device at most this many times
# the model's (the step that gathered whole parameters: 18.4x at 4
# layers), arguments within 1% of the rule table's blocks
DRYRUN_FLOP_RATIO = 2.5


def start_dryrun(out_dir: Path) -> list:
    """Start every DRYRUN_CELLS cell as its own process (killed at exit if
    still running); returns [(cell, Popen)]."""
    import atexit
    from repro_torch.launch.dryrun import run_cell_subprocess
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        cell = (arch, shape, multi_pod)
        opts = DRYRUN_OPTIONS.get(cell, ({}, None))[0]
        p = run_cell_subprocess(
            arch, shape, multi_pod=multi_pod, out_dir=str(out_dir),
            microbatches=DRYRUN_MICROBATCHES.get(cell, 0), **opts)
        procs.append(((arch, shape, multi_pod), p))
    atexit.register(lambda: [p.kill() for _, p in procs
                             if p.poll() is None])
    return procs


def collect_dryrun(procs: list, out_dir: Path, smi: str) -> None:
    """Wait for the dry-run cells; each must be status ok with the fields
    of the JAX artifact, and its JSON must round-trip."""
    keys = ("status", "microbatches", "hlo_flops_per_device",
            "hlo_bytes_per_device", "model_flops_per_device", "memory",
            "collectives", "roofline")
    t0 = time.perf_counter()
    for (arch, shape, multi_pod), p in procs:
        try:
            out, _ = p.communicate(timeout=max(
                DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            fail(f"dry run {arch} {shape}: no result in {DRYRUN_TIMEOUT_S} s")
        mesh = "2x16x16" if multi_pod else "16x16"
        opts, most = DRYRUN_OPTIONS.get((arch, shape, multi_pod),
                                        ({}, None))
        tag = "__optimized" if opts.get("optimized") else ""
        path = out_dir / f"{arch}__{shape}__{mesh}{tag}.json"
        if p.returncode != 0 or not path.exists():
            fail(f"dry run {arch} {shape} {mesh}: exit {p.returncode}: "
                 f"{out[-600:]}")
        text = path.read_text()
        r = json.loads(text)
        if r.get("status") != "ok" or any(k not in r for k in keys):
            fail(f"dry run {arch} {shape} {mesh}: {text[:600]}")
        if json.loads(json.dumps(r)) != r:
            fail(f"dry run {arch} {shape} {mesh}: JSON does not round-trip")
        m, c, rf = r["memory"], r["collectives"], r["roofline"]
        if multi_pod and r["collectives"]["dcn_traffic_bytes"] <= 0:
            fail(f"dry run {arch} {shape} {mesh}: no cross-pod traffic")
        if "gathered_step" in r:
            fail(f"dry run {arch} {shape} {mesh}: a gathered step")
        if (arch, shape) == ("qwen3-32b", "train_4k"):
            sharded_train_cell(r, smi)
        if most is not None:
            split_train_cell(r, most, smi)
        axes = ", ".join(f"{a} {b:.4g}"
                         for a, b in c["traffic_by_axis"].items())
        say(f"  dry run [{mesh}] {arch} {shape} (analysis on the H100's "
            f"datasheet rates): {r['hlo_flops_per_device']:.4g} FLOPs and "
            f"{r['hlo_bytes_per_device']:.4g} bytes a device, model "
            f"{r['model_flops_per_device']:.4g} (useful "
            f"{r['useful_flop_ratio']:.3f}), microbatches "
            f"{r['microbatches']}; memory {m['total_bytes'] / 2 ** 30:.2f} "
            f"GiB a device (arguments {m['argument_bytes'] / 2 ** 30:.2f}, "
            f"temporaries {m['temp_bytes'] / 2 ** 30:.2f}); collectives "
            f"{c['counts']}, in-pod {c['ici_traffic_bytes']:.4g} bytes, "
            f"cross-pod {c['dcn_traffic_bytes']:.4g} (by axis {axes}); "
            f"roofline compute "
            f"{rf['compute_s']:.4g} s, memory {rf['memory_s']:.4g}, "
            f"collective {rf['collective_s']:.4g}, cross-pod "
            f"{rf['dcn_s']:.4g}: {rf['bottleneck']}, step "
            f"{rf['step_time_est_s']:.4g} s, roofline fraction "
            f"{rf['roofline_fraction']:.4f}; traced in {r['compile_s']} s")
    say(f"  dry run: {len(procs)} cells ok, every family's [{smi}]")


def shard_bytes(cfg, sizes: dict) -> int:
    """The rule table's blocks of ``cfg``'s parameters at ``sizes``, each
    in its dtype and with two f32 AdamW moments."""
    from repro_torch.distributed import sharding as SH
    specs = registry.param_specs(cfg)
    sh = SH.param_shardings(specs, cfg, axis_sizes=sizes)
    total = 0
    for k, spec in specs.items():
        n = 1
        for d, entry in zip(spec.shape, sh[k].spec):
            n *= d // math.prod(sizes[a] for a in SH._axes(entry))
        total += n * (torch.empty((), dtype=spec.dtype).element_size() + 8)
    return total


def sharded_train_cell(r: dict, smi: str) -> None:
    """The qwen3-32b train_4k cell's gates: nothing the rules split over
    'model' computed replicated, the data-sharded gradients
    reduce-scattered, FLOPs a device within DRYRUN_FLOP_RATIO of the
    model's, arguments within 1% of the rule table's blocks (and the
    batch)."""
    cfg = get_config("qwen3-32b")
    want = shard_bytes(cfg, {"data": 16, "model": 16}) + 2 * 16 * 4096 * 8
    got = r["memory"]["argument_bytes"]
    ratio = r["hlo_flops_per_device"] / r["model_flops_per_device"]
    counts_ = r["collectives"]["counts"]
    if (r.get("replicated_over_model") != [] or not r.get("fsdp")
            or counts_.get("reduce-scatter", 0) < 1
            or ratio > DRYRUN_FLOP_RATIO or abs(got - want) > 0.01 * want):
        fail(f"dry run qwen3-32b train_4k: replicated over 'model' "
             f"{r.get('replicated_over_model')}, fsdp {r.get('fsdp')}, "
             f"collectives {counts_}, FLOPs {ratio:.3f}x the model's, "
             f"arguments {got} against the rule table's {want}")
    say(f"  dry run qwen3-32b train_4k [16x16], full depth, sharded step: "
        f"FLOPs a device {ratio:.4f}x the model's (the gathered step: "
        f"18.4x at 4 layers), arguments {got} bytes = the rule table's "
        f"blocks {want} ({got / want - 1:+.5f}), nothing replicated over "
        f"'model', {counts_.get('reduce-scatter', 0)} reduce-scatters "
        f"[{smi}]")


def split_train_cell(r: dict, most: float, smi: str) -> None:
    """A DRYRUN_OPTIONS train cell's gates: nothing the rules split over
    'model' computed replicated, FLOPs a device at most ``most`` times the
    model's."""
    ratio = r["hlo_flops_per_device"] / r["model_flops_per_device"]
    what = (f"dry run {r['arch']} {r['shape']} [{r['mesh']}] depths "
            f"{r.get('depths')}, hints {r.get('hints')}")
    if r.get("replicated_over_model") != [] or ratio > most:
        fail(f"{what}: replicated over 'model' "
             f"{r.get('replicated_over_model')}, FLOPs {ratio:.3f}x the "
             f"model's (at most {most})")
    say(f"  {what}, {r['microbatches']} microbatches: FLOPs a device "
        f"{ratio:.4f}x the model's (at most {most}), nothing replicated "
        f"over 'model', temporaries "
        f"{r['memory']['temp_bytes'] / 2 ** 30:.2f} GiB [{smi}]")


def device_run(fn):
    """(fn(), device ms, wall ms) of one call under torch.profiler (device
    activity only), the device time summed from the raw records as in
    ``profiled_serve``.  The dry run's processes load the host meanwhile,
    so the wall is taken under that load; the device time is not."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    busy_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results
                  .events() if e.device_type() == cuda)
    if busy_ns == 0:
        fail("torch.profiler recorded no device time for a mesh run")
    return out, busy_ns / 1e6, wall * 1e3


def mesh_serving(arch: str, mesh, smi: str, launches: dict) -> None:
    """``arch`` served at full width and depth, bf16, by Engine(mesh=None)
    and by Engine(mesh=mesh), both with per-slot decode: tokens, kernel
    launches and routes equal, every kernel of the path launched; each
    run's device time (profiler) beside its wall."""
    free()
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer(cfg, device="cuda", generator=gen)
    fresh = make_requests(cfg, MESH_REQUESTS, gen)
    runs = {}
    for name, m in (("mesh=None", None), ("host mesh", mesh)):
        eng = Engine(cfg, model, slots=4, max_len=MESH_MAX_LEN, mesh=m,
                     batch_decode=False)
        for r in fresh():
            eng.submit(r)
        reset_counts()
        done, dev, wall = device_run(eng.run)
        runs[name] = ({r.rid: list(r.out_tokens) for r in done}, counts(),
                      route_counts(), (dev, wall), eng.decode_calls)
        if m is not None:
            tally(launches)
        del eng
    (t0_, c0, r0, w0, d0), (t1, c1, r1, w1, d1) = runs.values()
    if t1 != t0_ or c1 != c0 or r1 != r0 or d1 != d0:
        fail(f"{arch} on the host mesh: tokens equal {t1 == t0_}, launches "
             f"{c1} vs {c0}, routes {r1} vs {r0}, decode calls {d1} vs {d0}")
    for name in ("tile_gemm", "decode_attention"):
        if not c1[name]:
            fail(f"{arch} on the host mesh: {name} never launched ({c1})")
    if not (c1["flash_attention"] or c1["stream_attention"]):
        fail(f"{arch} on the host mesh: no prefill attention kernel ({c1})")
    say(f"  {arch} served on the one-rank NCCL mesh: {sum(map(len, t1.values()))} "
        f"tokens equal to mesh=None's, launches {c1} equal, {d1} decode "
        f"calls; serving device {w1[0]:.1f} ms of {w1[1]:.1f} ms wall "
        f"(mesh=None: device {w0[0]:.1f} of {w0[1]:.1f}; device/mesh=None "
        f"{w1[0] / w0[0]:.4f}; walls under the dry run's host load) [{smi}]")
    del model
    free()


def mesh_training(mesh, smi: str, launches: dict) -> None:
    """MESH_TRAIN through loop.train, mesh=None then on the host mesh:
    losses, every parameter, launches and routes bitwise or exactly
    equal."""
    from repro_torch.train import loop as train_loop
    arch, cut, B, S, steps = MESH_TRAIN
    cfg = dataclasses.replace(get_config(arch), **cut)
    shape = ShapeConfig("mesh_train", S, B, "train")
    out = {}
    for name, m in (("mesh=None", None), ("host mesh", mesh)):
        free()
        hist = []
        tcfg = train_loop.TrainConfig(steps=steps, log_every=1,
                                      opt=TRAIN_OPT)
        reset_counts()
        res, dev, wall = device_run(lambda: train_loop.train(
            cfg, shape, SyntheticLM(cfg, shape, seed=0), tcfg, device="cuda",
            mesh=m, hooks={"on_log": hist.append}, gather_model=True))
        got, routes = counts(), route_counts()
        if m is not None:
            tally(launches)
        params = {k: p.detach().clone()
                  for k, p in res["model"].named_parameters()}
        out[name] = ([h["loss"] for h in hist], params, got, routes,
                     (dev, wall))
        del res
    (l0, p0, c0, r0, ms0), (l1, p1, c1, r1, ms1) = out.values()
    same = [k for k in p0 if torch.equal(p0[k], p1[k])]
    if l1 != l0 or len(same) != len(p0) or c1 != c0 or r1 != r0:
        fail(f"train {arch} on the host mesh: losses {l1} vs {l0}, "
             f"{len(same)} of {len(p0)} parameters bitwise equal, launches "
             f"{c1} vs {c0}, routes {r1} vs {r0}")
    if not (c1["tile_gemm"] and c1["flash_attention_bwd"]
            + c1["stream_attention_bwd"]):
        fail(f"train {arch} on the host mesh: kernels not launched ({c1})")
    say(f"  train {arch} ({cut}, {B} x {S}, {steps} steps) on the one-rank "
        f"NCCL mesh: losses {l1} and all {len(p0)} parameters bitwise equal "
        f"to mesh=None's, launches {c1} equal; train() device {ms1[0]:.1f} "
        f"ms of {ms1[1]:.1f} ms wall (mesh=None: device {ms0[0]:.1f} of "
        f"{ms0[1]:.1f}; device/mesh=None {ms1[0] / ms0[0]:.4f}; walls under "
        f"the dry run's host load, both with the model's build) [{smi}]")
    del out, p0, p1
    free()


# (b) One 'model' rank of the production mesh at full width: each of its
# 16 ranks in turn on the one card (parallel.rank_view: the rank's blocks,
# the sums over 'model' left to the caller, a context-parallel rank's rows
# among zeros), one layer's attention and MLP (or MoE) sublayers, forward
# and backward.  The ranks' outputs and input gradients summed (for
# context-parallel attention: its rows joined), the split weights'
# gradients joined and the replicated ones' summed (in f32), each against
# the whole sublayers on the kernel path, max |difference| / max |value|
# of each, compared a rank at a time: in f32 within GRAD_TOL; in bf16,
# where both sides round each product to bf16 in other places, each held
# to the f32 numbers of the same bf16 weights and inputs: the ranks' sum
# no farther from them than twice the whole bf16 layer is (or half a
# bf16 ulp of the largest value, 2**-9, where the whole is closer).  The
# MoE layers route in f32 from the same (bf16-valued) input, so the whole,
# the ranks and both dtypes route every token alike.
#  * qwen3-32b at 4096 tokens: 4 of 64 query heads over kv head r // 2,
#    d_ff 1600 of 25600; h2o-danube3-4b at 8192, past its 4096-key window:
#    2 of 32 query heads over kv head r // 2 (its 8 kv heads do not divide
#    over 16), d_ff 640 of 10240; both in LAYER_STREAM and (the planner's
#    rule forced) TILE_STREAM;
#  * starcoder2-7b at 4096 under the attn_q hint: its 36 heads do not
#    divide over 16, so each rank attends with query rows 256·r … 256·r +
#    255 against the whole K/V (context parallelism, contiguous as JAX's
#    hint makes it: rank 15 reads ~31x rank 0's live keys), d_ff 1152 of
#    18432; LAYER and forced TILE; rank 0's and rank 15's device ms;
#  * grok-1-314b at 1024: 3 of 48 query heads, expert-TP (8 experts do not
#    divide over 16): every expert on d_ff 2048 of 32768;
#  * deepseek-v3-671b, one MoE layer at 1024: MLA on 8 of 128 heads, 16 of
#    256 experts (EP), the shared expert's d_ff 128 of 2048.  Its whole
#    f32 layer does not fit the card (~45 GB of f32 experts and as much of
#    gradients): both gates run with the routed experts cut to 32 (2 a
#    rank) at the published widths; then the bf16 layer at all 256 holds
#    its ranks' sum to its whole within three times the cut bf16 whole's
#    distance from its f32 numbers, quantity by quantity (what the cut's
#    gate allows: the ranks within twice that distance of the f32
#    numbers, so within three times it of the whole).
# (arch, tokens, under the attn_q hint, config cut of the f32 check, modes)
MODEL_RANKS = (
    ("qwen3-32b", 4096, False, {}, ("layer_stream", "tile_stream")),
    ("h2o-danube3-4b", 8192, False, {}, ("layer_stream", "tile_stream")),
    ("starcoder2-7b", 4096, True, {}, ("layer_stream", "tile_stream")),
    ("grok-1-314b", 1024, False, {}, ("layer_stream",)),
    ("deepseek-v3-671b", 1024, False, {"num_experts": 32},
     ("layer_stream",)))
MODEL_AXIS = 16
RANK_FLOOR = 2.0 ** -9


@contextlib.contextmanager
def tile_stream_forced():
    """The planner's profitability rule held true, so that TILE_STREAM
    runs the stream kernel where it would resolve to flash."""
    from repro_torch.plan import heuristics
    rule = heuristics.tile_stream_profitable
    heuristics.tile_stream_profitable = lambda *a, **k: True
    try:
        yield
    finally:
        heuristics.tile_stream_profitable = rule


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in f32."""
    w = want.detach().float()
    return float((got.detach().float() - w).abs().max() / w.abs().max())


def sublayers(blk, cfg, h, tabs, mode):
    """The attention (MLA's for MLA) and the MLP (or MoE) of the
    pre-normed ``h``, summed."""
    from repro_torch.models.mla import mla_forward
    if cfg.attn_kind == AttnKind.MLA:
        y = mla_forward(blk.attn, cfg, h, sin=tabs[0], cos=tabs[1])
    else:
        y = model_layers.attention_forward(blk.attn, cfg, h, sin=tabs[0],
                                           cos=tabs[1], causal=True,
                                           mode=mode)
    if hasattr(blk, "moe"):
        return y + model_layers.moe_forward(blk.moe, cfg, h)
    return y + model_layers.mlp_forward(blk.mlp, h)


class RankGaps:
    """The ranks' sum against the whole, kept a rank at a time so that no
    rank's gradients outlive its turn: for each output (y, dh, then each
    gradient) the split ones' largest |difference| from the whole's block
    (and from the f32 numbers' block), the summed ones' running f32
    sums."""

    def __init__(self, names, whole, ref=None):
        self.names, self.whole, self.ref = names, whole, ref
        self.diff = [0.0] * len(whole)
        self.diff_ref = [0.0] * len(whole)
        self.whole_ref = [0.0] * len(whole)
        self.ref_max = [0.0] * len(whole)
        self.sums = [None] * len(whole)

    def add(self, r: int, got) -> None:
        for i, (g, w) in enumerate(zip(got, self.whole)):
            if g.shape == w.shape:                    # partial sums
                self.sums[i] = (g.float() if self.sums[i] is None
                                else self.sums[i] + g.float())
                continue
            d = next(j for j, (x, y) in enumerate(zip(g.shape, w.shape))
                     if x != y)
            n = g.shape[d]
            wb = w.narrow(d, r * n, n).float()
            self.diff[i] = max(self.diff[i],
                               float((g.float() - wb).abs().max()))
            if self.ref is not None:
                ref = self.ref[i].narrow(d, r * n, n).float()
                self.diff_ref[i] = max(self.diff_ref[i],
                                       float((g.float() - ref).abs().max()))
                self.whole_ref[i] = max(self.whole_ref[i],
                                        float((wb - ref).abs().max()))
                self.ref_max[i] = max(self.ref_max[i],
                                      float(ref.abs().max()))

    def gaps(self) -> dict:
        """{name: the ranks' gap to the whole}."""
        out = {}
        for i, n in enumerate(self.names):
            if self.sums[i] is not None:
                out[n] = _gap(self.sums[i], self.whole[i])
            else:
                out[n] = self.diff[i] / float(self.whole[i].float().abs()
                                              .max())
        return out

    def to_ref(self) -> dict:
        """{name: (the ranks' gap to the f32 numbers, the whole's)}."""
        out = {}
        for i, n in enumerate(self.names):
            if self.sums[i] is not None:
                out[n] = (_gap(self.sums[i], self.ref[i]),
                          _gap(self.whole[i], self.ref[i]))
            else:
                top = self.ref_max[i]
                out[n] = (self.diff_ref[i] / top, self.whole_ref[i] / top)
        return out


def rank_sums(blk, prefix, cfg, fwd, inputs: dict, dy, names, want_n,
                 what, ref=None, exchange: bool = False):
    """The whole ``fwd()`` of ``blk`` and its MODEL_AXIS ranks
    (``rank_view`` with JAX path head ``prefix``), forward and backward,
    compared a rank at a time (``RankGaps``: y, the gradient of each of
    ``inputs`` ({name: tensor}) and of each of ``names``; ``ref``: the f32
    numbers of the whole).  With ``exchange``, the ranks run in passes
    of a ``parallel.Exchange`` until it holds, the last compared.  Every
    call's launches must be ``want_n``.  Returns the gaps, the whole's
    results, the passes and rank 0's routes (of its last pass)."""
    from repro_torch.distributed import parallel as PL
    params = dict(blk.named_parameters())
    xs = list(inputs.values())

    def run(ps):
        y = fwd()
        return [y.detach(), *(g.detach() for g in torch.autograd.grad(
            y, xs + ps, dy))]

    reset_counts()
    whole = run([params[n] for n in names])
    if counts() != want_n:
        fail(f"{what}: the whole layer launched {counts()}")
    ex = PL.Exchange() if exchange else None
    passes = ex or PL.Exchange()          # no exchange: one pass
    while passes.another_pass():
        gaps = RankGaps(["y", *inputs, *names], whole, ref)
        for r in range(MODEL_AXIS):
            with PL.rank_view(blk, prefix, cfg, r, MODEL_AXIS,
                              exchange=ex) as t:
                reset_counts()
                got = run([t[n] for n in names])
                if counts() != want_n:
                    fail(f"{what}: rank {r} launched {counts()}")
            gaps.add(r, got)
            if r == 0:
                routes = {k: {rt: n for rt, n in v.items() if n}
                          for k, v in route_counts().items()
                          if any(v.values())}
            del got
    return gaps, whole, passes.passes, routes


def rank_ms(blk, prefix, cfg, fwd, inputs, dy, names, ranks) -> tuple:
    """(device ms of the whole ``fwd()`` forward + backward, [the same of
    each of ``ranks``]): ``device_ms``, the profiler's mean of each kernel
    over 3 calls, which a dropped event does not move (one profiled call
    lost a third of a call's kernels now and then).  A rank runs with an
    empty exchange: the other ranks' columns and sums are zeros, the
    kernels' shapes the same."""
    from repro_torch.distributed import parallel as PL
    params = dict(blk.named_parameters())

    def run(ps):
        torch.autograd.grad(fwd(), list(inputs) + ps, dy)

    whole = device_ms(lambda: run([params[n] for n in names]), reps=3)[0]
    out = []
    for r in ranks:
        with PL.rank_view(blk, prefix, cfg, r, MODEL_AXIS,
                          exchange=PL.Exchange()) as t:
            out.append(device_ms(lambda: run([t[n] for n in names]),
                                 reps=3)[0])
    return whole, out


def rank_gate(what: str, dt: torch.dtype, gaps: RankGaps, cut_note: str = ""
              ) -> tuple:
    """The gates of phase 23 (b)'s comment on one dtype's ranks: in f32
    the ranks' sum within GRAD_TOL of the whole; in bf16 no farther from
    the f32 numbers than twice the whole is (or RANK_FLOOR).  Returns
    (the gaps, the worst one's name, the gate's text, the f32 distances
    of bf16 or None)."""
    g = gaps.gaps()
    worst = max(g, key=g.get)
    if dt == torch.float32:
        if g[worst] > GRAD_TOL:
            fail(f"{what}: the ranks' sum is {g[worst]:.3g} from the whole "
                 f"at {worst} ({g})")
        return g, worst, f"f32 within {GRAD_TOL}{cut_note}", None
    to32 = gaps.to_ref()
    bad = {n: v for n, v in to32.items() if v[0] > max(2 * v[1], RANK_FLOOR)}
    if bad:
        fail(f"{what}: the ranks' sum farther from the f32 numbers than "
             f"twice the whole (ranks, whole): {bad}")
    far = max(to32, key=lambda n: to32[n][0])
    return g, worst, (f"from the f32 numbers at most {to32[far][0]:.3g} "
                      f"({far}; the whole {to32[far][1]:.3g}){cut_note}"), \
        to32


def layer_shapes(cfg, hinted: bool) -> str:
    """What a rank of ``cfg``'s layer computes on, for the log."""
    m = MODEL_AXIS
    if cfg.attn_kind == AttnKind.MLA:
        attn = f"MLA on {cfg.num_heads // m} of {cfg.num_heads} heads"
    elif hinted:
        attn = (f"all {cfg.num_heads} heads on query rows r·S/{m} … "
                f"(r+1)·S/{m} - 1 against the whole K/V")
    else:
        attn = f"{cfg.num_heads // m} of {cfg.num_heads} query heads"
    if cfg.family == Family.MOE:
        E, f = cfg.num_experts, cfg.moe_d_ff
        ffn = (f"{E // m} of {E} experts" if E % m == 0 else
               f"all {E} experts on d_ff {f // m} of {f}")
        if cfg.num_shared_experts:
            sf = f * cfg.num_shared_experts
            ffn += f", the shared expert's d_ff {sf // m} of {sf}"
    else:
        ffn = f"d_ff {cfg.d_ff // m} of {cfg.d_ff}"
    return f"{attn}, {ffn}"


def model_ranks(smi: str) -> None:
    """Phase 23 (b): MODEL_RANKS in f32 and bf16 on the same (bf16-valued)
    weights and inputs, each rank's launches exact (tile_gemm 3 a SwiGLU
    MLP or shared expert, 2 a GELU one, none for grok-1's MoE; the mode's
    attention kernel and its backward once), the gates of the comment
    above, and in bf16 (the training dtype) rank 0's device ms (and rank
    15's for context parallelism) against the whole's over 16."""
    from repro_torch.distributed import parallel as PL
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.hints import hint_shardings
    from repro_torch.models.transformer import Block
    table = hint_shardings(["attn_q", "attn_out"], SH._SimulatedMesh(
        {"data": 16, "model": MODEL_AXIS}))
    for arch, S, hinted, cut, modes in MODEL_RANKS:
        t_arch = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=1)
        moe = cfg.family == Family.MOE
        if hinted and not PL.context_split(cfg, MODEL_AXIS, table):
            fail(f"{arch}: the attn_q hint does not make its attention "
                 f"context-parallel")
        hd = cfg.qk_rope_head_dim if cfg.attn_kind == AttnKind.MLA else None
        tabs = model_layers.rope_tables_for(cfg, S, head_dim=hd,
                                            device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(28)
        blk16 = Block(cfg, gen, moe=moe).requires_grad_(True)
        h16 = randn(gen, 1, S, cfg.d_model, dtype=torch.bfloat16)
        dy16 = randn(gen, 1, S, cfg.d_model, dtype=torch.bfloat16)
        mlp = cfg.num_shared_experts if moe else 1
        n_gemm = (3 if cfg.act == "silu" else 2) if mlp else 0
        for mname in modes:
            mode = ExecutionMode(mname)
            attn = ("stream_attention" if mode == ExecutionMode.TILE_STREAM
                    and cfg.attn_kind != AttnKind.MLA else "flash_attention")
            want_n = {k: 0 for k in KERNELS}
            want_n.update({"tile_gemm": n_gemm, attn: 1, f"{attn}_bwd": 1})
            forced = (tile_stream_forced() if mode == ExecutionMode.TILE_STREAM
                      else contextlib.nullcontext())
            hints = runtime.flags(sharding_hints=table if hinted else None)
            runs = [(torch.float32, cut), (torch.bfloat16, cut)]
            if cut:
                runs.append((torch.bfloat16, {}))
            with forced, hints:
                ref32 = bound = None
                for dt, ccut in runs:
                    dname = str(dt).split(".")[-1]
                    c = dataclasses.replace(cfg, dtype=dname,
                                            param_dtype=dname, **ccut)
                    what = (f"{arch} {dname} {mode.value}, {MODEL_AXIS} "
                            f"'model' ranks")
                    if ccut:               # the cut layer's own draw
                        blk = copy_block(Block(dataclasses.replace(
                            cfg, **ccut), torch.Generator(device="cuda")
                            .manual_seed(28), moe=moe), dt)
                    elif dt == torch.bfloat16:
                        blk = blk16
                    else:
                        blk = copy_block(blk16, dt)
                    names = [n for n, _ in blk.named_parameters()
                             if not n.startswith("norm")]
                    h = h16.to(dt).requires_grad_(True)
                    gaps, whole, _, _ = rank_sums(
                        blk, "layers", c,
                        lambda: sublayers(blk, c, h, tabs, mode), {"dh": h},
                        dy16.to(dt), names, want_n, what,
                        ref=None if dt == torch.float32 else ref32)
                    cut_note = f" (cut to {ccut})" if ccut else ""
                    if dt == torch.float32 or ref32 is not None:
                        g, worst, gate, to32 = rank_gate(what, dt, gaps,
                                                         cut_note)
                        if to32 is None:
                            ref32 = whole
                        else:
                            # what this gate allows the ranks' distance to
                            # the whole: the full layer's bound
                            bound = {n: max(3 * v[1], RANK_FLOOR)
                                     for n, v in to32.items()}
                            ref32 = None
                    else:                  # the full layer after its cut
                        g = gaps.gaps()
                        worst = max(g, key=g.get)
                        bad = {n: (v, bound[n]) for n, v in g.items()
                               if v > bound[n]}
                        if bad:
                            fail(f"{what}: the ranks' sum farther from the "
                                 f"whole than three times the cut layer's "
                                 f"whole is from its f32 numbers (ranks, "
                                 f"bound): {bad}")
                        close = max(g, key=lambda n: g[n] / bound[n])
                        gate = (f"within three times the cut layer's "
                                f"whole-to-f32 gap ({close}: {g[close]:.3g} "
                                f"of {bound[close]:.3g})")
                    del gaps, whole
                    free()
                    timing = ""
                    if (dt, ccut) == runs[-1]:
                        ranks = (0, MODEL_AXIS - 1) if hinted else (0,)
                        ms_whole, ms_ranks = rank_ms(
                            blk, "layers", c,
                            lambda: sublayers(blk, c, h, tabs, mode), [h],
                            dy16, names, ranks)
                        each = ", ".join(f"rank {r} {ms:.3f}" for r, ms
                                         in zip(ranks, ms_ranks))
                        timing = (
                            f"; device ms forward + backward (mean of 3 "
                            f"calls): {each}, the whole {ms_whole:.3f} "
                            f"(/{MODEL_AXIS} = {ms_whole / MODEL_AXIS:.3f}; "
                            f"rank 0 / (whole / {MODEL_AXIS}) "
                            f"{ms_ranks[0] * MODEL_AXIS / ms_whole:.3f})")
                    say(f"  {what} ({S} tokens; {layer_shapes(c, hinted)}"
                        f"): the ranks' sum {g[worst]:.3g} from the whole "
                        f"({worst}; y {g['y']:.3g}, dh {g['dh']:.3g}), "
                        f"{gate}; each rank {n_gemm} tile_gemm, 1 {attn}, 1 "
                        f"{attn}_bwd{timing} [{smi}]")
                    del blk, h
                    free()
        del blk16, h16, dy16
        free()
        say(f"    {arch} took {time.perf_counter() - t_arch:.1f} s")


# (b), the families split over 'model' since the SSM projections, each
# row's 16 ranks in turn as MODEL_RANKS' (f32 within GRAD_TOL, bf16 to
# its rule), on the row's own sublayers of pre-normed inputs:
#  * mamba2-780m's SSM mixer at 1·4096: 3 of 48 heads a rank (in_proj's
#    403 of 6448 fused columns gathered by gather_cols, out_proj's 192 of
#    3072 rows), ssd_scan and ssd_scan_bwd on the rank's heads; the
#    gather and the gated norm's sum over 'model' run through an
#    Exchange, 5 passes of the 16 ranks;
#  * vilbert-large's co-TRM block at its N = 4096 (both streams, B = 1):
#    co-attention, self-attention and the MLP of each stream, 1 of 16
#    heads a stream (in TILE_STREAM the stream kernel generates the
#    rank's head's K/V from the other modality), d_ff 256 of 4096;
#  * whisper-base's decoder layer at train_4k's 4096 tokens over its 1500
#    encoder frames under the attn_q hint, and an encoder layer's
#    self-attention and MLP on those frames: its 8 heads do not divide
#    16, so the causal self-attention and the cross-attention run
#    context-parallel on 256 query rows a rank (the encoder states enter
#    whole), the encoder's self-attention on 94 of the 1500 frames a rank
#    (16 does not divide 1500: the last blocks end at frame 1500 and
#    repeat rows of the block before), d_ff 128 of 2048.
# (row, arch, tokens, modes)
FAMILY_RANKS = (
    ("mamba2-780m SSM mixer", "mamba2-780m", 4096, ("tile_stream",)),
    ("vilbert-large co-TRM block", "vilbert-large", 4096,
     ("tile_stream", "layer_stream")),
    ("whisper-base encoder + decoder layer, attn_q", "whisper-base", 4096,
     ("tile_stream", "layer_stream")))


def family_row(arch: str, S: int, gen):
    """(module, its JAX path head, what the ranks compute on, a
    fwd(module, cfg, inputs, mode) of its sublayers summed, {name:
    input shape}, the parameters the sublayers read, Exchange or not)
    of a FAMILY_RANKS row, its weights drawn in bf16 from ``gen``."""
    from repro_torch.models import vilbert as V
    from repro_torch.models.ssm import ssm_forward
    cfg = get_config(arch)
    if arch == "mamba2-780m":
        blk = SSM(cfg, gen)
        _, d_inner, H, P = ssm_dims(cfg)
        m = MODEL_AXIS
        what = (f"{H // m} of {H} heads, in_proj {blk.in_proj.shape[1] // m}"
                f" of {blk.in_proj.shape[1]} columns, out_proj "
                f"{d_inner // m} of {d_inner} rows")
        return (blk, "layers/ssm", what,
                lambda b, c, i, mode: ssm_forward(b, c, i["dh"]),
                {"dh": (1, S, cfg.d_model)},
                [n for n, _ in blk.named_parameters()], True)
    if arch == "vilbert-large":
        c1 = dataclasses.replace(cfg, num_layers=1, num_coattn_layers=1)
        model = ViLBERT(c1, device="cuda", generator=gen)
        names = [n for n, _ in model.named_parameters()
                 if n.startswith(("co_x.0.", "co_y.0."))
                 and ".ln_" not in n]

        def fwd(b, c, i, mode):
            px, py = b.co_x[0], b.co_y[0]
            x, y = i["d_vision"], i["d_text"]
            yx = (V._attn(px.co_attn, c, x, y, mode)
                  + V._attn(px.self_attn, c, x, x, mode)
                  + model_layers.mlp_forward(px.mlp, x))
            yy = (V._attn(py.co_attn, c, y, x, mode)
                  + V._attn(py.self_attn, c, y, y, mode)
                  + model_layers.mlp_forward(py.mlp, y))
            return torch.cat([yx.reshape(-1), yy.reshape(-1)])
        what = (f"{cfg.num_heads // MODEL_AXIS} of {cfg.num_heads} heads a "
                f"stream, d_ff {cfg.d_ff // MODEL_AXIS} of {cfg.d_ff}")
        return (model, None, what, fwd,
                {"d_vision": (1, S, cfg.d_model),
                 "d_text": (1, S, cfg.d_model_y)}, names, False)
    c1 = dataclasses.replace(cfg, num_layers=1, num_encoder_layers=1)
    model = EncDec(c1, device="cuda", generator=gen)
    names = [f"{side}.0.{n}" for side in ("enc_layers", "dec_layers")
             for n, _ in getattr(model, side)[0].named_parameters()
             if not n.startswith("ln")]

    def fwd(b, c, i, mode):
        p, pe = b.dec_layers[0], b.enc_layers[0]
        h, enc = i["dh"], i["d_enc"]
        yd = (model_layers.attention_forward(p.self_attn, c, h, causal=True,
                                             mode=mode)
              + model_layers.attention_forward(p.cross_attn, c, h,
                                               x_kv=enc, causal=False,
                                               mode=mode)
              + model_layers.mlp_forward(p.mlp, h))
        ye = (model_layers.attention_forward(pe.attn, c, enc, causal=False,
                                             mode=mode)
              + model_layers.mlp_forward(pe.mlp, enc))
        return torch.cat([yd.reshape(-1), ye.reshape(-1)])
    fr = cfg.encoder_seq
    what = (f"all {cfg.num_heads} heads on query rows r·{S // MODEL_AXIS} "
            f"… against the whole K/V ({S} causal, {fr} encoder frames), the "
            f"encoder's on {-(-fr // MODEL_AXIS)} of its {fr} frames a rank, "
            f"d_ff {cfg.d_ff // MODEL_AXIS} of {cfg.d_ff}")
    return (model, None, what, fwd,
            {"dh": (1, S, cfg.d_model),
             "d_enc": (1, cfg.encoder_seq, cfg.d_model)}, names, False)


def family_want(arch: str, mode: ExecutionMode) -> dict:
    """A FAMILY_RANKS row's launches a call (forward + backward), the
    whole's and each rank's alike: the SSD scan and its backward once;
    vilbert's four attention sublayers and whisper's three on the mode's
    kernel and its backward, their GELU MLPs' two projections each."""
    want = {k: 0 for k in KERNELS}
    if arch == "mamba2-780m":
        want.update(ssd_scan=1, ssd_scan_bwd=1)
        return want
    attn = ("stream_attention" if mode == ExecutionMode.TILE_STREAM
            else "flash_attention")
    n_attn, n_mlp = (4, 2) if arch == "vilbert-large" else (3, 2)
    want.update({attn: n_attn, f"{attn}_bwd": n_attn, "tile_gemm": 2 * n_mlp})
    return want


def family_ranks(smi: str) -> None:
    """Phase 23 (b), FAMILY_RANKS: each row in f32 and bf16 on the same
    (bf16-valued) weights and inputs, each rank's launches exact
    (``family_want``), the gates of ``rank_gate``, rank 0's kernel
    routes, and in bf16 rank 0's device ms (and rank 15's for whisper's
    context parallelism) against the whole's over 16."""
    from repro_torch.distributed import parallel as PL
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.hints import hint_shardings
    table = hint_shardings(["attn_q", "attn_out"], SH._SimulatedMesh(
        {"data": 16, "model": MODEL_AXIS}))
    for row, arch, S, modes in FAMILY_RANKS:
        t_row = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(30)
        mod16, prefix, shapes, fwd, ins, names, exchange = family_row(
            arch, S, gen)
        mod16.requires_grad_(True)
        x16 = {k: randn(gen, *v, dtype=torch.bfloat16)
               for k, v in ins.items()}
        hinted = arch == "whisper-base"
        cfg = get_config(arch)
        if hinted and not PL.context_split(cfg, MODEL_AXIS, table):
            fail(f"{row}: the attn_q hint does not make its attention "
                 f"context-parallel")
        for mname in modes:
            mode = ExecutionMode(mname)
            want_n = family_want(arch, mode)
            hints = runtime.flags(sharding_hints=table if hinted else None)
            ref32 = None
            with hints:
                for dt in (torch.float32, torch.bfloat16):
                    dname = str(dt).split(".")[-1]
                    c = dataclasses.replace(cfg, dtype=dname,
                                            param_dtype=dname)
                    mod = mod16 if dt == torch.bfloat16 else copy_block(
                        mod16, dt)
                    xs = {k: v.to(dt).requires_grad_(True)
                          for k, v in x16.items()}
                    y_shape = fwd(mod, c, xs, mode).shape
                    dy = randn(torch.Generator(device="cuda").manual_seed(31),
                               *y_shape, dtype=dt)
                    what = (f"{row} {dname}"
                            + ("" if arch == "mamba2-780m"
                               else f" {mode.value}")
                            + f", {MODEL_AXIS} 'model' ranks")
                    gaps, whole, passes, routes = rank_sums(
                        mod, prefix, c, lambda: fwd(mod, c, xs, mode), xs,
                        dy, names, want_n, what, ref32, exchange)
                    g, worst, gate, _ = rank_gate(what, dt, gaps)
                    ref32 = whole if dt == torch.float32 else None
                    del gaps
                    timing = ""
                    if dt == torch.bfloat16:
                        ranks = (0, MODEL_AXIS - 1) if hinted else (0,)
                        ms_whole, ms_ranks = rank_ms(
                            mod, prefix, c, lambda: fwd(mod, c, xs, mode),
                            list(xs.values()), dy, names, ranks)
                        each = ", ".join(f"rank {r} {ms:.3f}" for r, ms
                                         in zip(ranks, ms_ranks))
                        timing = (
                            f"; device ms forward + backward (mean of 3 "
                            f"calls): {each}, the whole {ms_whole:.3f} "
                            f"(/{MODEL_AXIS} = {ms_whole / MODEL_AXIS:.3f}; "
                            f"rank 0 / (whole / {MODEL_AXIS}) "
                            f"{ms_ranks[0] * MODEL_AXIS / ms_whole:.3f})")
                    launched = {k: n for k, n in want_n.items() if n}
                    say(f"  {what} ({S} tokens; {shapes}; {passes} "
                        f"pass{'es' if passes > 1 else ''}): the ranks' sum "
                        f"{g[worst]:.3g} from the whole ({worst}; y "
                        f"{g['y']:.3g}), {gate}; each rank {launched}, "
                        f"rank 0's routes {routes}{timing} [{smi}]")
                    del whole, xs, mod, dy
                    free()
        del mod16, x16
        free()
        say(f"    {row} took {time.perf_counter() - t_row:.1f} s")


def copy_block(blk, dt: torch.dtype):
    """A copy of ``blk`` in ``dt``, its parameters requiring grad."""
    import copy
    out = copy.deepcopy(blk).to(dt)
    return out.requires_grad_(True)


def mesh_primitives(smi: str) -> None:
    """cross_pod_mean_int8 and gather_matmul_overlapped at world 1 on the
    card, against their single-device meaning; the int8 quantizer on the
    card against the CPU bitwise."""
    import repro_torch.distributed.compression as C
    from repro_torch.core.pipeline import gather_matmul_overlapped
    from repro_torch.launch.mesh import make_mesh
    gen = torch.Generator(device="cuda").manual_seed(23)
    grads = {"w": randn(gen, 4096, 4096, scale=0.02),
             "b": randn(gen, 4096, scale=0.02)}
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
    if C.cross_pod_mean_int8(grads, mesh3) is not grads:
        fail("cross_pod_mean_int8 at one pod did not return its input")
    for name, g in grads.items():
        q, sc = C._quantize(g)
        qc, scc = C._quantize(g.cpu())
        if not (torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc)):
            fail(f"int8 quantization of {name} on the card differs from "
                 f"the CPU's")
        # half a step of the int8 grid, and the f32 rounding of the
        # difference (a tie at k + 0.5 lands on the half step)
        err = (C._dequantize(q, sc) - g).abs().max()
        if float(err) > float(sc) / 2 + float(g.abs().max()) * 2 ** -22:
            fail(f"int8 round trip of {name}: {float(err)} > half a step")
    x = randn(gen, 2048, 5120, dtype=torch.bfloat16)
    w = randn(gen, 5120, 5120, dtype=torch.bfloat16, scale=5120 ** -0.5)
    mesh_m = make_mesh((1,), ("model",))
    before = tile_gemm.launches
    y = gather_matmul_overlapped(x, w, mesh_m)
    n = tile_gemm.launches - before
    if n != 1 or not torch.equal(y, tile_gemm(x, w)):
        fail(f"gather_matmul_overlapped at world 1: {n} tile_gemm launches "
             f"or a product that differs from tile_gemm's")
    say(f"  cross_pod_mean_int8 at one pod: the gradients as they are; int8 "
        f"quantization on the card bitwise equal to the CPU's; "
        f"gather_matmul_overlapped (2048 x 5120 x 5120, bf16) at world 1: "
        f"one tile_gemm launch, bitwise equal to tile_gemm [{smi}]")


def cost_cycles(smi: str) -> None:
    """cost_analysis_cycles of one recorded op (a tile_gemm at
    vilbert-base's MLP up-projection) beside its recorded time."""
    from repro_torch.sim.replay import cost_analysis_cycles
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = randn(gen, 8192, 768, dtype=torch.bfloat16)
    w = randn(gen, 768, 3072, dtype=torch.bfloat16, scale=768 ** -0.5)
    rec = KernelRecorder(iters=5, warmup=2)
    with recording(rec):
        tile_gemm(x, w)
    tr = rec.records[-1]
    cycles, flops = cost_analysis_cycles(ref.ref_tile_gemm, x, w)
    if flops != tr.flops or cycles < 1:
        fail(f"cost_analysis_cycles: {flops} FLOPs, the record {tr.flops}")
    say(f"  cost_analysis_cycles of tile_gemm (8192 x 768 x 3072, its plain "
        f"version's FLOPs): {cycles} cycles of streamdcim-base, {flops} "
        f"FLOPs; recorded on the card {tr.wall_time_s * 1e3:.4f} ms "
        f"({tr.cycles} cycles at {tr.clock_hz:.0e} Hz, {tr.source}) [{smi}]")


def multi_gpu(smi: str, launches: dict) -> None:
    """Phase 23: the dry run's cells start on the host, then (a) the mesh
    paths on the one-rank NCCL host mesh, (b) the 16 'model' ranks of a
    layer in turn on the card, (d) cost_analysis_cycles, and (c) the dry
    run's results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    out_dir = ROOT / "build" / "dryrun"
    procs = start_dryrun(out_dir)
    mesh = make_host_mesh()
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        fail(f"make_host_mesh on the card: backend {dist.get_backend()}, "
             f"device {mesh.device_type}")
    say(f"  host mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
        f"{mesh.device_type}, backend {dist.get_backend()}")
    for arch in MESH_ARCHS:
        t0 = time.perf_counter()
        mesh_serving(arch, mesh, smi, launches)
        say(f"    {arch} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_training(mesh, smi, launches)
    say(f"    training took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model_ranks(smi)
    family_ranks(smi)
    say(f"    the 16 'model' ranks took {time.perf_counter() - t0:.1f} s")
    mesh_primitives(smi)
    cost_cycles(smi)
    t0 = time.perf_counter()
    collect_dryrun(procs, out_dir, smi)
    say(f"    waited {time.perf_counter() - t0:.1f} s for the dry run")
    dist.destroy_process_group()


def tensor_core_sass() -> str:
    """How many HGMMA (wgmma) instructions the SASS of each attention
    library (forward and backward) holds, from the toolkit's cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "cuobjdump not in the toolkit: SASS not read"
    found = []
    for name in ("flash_attention", "stream_attention",
                 "flash_attention_bwd", "stream_attention_bwd"):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True,
                              timeout=300).stdout
        found.append(f"{name} {sass.count('HGMMA')} HGMMA")
    return ", ".join(found)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA card")
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    say("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    say("== phase 2: build")
    say(f"built {', '.join(_build.SOURCES)} in {_build.build_all():.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")
    say(f"  tensor-core instructions: {tensor_core_sass()}")
    G, Sq = 1, MAIN_STREAM[TIMED["stream_attention"]][2]
    rows, cluster, resident = stream_config(G, Sq)
    say(f"  stream_attention bf16: {rows} query rows per block; at "
        f"{TIMED['stream_attention']} clusters of {cluster} blocks, "
        f"{resident} such clusters resident at once "
        f"(cudaOccupancyMaxActiveClusters, hd 128), K/V regeneration "
        f"x{regeneration(G, Sq)}")

    rows, cluster, dq_res, dkv_res = flash_vjp.stream_config(G, Sq)
    C = blocked.stream_bwd_cluster(8, 128)
    say(f"  stream_attention_bwd tc: dQ kernel {rows} query rows per block, "
        f"clusters of {cluster} at {TIMED['stream_attention']}, {dq_res} "
        f"such clusters resident at once, K/V regeneration "
        f"x{flash_vjp.regeneration(G, Sq)} (simt x{-(-G * Sq // 64)}); "
        f"dK/dV kernel in clusters of {C} over the kv heads, {dkv_res} "
        f"resident at once (hd 128), dW slots {blocked.stream_bwd_slots('tc', 2, Sq, 8, 128)[0]} "
        f"of 2 x {Sq} keys")

    say("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    check_flash(gen, report)
    check_stream(gen, report)
    check_gemm(gen, report)
    check_decode(gen, report)
    check_ssd(gen, report)
    check_bwd_rules()
    check_flash_bwd(gen, report)
    check_stream_bwd(gen, report)
    check_ssd_bwd(gen, report)
    check_flash_bwd_wide(gen, report)

    say("== phase 4: main path, vilbert-base")
    launches = {name: 0 for name in KERNELS}
    for name, fn in ROUTED.items():
        launches[f"{name} routes"] = dict.fromkeys(fn.routes, 0)
    main_path(launches, smi)
    free()

    say("== phase 5: main path, qwen3-32b served (paged KV, batched decode)")
    dense_serving("qwen3-32b", SERVE_REQUESTS, 2048, smi, launches)
    free()

    say("== phase 6: serving checks in f32, qwen3-32b widths, 2 layers")
    serving_checks(smi)
    free()

    say("== phase 7: main path, mamba2-780m served (SSM, per-slot decode)")
    ssm_serving("mamba2-780m", MAMBA2_REQUESTS, smi, launches)
    free()

    say("== phase 8: main path, hymba-1.5b served (hybrid, ring cache)")
    ssm_serving("hymba-1.5b", HYMBA_REQUESTS, smi, launches)
    free()

    say("== phase 9: SSM and hybrid checks in f32, full widths, 2 layers")
    ssm_checks(smi)
    say(f"phases 1-9 took {time.perf_counter() - start:.1f} s")
    free()

    say("== phase 10: training, vilbert-base and qwen3-32b (4 layers), bf16")
    training(smi, launches)
    free()

    say("== phase 11: training checks in f32: kernel against plain "
        "gradients, modes against each other")
    training_checks(smi)
    say(f"phases 1-11 took {time.perf_counter() - start:.1f} s")
    free()

    say("== phase 12: vilbert-large, the paper's second model, bf16")
    main_path(launches, smi, "vilbert-large", EXPECTED_COUNTS_LARGE,
              {"num_layers": 2, "num_coattn_layers": 1})
    free()

    say("== phase 13: whisper-base (encoder-decoder), bf16, then f32 checks")
    whisper_path(smi, launches)
    whisper_checks(smi)
    free()

    say("== phase 14: qwen2-vl-2b (M-RoPE): forward, Engine serving, f32 "
        "checks")
    qwen2vl_forward(smi, launches)
    dense_serving("qwen2-vl-2b", QWEN2VL_REQUESTS, QWEN2VL_MAX_LEN, smi,
                  launches)
    free()
    serving_checks(smi, "qwen2-vl-2b", modes=False)
    say(f"phases 1-14 took {time.perf_counter() - start:.1f} s")
    free()

    say("== phase 15: grok-1-314b (MoE, 4 of 64 layers): forward, Engine "
        "serving, f32 checks")
    moe_path("grok-1-314b", smi, launches)
    moe_checks("grok-1-314b", smi)

    say("== phase 16: deepseek-v3-671b (MLA + MoE, 3 dense + 2 MoE "
        "layers): forward, Engine serving, f32 checks")
    moe_path("deepseek-v3-671b", smi, launches)
    moe_checks("deepseek-v3-671b", smi)
    say(f"phases 1-16 took {time.perf_counter() - start:.1f} s")

    say("== phase 17: minitron-4b, starcoder2-7b and h2o-danube3-4b at full "
        "width and depth: forward, Engine serving, f32 checks")
    for arch in DENSE3:
        t0 = time.perf_counter()
        dense3_path(arch, smi, launches)
        dense3_checks(arch, smi)
        say(f"  {arch} took {time.perf_counter() - t0:.1f} s")
    say(f"phases 1-17 took {time.perf_counter() - start:.1f} s")

    say("== phase 18: record/replay: vilbert-base's plan ops timed on the "
        "card, replayed through the simulator, calibration fitted")
    t0 = time.perf_counter()
    replay_phase(smi, report)
    say(f"  phase 18 took {time.perf_counter() - t0:.1f} s")
    say(f"phases 1-18 took {time.perf_counter() - start:.1f} s")
    free()

    say("== phase 19: training of the other families at full width, bf16 "
        "(SSM, hybrid, VLM, encoder-decoder, MLA; MoE forward + backward)")
    t0 = time.perf_counter()
    family_training(smi, launches)
    say(f"  phase 19 took {time.perf_counter() - t0:.1f} s")

    say("== phase 20: their training checks in f32 at 1-2 layers: kernel "
        "against plain gradients, modes against each other")
    t0 = time.perf_counter()
    training_checks(smi, FAMILY_CHECKS)
    say(f"  phase 20 took {time.perf_counter() - t0:.1f} s")
    say(f"phases 1-20 took {time.perf_counter() - start:.1f} s")
    free()

    say("== phase 21: the rest of single-card inference: launch.serve at "
        "starcoder2-7b's full width, the int8 projection, quantized "
        "forwards and serving, the examples and the obs CLI")
    rest_of_inference(smi, launches, report)
    say(f"phases 1-21 took {time.perf_counter() - start:.1f} s")
    free()

    say("== phase 22: training of vilbert-large, minitron-4b (16 of 32 "
        "layers), starcoder2-7b (24 of 32 layers) and h2o-danube3-4b (12 of "
        "24 layers, S = 8192, past its window) at full width, bf16; then "
        "f32 checks at 2 layers")
    t0 = time.perf_counter()
    last_training(smi, launches)
    say(f"  phase 22 took {time.perf_counter() - t0:.1f} s")
    say(f"phases 1-22 took {time.perf_counter() - start:.1f} s")

    say("== phase 23: multi-GPU on torch.distributed: the one-rank NCCL "
        "mesh (Engine, the sharded train step, int8 cross-pod mean, ring "
        "matmul), a layer's 16 'model' ranks in turn on the card, "
        "cost_analysis_cycles, the dry run on fake 256/512-rank worlds")
    t0 = time.perf_counter()
    multi_gpu(smi, launches)
    say(f"  phase 23 took {time.perf_counter() - t0:.1f} s")
    say(f"phases 1-23 took {time.perf_counter() - start:.1f} s")

    rows, gemm_shapes = [], report["tile_gemm"]["shapes"]
    for name in ROUTED:
        say(f"  {name} routes over the main paths: {launches[name + ' routes']}")
    for s in gemm_shapes:
        say(f"  tile_gemm {s['name']} {tuple(s['shape'])}: {s['route']} "
            f"{s['ms']:.4f} ms, parent {s['parent_ms']:.4f} ms, matmul "
            f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
            f"({s['bound_by']})")
    for name in BWD:
        for s in report[name]["shapes"]:
            extra = "".join(f", {k} {v}" for k, v in s.items()
                            if k in ("dw_scratch_bytes", "regeneration"))
            say(f"  {name} {s['name']}: tc {s['ms']:.3f} ms (device "
                f"{s['device_ms']:.3f}), simt {s['parent_ms']:.3f} ms (device "
                f"{s['parent_device_ms']:.3f}){extra}")
    for s in report["flash_attention"]["shapes"]:
        say(f"  flash_attention {s['name']}: kernel {s['ms']:.4f} ms "
            f"(device {s['device_ms']:.4f}), plain {s['plain_ms']:.3f} ms, "
            f"SDPA {s['library_ms']:.3f} ms (device "
            f"{s['library_device_ms']:.3f}, {s['library_backends']}), "
            f"matmul-softmax-matmul {s['chain_ms']:.3f} ms, bound "
            f"{s['bound_ms']:.4f} ms ({s['bound_by']})")
    for s in report["stream_attention"]["shapes"]:
        say(f"  stream_attention {s['name']}: kernel {s['ms']:.4f} ms "
            f"(device {s['device_ms']:.4f}), plain {s['plain_ms']:.4f} ms, "
            f"matmul K/V + SDPA {s['library_ms']:.4f} ms (device "
            f"{s['library_device_ms']:.4f}), bound {s['bound_ms']:.4f} ms "
            f"({s['bound_by']})")
    for name in ("decode_attention", "ssd_scan"):
        for s in report[name]["shapes"]:
            lib = (f", SDPA {s['library_ms']:.4f} ms (device "
                   f"{s['library_device_ms']:.4f})" if "library_ms" in s
                   else "")
            say(f"  {name} {s['name']}: kernel {s['ms']:.4f} ms (device "
                f"{s['device_ms']:.4f}), parent {s['parent_ms']:.4f} ms "
                f"(device {s['parent_device_ms']:.4f}){lib}, bound "
                f"{s['bound_ms']:.4f} ms ({s['bound_by']})")
    for name, (_, replaces) in KERNELS.items():
        r = report[name]
        b_ms, b_by = bound(r["flops"], r["bytes"], r["dtype"])
        lib = ("none (no single PyTorch call)" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        say(f"  {name} at {r['shape']}: kernel {r['ms']:.3f} ms "
            f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s of the function), "
            f"plain {r['plain_ms']:.3f} ms, library {lib}, "
            f"bound {b_ms:.4f} ms ({b_by})"
            + (f", K/V regeneration x{r['regeneration']}"
               if "regeneration" in r else ""))
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "max_err": r["max_abs_err"], "kernel_ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": r["library_ms"]})
        for key in ("device_ms", "parent_ms", "parent_device_ms",
                    "library_device_ms"):
            if key in r:
                rows[-1][key] = r[key]
        if name in ROUTED:
            rows[-1]["routes"] = launches[f"{name} routes"]
    r = report["flash_attention"]["shapes"][0]
    rows.append({"name": "flash_attention (wide route)", "route": "cuda",
                 "source": "src/repro_torch/csrc/attention_wide.cuh",
                 "replaces": KERNELS["flash_attention"][1],
                 "launches": launches["flash_attention routes"]["wide"],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "device_ms": r["device_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "library_device_ms": r["library_device_ms"],
                 "shape": r["name"]})
    r = report["flash_attention_bwd_wide"]
    b_ms, b_by = bound(r["flops"], r["bytes"], r["dtype"])
    say(f"  flash_attention_bwd wide route at {r['shape']}: kernel "
        f"{r['ms']:.3f} ms (device {r['device_ms']:.3f}), parent "
        f"{r['parent_ms']:.3f} ms (device {r['parent_device_ms']:.3f}), "
        f"plain {r['plain_ms']:.3f} ms, SDPA's backward "
        f"{r['library_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows.append({"name": "flash_attention_bwd (wide route)", "route": "cuda",
                 "source": "src/repro_torch/csrc/attention_bwd_wide_tc.cuh",
                 "replaces": KERNELS["flash_attention_bwd"][1],
                 "launches": launches["flash_attention_bwd routes"]["wide"],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "device_ms": r["device_ms"], "parent_ms": r["parent_ms"],
                 "parent_device_ms": r["parent_device_ms"],
                 "plain_ms": r["plain_ms"],
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": r["library_ms"],
                 "library_backend": r["library_backend"]})
    say(json.dumps({"kernels": rows, "tile_gemm_shapes": gemm_shapes,
                    "decode_attention_shapes":
                        report["decode_attention"]["shapes"],
                    "ssd_scan_shapes": report["ssd_scan"]["shapes"],
                    "stream_attention_shapes":
                        report["stream_attention"]["shapes"],
                    "flash_attention_shapes":
                        report["flash_attention"]["shapes"],
                    **{f"{name}_shapes": report[name]["shapes"]
                       for name in BWD + ("ssd_scan_bwd",
                                          "flash_attention_bwd_wide")},
                    "int8_projection_shapes": report["int8_projection"]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
