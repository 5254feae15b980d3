#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's failure is
caught:
  1. the card's name and power limit, torch and CUDA versions;
  2. build of every kernel in src/repro_torch/csrc (one nvcc per source,
     in parallel), with the compiler's register/spill report;
  3. each kernel against its plain PyTorch version on the card, in f32 and
     bf16, at the kernel test cases (ragged kv_len, K = 768 included) and at
     the vilbert-base shapes of the main path; kernel, plain, library-call
     times and the card's bound at the main path's largest shape;
  4. the main path: vilbert-base VQA forward, bf16, B = 2, N_X = N_Y = 4096,
     in NON_STREAM, LAYER_STREAM and TILE_STREAM, with the kept-token counts
     and kernel launch counters checked; then the three modes against each
     other in f32 at N = 1024, B = 1;
  5. one JSON line of per-kernel numbers;
  6. the last line: {"ok": true, "device": {...}}.

Bound of a kernel call: the larger of its FLOPs over the H100 SXM peak of
its input type (989 TFLOP/s bf16, 67 TFLOP/s f32) and the bytes it must
move (inputs read once, output written once) over 3.35 TB/s.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.types import ExecutionMode  # noqa: E402
from repro_torch.kernels import _build, blocked, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.stream_attention import (  # noqa: E402
    query_rows, stream_attention)
from repro_torch.kernels.tile_gemm import tile_gemm  # noqa: E402
from repro_torch.models.vilbert import ViLBERT  # noqa: E402

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPES = (torch.float32, torch.bfloat16)
# Kernel against plain version: |got - want| <= atol + rtol * |want|.
# f32: the JAX package's kernel tolerances (tests/test_kernels.py), as
# atol = rtol.  bf16: kernel and plain version read the same bf16 inputs
# and both compute in f32, so they differ by the rounding of the output,
# at most one bf16 ulp, which is at most 2**-7 of the value; atol covers
# the f32 summation order near zero (measured below 2e-5 in f32).
# chip_faults.py plants faults (a kv tile or a K chunk skipped) in copies
# of the kernels and checks that these limits catch them.
BF16_TOL = (1e-4, 2 ** -7)
TOL = {"flash_attention": {torch.float32: (2e-4, 2e-4),
                           torch.bfloat16: BF16_TOL},
       "stream_attention": {torch.float32: (5e-4, 5e-4),
                            torch.bfloat16: BF16_TOL},
       "tile_gemm": {torch.float32: (1e-3, 1e-3), torch.bfloat16: BF16_TOL}}
# Three modes against each other, vilbert-base in f32 at N = 1024: the
# final vision and language streams (the logits say little: with random
# weights the pooler's tanh saturates), max |difference| over max |value|.
# Three summation orders in f32, carried through 12 layers.
MODE_TOL = 1e-4
EXPECTED_COUNTS = ((4096, 4096), (2816, 2816), (2816, 2816),
                   (2048, 2048), (1408, 1408), (1408, 1408))
KERNELS = {
    "stream_attention": (stream_attention,
                         "src/repro/kernels/stream_attention.py:167"),
    "flash_attention": (flash_attention,
                        "src/repro/kernels/flash_attention.py:105"),
    "tile_gemm": (tile_gemm, "src/repro/kernels/tile_gemm.py:57"),
}


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
    atol, rtol = TOL[name][got.dtype]
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{name} {case}: shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)} or non-finite output")
    g, w = got.float(), want.float()
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
]
GEMM_CASES = [(256, 128, 192), (512, 384, 256), (128, 256, 128),
              (128, 768, 256),   # K = 768: the reference's ragged-K case
              (100, 770, 130)]   # ragged M, N and K

# The main path's shapes at vilbert-base, B = 2, N = 4096 (first co-TRM
# block; text-only layers have the text self-attention shape).
MAIN_FLASH = {  # name: (B, H, Sq, Sk, hd)
    "vision self 4096": (2, 8, 4096, 4096, 128),
    "text self 4096": (2, 12, 4096, 4096, 64),
    "vision self 1408": (2, 8, 1408, 1408, 128),
}
MAIN_STREAM = {  # name: (B, H, Sq, Sk, hd, D)
    "vision self 4096": (2, 8, 4096, 4096, 128, 1024),
    "text self 4096": (2, 12, 4096, 4096, 64, 768),
    "vision co 4096": (2, 8, 4096, 4096, 128, 768),
    "text co 4096": (2, 12, 4096, 4096, 64, 1024),
    "text co 1408": (2, 12, 1408, 1408, 64, 1024),
}
MAIN_GEMM = {  # name: (M, K, N)
    "text mlp up": (8192, 768, 3072),
    "text mlp down": (8192, 3072, 768),
    "vision mlp": (8192, 1024, 1024),
}
TIMED = {"flash_attention": "vision self 4096",
         "stream_attention": "vision self 4096",
         "tile_gemm": "text mlp up"}


def check_flash(gen, report):
    name = "flash_attention"
    for dt in DTYPES:
        for B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len in FLASH_CASES:
            q = randn(gen, B, Hq, Sq, hd, dtype=dt, scale=0.5)
            k = randn(gen, B, Hkv, Sk, hd, dtype=dt, scale=0.5)
            v = randn(gen, B, Hkv, Sk, hdv, dtype=dt, scale=0.5)
            kw = dict(causal=causal, window=window,
                      q_offset=Sk - Sq if causal else 0, kv_len=kv_len)
            err = compare(name, f"{dt} case {(B, Hq, Hkv, Sq, Sk, hd, hdv)}",
                          flash_attention(q, k, v, **kw),
                          blocked.flash_attention_plain(q, k, v, **kw))
            say(f"  {name} {str(dt)[6:]} {(B, Hq, Hkv, Sq, Sk, hd, hdv)} "
                f"causal={causal} window={window} kv_len={kv_len}: "
                f"max|err| {err:.2e}")
        for case, (B, H, Sq, Sk, hd) in MAIN_FLASH.items():
            q = randn(gen, B, H, Sq, hd, dtype=dt)
            k = randn(gen, B, H, Sk, hd, dtype=dt)
            v = randn(gen, B, H, Sk, hd, dtype=dt)
            got = flash_attention(q, k, v)
            err = compare(name, f"{dt} {case}", got,
                          blocked.flash_attention_plain(q, k, v))
            say(f"  {name} {str(dt)[6:]} main path {case}: max|err| {err:.2e}")
            if dt == torch.bfloat16 and case == TIMED[name]:
                e = q.element_size()
                flops = 4 * B * H * Sq * Sk * hd
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * e
                report[name] = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: flash_attention(q, k, v)),
                    plain_ms=time_ms(
                        lambda: blocked.flash_attention_plain(q, k, v)),
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v)),
                    shape=f"q/k/v {(B, H, Sq, hd)} bf16",
                    flops=flops, bytes=nbytes, dtype=dt)


def check_stream(gen, report):
    name = "stream_attention"
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
            err = compare(name, f"{dt} case {(B, Hq, Hkv, Sq, Sk, hd, D)}",
                          stream_attention(q, x, wk, wv, **kw),
                          blocked.stream_attention_plain(q, x, wk, wv, **kw))
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
            if dt == torch.bfloat16 and case == TIMED[name]:
                e = q.element_size()
                flops = 4 * B * H * Sq * Sk * hd + 4 * B * Sk * D * H * hd
                nbytes = (2 * q.numel() + x.numel() + wk.numel()
                          + wv.numel()) * e

                def library():
                    k = (x.reshape(B * Sk, D) @ wk.reshape(D, H * hd)) \
                        .view(B, Sk, H, hd).transpose(1, 2)
                    v = (x.reshape(B * Sk, D) @ wv.reshape(D, H * hd)) \
                        .view(B, Sk, H, hd).transpose(1, 2)
                    return F.scaled_dot_product_attention(q, k, v)

                report[name] = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: stream_attention(q, x, wk, wv)),
                    plain_ms=time_ms(
                        lambda: blocked.stream_attention_plain(q, x, wk, wv)),
                    library_ms=time_ms(library),
                    shape=f"q {(B, H, Sq, hd)}, x_kv {(B, Sk, D)} bf16",
                    flops=flops, bytes=nbytes, dtype=dt,
                    regeneration=Sq / query_rows())


def check_gemm(gen, report):
    name = "tile_gemm"
    for dt in DTYPES:
        cases = [(c, c) for c in GEMM_CASES] + list(MAIN_GEMM.items())
        for case, (M, K, N) in cases:
            x = randn(gen, M, K, dtype=dt)
            w = randn(gen, K, N, dtype=dt, scale=K ** -0.5)
            got = tile_gemm(x, w)
            err = compare(name, f"{dt} {case}", got,
                          blocked.tile_gemm_plain(x, w))
            say(f"  {name} {str(dt)[6:]} {case} (M, K, N) = {(M, K, N)}: "
                f"max|err| {err:.2e}")
            if dt == torch.bfloat16 and case == TIMED[name]:
                e = x.element_size()
                report[name] = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: tile_gemm(x, w)),
                    plain_ms=time_ms(lambda: blocked.tile_gemm_plain(x, w)),
                    library_ms=time_ms(lambda: torch.matmul(x, w)),
                    shape=f"(M, K, N) {(M, K, N)} bf16",
                    flops=2 * M * K * N,
                    bytes=(M * K + K * N + M * N) * e, dtype=dt)


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def reset_counts() -> None:
    for fn, _ in KERNELS.values():
        fn.launches = 0


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


def main_path(launches: dict) -> None:
    cfg = get_config("vilbert-base")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = ViLBERT(cfg, device="cuda", generator=gen)
    batch = make_batch(cfg, 2, 4096, gen)
    torch.cuda.synchronize()
    say(f"  vilbert-base bf16 built in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    logits, streams = {}, {}
    for mode in ExecutionMode:
        model(batch, mode=mode)                      # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out, kept = model(batch, mode=mode, return_token_counts=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = counts()
        for name, n in got.items():
            launches[name] += n
        say(f"  {mode.value}: wall {wall:.1f} ms, launches {got}, "
            f"kept {kept}")
        if out.shape != (2, 3129) or not torch.isfinite(out).all():
            fail(f"{mode.value}: logits {tuple(out.shape)} not finite "
                 f"(2, 3129)")
        if kept != EXPECTED_COUNTS:
            fail(f"{mode.value}: kept counts {kept} != {EXPECTED_COUNTS}")
        if got["tile_gemm"] == 0:
            fail(f"{mode.value}: tile_gemm never launched")
        want_stream = mode == ExecutionMode.TILE_STREAM
        want_flash = mode == ExecutionMode.LAYER_STREAM
        if (got["stream_attention"] > 0) != want_stream \
                or (got["flash_attention"] > 0) != want_flash:
            fail(f"{mode.value}: attention launches {got} do not fit "
                 f"the mode")
        logits[mode] = out
        streams[mode] = model.encode(batch, mode=mode)[:2]
        say(f"    {mode.value} profile: "
            f"{device_breakdown(model, batch, mode)}")
    for mode in (ExecutionMode.LAYER_STREAM, ExecutionMode.TILE_STREAM):
        gap = (logits[mode] - logits[ExecutionMode.NON_STREAM]).abs().max()
        say(f"  bf16 {mode.value} vs non_stream: max |logit gap| "
            f"{gap.item():.3e}, stream gaps "
            f"{stream_gaps(streams[mode], streams[ExecutionMode.NON_STREAM])}"
            f" (not gated: a DTPU top-k may flip in bf16)")
    del model, batch, logits, streams

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = ViLBERT(cfg32, device="cuda", generator=gen)
    batch = make_batch(cfg32, 1, 1024, gen)
    outs = {m: model.encode(batch, mode=m) for m in ExecutionMode}
    base = outs[ExecutionMode.NON_STREAM]
    for mode, (x, y, kept) in outs.items():
        gaps = stream_gaps((x, y), base[:2])
        say(f"  f32 N=1024 {mode.value}: relative stream gaps to non_stream "
            f"{gaps} (tol {MODE_TOL}), kept {kept}")
        if kept != base[2] or max(gaps) > MODE_TOL \
                or not (torch.isfinite(x).all() and torch.isfinite(y).all()):
            fail(f"f32 modes disagree: {mode.value} gaps {gaps}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA card")
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

    say("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    check_flash(gen, report)
    check_stream(gen, report)
    check_gemm(gen, report)

    say("== phase 4: main path, vilbert-base")
    launches = {name: 0 for name in KERNELS}
    main_path(launches)

    rows = []
    for name, (_, replaces) in KERNELS.items():
        r = report[name]
        b_ms, b_by = bound(r["flops"], r["bytes"], r["dtype"])
        say(f"  {name} at {r['shape']}: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})"
            + (f", K/V regeneration x{r['regeneration']:.0f}"
               if "regeneration" in r else ""))
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "max_err": r["max_abs_err"], "kernel_ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
