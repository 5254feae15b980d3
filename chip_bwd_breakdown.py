#!/usr/bin/env python3
"""Where the backward kernels' tensor-core routes spend their time, on one
NVIDIA card.

    python3 chip_bwd_breakdown.py [stream] [ssd] [wide] [flash]

For each named target (all four by default), builds copies of csrc/
under build/bwd_breakdown/<target>-<variant>/ in which one part of a
kernel is left out, and times each copy's kernels by the profiler, kernel
by kernel (each stage of a route is a kernel of its own, so the base
variant gives the stages' times apart); each variant runs in its own
process.  A variant computes wrong gradients: the difference of its
kernel's time from the base's is what the part costs.

stream: the stream attention backward's tc dK/dV kernel (stream_dkv_tc)
at vilbert-base's vision and text self-attention shapes (B = 2,
N = 4096, bf16):
  base         the kernels as they are;
  no_walk      no span products (the ring still delivers every span);
  no_dw        no dW products and no read-modify-write of the dW slots;
  no_dx_reduce no distributed-shared-memory sum of the dx partials;
  no_gen_mma   no K/V generation products (the chunks still arrive; in
               both passes).
ssd: the SSD backward's tc route (csrc/ssd_scan_bwd_tc.cuh) at phase 19's
mamba2-780m and hymba-1.5b layers (S = 2048, bf16):
  base         its six kernels (bwd_cb, bwd_contrib_tc, bwd_pass_tc,
               bwd_chunk_tc, bwd_reduce, bwd_da);
  no_db        bwd_chunk_tc without its db products and stores;
  no_du        bwd_chunk_tc without du's products (dx, ddt's sums).
wide: the flash backward's wide route in bf16 (csrc/attention_bwd_wide_tc
.cuh) at deepseek-v3's MLA shape (q (1, 128, 1024, 576), one kv head,
v 512, causal):
  base         its kernels (delta, wide_probs_wg, wide_dkv_wg,
               wide_dkv_sum, wide_dq_wg);
  no_probs_out wide_probs_wg without its epilogue (P and dS neither formed
               nor written: what the products and loads alone take);
  no_dkv_mma   wide_dkv_wg without its products (the ring still delivers
               every span: what the loads and the loop cost);
  no_dq_mma    the same for wide_dq_wg;
  and design alternatives, right answers at other speeds (blocks an SM
  asked by __launch_bounds__):
  probs_3x3    wide_probs_wg with a ring of 3 stages, 3 blocks an SM;
  probs_8x1    ... 8 stages, 1 block an SM;
  dkv_3x1      wide_dkv_wg with 3 stages, 1 block an SM;
  boxes_2x3    dK/dV and dQ blocks of 2 column boxes (128 columns), 3
               blocks an SM.
flash: the flash backward's tc route (csrc/flash_attention_bwd.cu,
attention_bwd_tc.cuh) at vilbert-base's vision self-attention (B = 2,
8 heads, N = 4096, hd 128) and qwen3-32b's causal GQA training shape (64
query and 8 kv heads, S = 4096, hd 128), bf16:
  base         its kernels (delta_kernel, flash_dkv_tc, flash_dq_tc);
  and a design alternative (the same function, other f32 sums):
  one_chain    flash_dkv_tc's accumulators carried over every span of a
               warpgroup and added to the totals once at the end (no
               flush every FLUSH_SPANS spans; the earlier design's sums).
Prints the card's name and power limit, then one line a variant and shape.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDE = "attention_bwd_wide_tc.cuh"


def _bounds(kernel: str, blocks: int):
    """The edit that asks for `blocks` blocks an SM of a wide kernel."""
    return (WIDE, f"__launch_bounds__(WGT, 2)\n{kernel}(",
            f"__launch_bounds__(WGT, {blocks})\n{kernel}(")


SRC = ROOT / "src" / "repro_torch" / "csrc"
WORK = ROOT / "build" / "bwd_breakdown"
# target: (library, {variant: None, (source, its text, the text without
# the part), or a list of such edits})
TARGETS = {
    "stream": ("stream_attention_bwd", {
        "base": None,
        "no_walk": ("stream_attention_bwd.cu",
                    "          acc.span(sh, j * BK, q0, kv,",
                    "          if (0) acc.span(sh, j * BK, q0, kv,"),
        "no_dw": ("stream_attention_bwd.cu",
                  "        for (int hb = 0; hb < NH; ++hb) {\n"
                  "          const uint32_t d = dkv + hb * 4 * PART;\n"
                  "          const size_t o",
                  "        for (int hb = 0; hb < 0; ++hb) {\n"
                  "          const uint32_t d = dkv + hb * 4 * PART;\n"
                  "          const size_t o"),
        "no_dx_reduce": ("stream_attention_bwd.cu",
                         "        for (int i = rank; i < 8; i += C) {",
                         "        for (int i = 8; i < 8; i += C) {"),
        "no_gen_mma": ("stream_tc.cuh",
                       "      wgmma_ss<1>(g, desc_kmajor(xs + ks * 32), "
                       "desc_mnmajor(ws + ks * 2048), 1);",
                       "      if (0) wgmma_ss<1>(g, desc_kmajor(xs + ks * 32), "
                       "desc_mnmajor(ws + ks * 2048), 1);"),
    }),
    "ssd": ("ssd_scan_bwd", {
        "base": None,
        "no_db": ("ssd_scan_bwd_tc.cuh",
                    "  for (int n0 = 0; n0 < NP; n0 += 64) {\n"
                    "    const int npairs = min(4, (NP - n0) / 16);\n"
                    "    float a1[8][4] = {}, a2[8][4] = {};",
                    "  for (int n0 = 0; n0 < 0; n0 += 64) {\n"
                    "    const int npairs = min(4, (NP - n0) / 16);\n"
                    "    float a1[8][4] = {}, a2[8][4] = {};"),
        "no_du": ("ssd_scan_bwd_tc.cuh",
                  "    for (int p0 = 0; p0 < PP; p0 += 64) {",
                  "    for (int p0 = 0; p0 < 0; p0 += 64) {"),
    }),
    "wide": ("flash_attention_bwd", {
        "base": None,
        "no_probs_out": ("attention_bwd_wide_tc.cuh",
                         "  for (int h = 0; h < 2; ++h) {\n"
                         "    const int row = f.r0 + 8 * h, qi = q0 + row;",
                         "  for (int h = 0; h < 0; ++h) {\n"
                         "    const int row = f.r0 + 8 * h, qi = q0 + row;"),
        "no_dkv_mma": ("attention_bwd_wide_tc.cuh",
                       "    for (int kk = 0; kk < 4; ++kk) {\n"
                       "      const uint64_t ah = tc::desc_mnmajor(",
                       "    for (int kk = 0; kk < 0; ++kk) {\n"
                       "      const uint64_t ah = tc::desc_mnmajor("),
        "no_dq_mma": ("attention_bwd_wide_tc.cuh",
                      "    for (int kk = 0; kk < 4; ++kk) {\n"
                      "      const uint64_t ah = tc::desc_kmajor(",
                      "    for (int kk = 0; kk < 0; ++kk) {\n"
                      "      const uint64_t ah = tc::desc_kmajor("),
        # design alternatives (right answers, other speeds)
        "probs_3x3": [_bounds("wide_probs_wg", 3),
                      (WIDE, "constexpr int PROBS_STAGES = 4;",
                       "constexpr int PROBS_STAGES = 3;")],
        "probs_8x1": [_bounds("wide_probs_wg", 1),
                      (WIDE, "constexpr int PROBS_STAGES = 4;",
                       "constexpr int PROBS_STAGES = 8;")],
        "dkv_3x1": [_bounds("wide_dkv_wg", 1),
                    (WIDE, "constexpr int DKV_STAGES = 2;",
                     "constexpr int DKV_STAGES = 3;")],
        "boxes_2x3": [_bounds("wide_dkv_wg", 3), _bounds("wide_dq_wg", 3),
                      (WIDE, "constexpr int COL_BOXES = 3;",
                       "constexpr int COL_BOXES = 2;")],
    }),
}
TARGETS["flash"] = ("flash_attention_bwd", {
    "base": None,
    "one_chain": ("flash_attention_bwd.cu", "constexpr int FLUSH_SPANS = 4;",
                  "constexpr int FLUSH_SPANS = 1 << 20;"),
})
FORWARD = {"stream": "stream_attention", "ssd": "ssd_scan",
           "wide": "flash_attention", "flash": "flash_attention"}


def plant(target: str, variant: str) -> Path:
    """A copy of csrc/ with the variant's part left out."""
    dst = WORK / f"{target}-{variant}" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(SRC, dst)
    part = TARGETS[target][1][variant]
    for source, text, fault in ([part] if isinstance(part, tuple)
                                else part or []):
        code = (dst / source).read_text()
        if code.count(text) != 1:
            sys.exit(f"FAIL: {target} {variant}: its site in {source} is "
                     f"not unique")
        (dst / source).write_text(code.replace(text, fault))
    return dst


def calls(target: str, gen):
    """{shape name: a call of the target's backward} on inputs made (and
    forwards run) with the kernels as they are."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_vjp import (flash_attention_bwd,
                                               stream_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.kernels.stream_attention import stream_attention

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    out = {}
    if target == "stream":
        for key, (B, H, S, hd, D) in {
                "vision self 4096": (2, 8, 4096, 128, 1024),
                "text self 4096": (2, 12, 4096, 64, 768)}.items():
            q, x, do = randn(B, H, S, hd), randn(B, S, D), randn(B, H, S, hd)
            wk, wv = (randn(D, H, hd, scale=D ** -0.5) for _ in range(2))
            o, lse = stream_attention(q, x, wk, wv, return_lse=True)
            out[key] = (lambda q=q, x=x, wk=wk, wv=wv, o=o, lse=lse, do=do:
                        stream_attention_bwd(q, x, wk, wv, o, lse, do))
    elif target == "ssd":
        for key, (B, S, H, P, N) in {
                "mamba2-780m train 2048": (1, 2048, 48, 64, 128),
                "hymba-1.5b train 2048": (1, 2048, 25, 128, 16)}.items():
            x, dy = randn(B, S, H, P, scale=0.5), randn(B, S, H, P)
            b, c = randn(B, S, N, scale=0.3), randn(B, S, N, scale=0.3)
            dt = torch.rand((B, S, H), generator=gen, device="cuda") * 0.1
            a = -(1 + 15 * torch.rand((H,), generator=gen, device="cuda"))
            out[key] = (lambda x=x, dt=dt, a=a, b=b, c=c, dy=dy:
                        ssd_scan_bwd(x, dt, a, b, c, dy))
    elif target == "flash":
        for key, (B, H, Hkv, S, causal) in {
                "vision self 4096": (2, 8, 8, 4096, False),
                "qwen3-32b train 4096": (1, 64, 8, 4096, True)}.items():
            q, do = randn(B, H, S, 128), randn(B, H, S, 128)
            k, v = randn(B, Hkv, S, 128), randn(B, Hkv, S, 128)
            o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            out[key] = (lambda q=q, k=k, v=v, o=o, lse=lse, do=do, c=causal:
                        flash_attention_bwd(q, k, v, o, lse, do, causal=c))
    else:
        B, H, S, hd, hdv = 1, 128, 1024, 576, 512
        q = randn(B, H, S, hd, scale=0.5)
        k, v = randn(B, 1, S, hd, scale=0.5), randn(B, 1, S, hdv, scale=0.5)
        do = randn(B, H, S, hdv)
        o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        out["deepseek-v3 MLA train 1024"] = (
            lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    return out


def measure(target: str, variant: str) -> None:
    """Build the variant's library and time its kernels (one process)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    runs = calls(target, torch.Generator(device="cuda").manual_seed(0))
    _build.CSRC = WORK / f"{target}-{variant}" / "csrc"
    _build.BUILD_DIR = WORK / f"{target}-{variant}"
    for key, run in runs.items():
        run()
        torch.cuda.synchronize()
        reps = 5
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if e.self_device_time_total:
                # the function's name from the demangled key (kernels in an
                # anonymous namespace or templates included)
                m = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
                name = m.group(1) if m else e.key[:24]
                parts[name] = (parts.get(name, 0.0)
                               + e.self_device_time_total / reps / 1e3)
        print(f"{target:>6} {variant:>12} {key}: total "
              f"{sum(parts.values()):.4f} ms; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()),
              flush=True)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        measure(sys.argv[2], sys.argv[3])
        return
    targets = sys.argv[1:] or list(TARGETS)
    unknown = sorted(set(targets) - set(TARGETS))
    if unknown:
        sys.exit(f"FAIL: unknown targets {unknown}; known: {list(TARGETS)}")
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA device: this breakdown needs one NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    try:
        jobs = [j for j in (_build._start(FORWARD[t]) for t in targets) if j]
        for t in targets:           # every variant's build at once
            for variant in TARGETS[t][1]:
                _build.CSRC = plant(t, variant)
                _build.BUILD_DIR = WORK / f"{t}-{variant}"
                jobs += [j for j in [_build._start(TARGETS[t][0])] if j]
        for proc, tmp, lib, log in jobs:
            rc = proc.wait()
            log.close()
            if rc:
                sys.exit(f"FAIL: nvcc failed for {lib}:\n"
                         + lib.with_suffix(".log").read_text()[-4000:])
            os.replace(tmp, lib)
        for t in targets:
            for variant in TARGETS[t][1]:
                run = subprocess.run([sys.executable, __file__, "--measure",
                                      t, variant], timeout=900,
                                     env=dict(os.environ))
                if run.returncode:
                    sys.exit(f"FAIL: {t} variant {variant} exited "
                             f"{run.returncode}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
