#!/usr/bin/env python3
"""Check that chip_smoke.py's comparisons of kernel against plain version
catch a wrong kernel.

    python3 chip_faults.py

For each planted fault, a copy of chip_smoke.py and src/repro_torch/
under build/planted_faults/<fault>/ (git-ignored) gets one fault in a
kernel's CUDA source: the attention kernels drop the last live kv tile
of their range (decode attention: the last tile of each W chunk), the
stream kernel also attends in every sub-step to its own generated tile in
place of the one forwarded from its peers; the GEMM's three bf16 routes:
mma skips its last 32-wide K chunk, wgmma's consumers skip the products of
their last 64-wide k-step, splitk's reduction drops its last K split; the
SSD scan drops the carry of the state from one chunk to the next (each
chunk starts from its own contribution only).
chip_smoke's bf16 check of that kernel then runs on the copy, in a
subprocess, once at the kernel test cases and once at the main path's
shapes (the GEMM's faults once more at hymba-1.5b's main shapes alone, as
the first failing shape ends a run).  Each run must fail with that kernel's comparison message, which
names the worst element's error over its limit.  The SSD scan's fault
also runs chip_smoke's f32 model checks (phase 9), which must fail on it
too.  The script exits non-zero if a planted fault goes unnoticed.  Needs one CUDA card.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "planted_faults"
# The tensor-core attention kernels compute their live kv tiles [lo, hi)
# once, for the producer's loads and the consumers' loop alike.
LIVE_RANGE = "const KvRange kv = live_kv_tiles(sh, any, qmin, qmax);"
SKIP_LAST_LIVE_TILE = (LIVE_RANGE, LIVE_RANGE.replace(
    "= live_kv_tiles(sh, any, qmin, qmax);",
    "= {live_kv_tiles(sh, any, qmin, qmax).lo, "
    "live_kv_tiles(sh, any, qmin, qmax).hi - 1};"))
FLASH = ("FLASH_CASES", "MAIN_FLASH", "check_flash")
STREAM = ("STREAM_CASES", "MAIN_STREAM", "check_stream")
GEMM = ("GEMM_CASES", "MAIN_GEMM", "check_gemm")
# fault: (kernel, CUDA source, (text, planted replacement),
#         chip_smoke's (test cases, main-path shapes, check function))
FAULTS = {
    "flash_attention": ("flash_attention", "flash_attention.cu",
                        SKIP_LAST_LIVE_TILE, FLASH),
    "stream_attention": ("stream_attention", "stream_attention.cu",
                         SKIP_LAST_LIVE_TILE, STREAM),
    # every sub-step reads buf[0], the block's own tile, not the forwarded one
    "stream_attention_own_tile": (
        "stream_attention", "stream_attention.cu",
        ("const uint32_t tile = base + (s % 2) * L::TILE;",
         "const uint32_t tile = base;"), STREAM),
    # the GEMM's routes: mma skips its last K chunk, wgmma's consumers their
    # last k-step, splitk's reduction its last split
    "tile_gemm_mma": ("tile_gemm", "tile_gemm.cu",
                      ("for (int k0 = 0; k0 < K; k0 += TBK)",
                       "for (int k0 = 0; k0 < K - TBK; k0 += TBK)"), GEMM),
    "tile_gemm_wgmma": (
        "tile_gemm", "tile_gemm.cu",
        ("        wgmma_ss<1>(acc, desc_kmajor(a + kk * 32), "
         "desc_mnmajor(b + kk * 2048), 1);",
         "        if (ks < ksteps - 1) wgmma_ss<1>(acc, desc_kmajor(a + kk * 32), "
         "desc_mnmajor(b + kk * 2048), 1);"), GEMM),
    "tile_gemm_splitk": ("tile_gemm", "tile_gemm.cu",
                         ("for (int r = 1; r < S; ++r) v += __ldcg(",
                          "for (int r = 1; r < S - 1; ++r) v += __ldcg("),
                         GEMM),
    "decode_attention": ("decode_attention", "decode_attention.cu",
                         ("for (int t0 = t_lo; t0 < t_hi; t0 += BK)",
                          "for (int t0 = t_lo; t0 < t_hi - BK; t0 += BK)"),
                         ("DECODE_CASES", "MAIN_DECODE", "check_decode")),
    "ssd_scan": ("ssd_scan", "ssd_scan.cu",
                 ("st[n * PS + p] = fmaf(decay, st[n * PS + p], acc[j]);",
                  "st[n * PS + p] = acc[j];"),
                 ("SSD_CASES", "MAIN_SSD", "check_ssd")),
}
# Kernel -> the name prefixes of main shapes it is also checked at alone.
MAIN_SUBSETS = {"tile_gemm": ("hymba",)}
# Run inside the faulty copy: chip_smoke's bf16 check of one kernel, at
# its test cases only ("cases"), at the main path's shapes only ("main"),
# or at the main shapes whose names start with the part.
CHECK = """
import torch
import chip_smoke as c
cases, main, check = {names!r}
part = {part!r}
c.DTYPES = (torch.bfloat16,)
if part == "cases":
    setattr(c, main, {{}})
else:
    setattr(c, cases, [])
if part not in ("cases", "main"):
    setattr(c, main, {{k: v for k, v in getattr(c, main).items()
                       if k.startswith(part)}})
c._build.build_all([{kernel!r}])
getattr(c, check)(torch.Generator(device="cuda").manual_seed(0), {{}})
"""
# Kernels whose fault must also fail a model-level check of chip_smoke:
# kernel -> (the check's code, the start of its failure message).
MODEL_CHECKS = {"ssd_scan": ("import chip_smoke as c\n"
                             "c._build.build_all()\n"
                             "c.ssm_checks('')\n", "FAIL: f32 ")}


def plant(label: str, source: str, text: str, fault: str) -> Path:
    copy = WORK / label
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", copy / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", copy)
    path = copy / "src" / "repro_torch" / "csrc" / source
    code = path.read_text()
    if code.count(text) != 1:
        sys.exit(f"FAIL: {source}: the fault's site {text!r} is not unique")
    path.write_text(code.replace(text, fault))
    return copy


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA device: this check needs one NVIDIA card")
    missed = []
    try:
        for label, (kernel, source, (text, fault), names) in FAULTS.items():
            copy = plant(label, source, text, fault)
            runs = {part: (CHECK.format(names=names, part=part,
                                        kernel=kernel), f"FAIL: {kernel}")
                    for part in ("cases", "main")
                    + MAIN_SUBSETS.get(kernel, ())}
            if label in MODEL_CHECKS:
                runs["model"] = MODEL_CHECKS[label]
            for part, (code, message) in runs.items():
                run = subprocess.run([sys.executable, "-c", code], cwd=copy,
                                     capture_output=True, text=True,
                                     timeout=600)
                lines = run.stderr.strip().splitlines()
                caught = (run.returncode != 0
                          and any(ln.startswith(message) for ln in lines))
                print(f"{label}, {part}, {fault!r}: "
                      f"{'caught' if caught else 'MISSED'}: "
                      f"{lines[-1] if lines else '(no message)'}",
                      flush=True)
                if not caught:
                    missed.append(f"{label} {part}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if missed:
        sys.exit(f"FAIL: planted faults not caught: {missed}")
    print("every planted fault was caught")


if __name__ == "__main__":
    main()
