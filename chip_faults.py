#!/usr/bin/env python3
"""Check that chip_smoke.py's comparisons of kernel against plain version
catch a wrong kernel.

    python3 chip_faults.py [fault ...]

With fault labels (the keys of FAULTS), only those are planted.  For each
planted fault, a copy of chip_smoke.py and src/repro_torch/
under build/planted_faults/<fault>/ (git-ignored) gets one fault in a
kernel's CUDA source: the attention kernels drop the last live kv tile
of their range, the stream kernel also attends in every sub-step to its
own generated tile in place of the one forwarded from its peers; the
GEMM's three bf16 routes: mma skips its last 32-wide K chunk, wgmma's
consumers skip the products of their last 64-wide k-step, splitk's
reduction drops its last K split; decode attention's tc route (bf16)
never loads a row's last live tile, or its merge leaves out the last
split's values, and its simt route (f32) skips the last tile of each W
chunk; the SSD scan's tc route (bf16) drops the carry between chunks in
its state-passing stage, or writes no y for the last chunk, and its simt
route (f32) drops the carry of the state from one chunk to the next; the
backward kernels, on both routes (tc in bf16, simt in f32): the dK/dV
kernel skips the last query tile of each head, the flash dQ kernel the
last live kv tile, the stream dK/dV kernel drops the rotation terms of the
RoPE backward, or the second term of the qk-norm backward (those two only
at the test cases: the main shapes, vilbert-base's, have neither RoPE nor
qk-norm); and on the tc route the dQ products leave out dS's lo half,
the stream dQ kernel skips the tile forwarded once around its cluster, or
the flash dK/dV kernel's second warpgroup adds only its first group of
spans to the block's totals;
flash attention's wide route (MLA's 576/512 heads): the tensor-core
kernel drops the last 64-column box of q/k from Q K^T (the roped part),
or skips the rescale of the last 128 output columns; flash's SIMT kernel
(f32, every width) drops the last 64-column chunk of q/k; the flash
backward's wide route: the dK/dV kernel leaves the last head of each
group out of its sum (the wgmma kernels in bf16, the SIMT one in f32),
or the SIMT dQ kernel its last live kv tile (f32), and in bf16 each dK/dV
block skips its last live query span, the sum of the split partials
leaves out the last head slice, or dQ drops dS's lo half; the SSD
backward's simt route (f32): the reverse pass drops the decay of the
state gradient it carries between chunks, or the chunk kernel takes
exp(LD_last - LD_s) with the wrong sign; its tc route (bf16): the same
dropped decay in its pass, dLD's column sums with the wrong sign, the lo
halves of the split states left out, or dc's Q B products without the
chunk's first 16 rows of s.
chip_smoke's check of that kernel then runs on the copy, in a
subprocess, in the dtype of the faulty route, once at the kernel test
cases and once at the main path's shapes (the GEMM's faults once more at
hymba-1.5b's main shapes alone, as the first failing shape ends a run).
Each run must fail with that kernel's comparison message, which names
the worst element's error over its limit.  The SSD scan's carry faults
also run chip_smoke's model checks (phase 9: f32 for the simt route, the
bf16 first-layer state for the tc route), which must fail on them
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
# (several names, space-separated: chip_smoke's lists of one part)
FLASH = ("FLASH_CASES FLASH_WIDE_CASES", "MAIN_FLASH", "check_flash")
STREAM = ("STREAM_CASES", "MAIN_STREAM", "check_stream")
GEMM = ("GEMM_CASES", "MAIN_GEMM", "check_gemm")
DECODE = ("DECODE_CASES", "MAIN_DECODE", "check_decode")
SSD = ("SSD_CASES", "MAIN_SSD", "check_ssd")
FLASH_BWD = ("FLASH_BWD_CASES", "MAIN_FLASH_BWD", "check_flash_bwd")
STREAM_BWD = ("STREAM_BWD_CASES", "MAIN_STREAM_BWD", "check_stream_bwd")
FLASH_BWD_WIDE = ("FLASH_BWD_WIDE_CASES", "MAIN_FLASH_BWD_WIDE",
                  "check_flash_bwd_wide")
SSD_BWD = ("SSD_BWD_CASES", "MAIN_SSD_BWD", "check_ssd_bwd")
# fault: (kernel, CUDA source, (text, planted replacement),
#         chip_smoke's (test cases, main-path shapes, check function))
FAULTS = {
    "flash_attention": ("flash_attention", "flash_attention.cu",
                        SKIP_LAST_LIVE_TILE, FLASH),
    # the wide route (MLA's widths): tc drops the last box of q/k (the
    # roped columns) from Q K^T, or leaves the last 128 output columns
    # unrescaled; the SIMT kernel (f32, every width) drops the last chunk
    # of q/k
    "flash_attention_wide_tc_rope": (
        "flash_attention", "attention_wide.cuh",
        ("for (int ks = 0; ks < WIDE_KSTEPS; ++ks)",
         "for (int ks = 0; ks < WIDE_KSTEPS - 4; ++ks)"), FLASH),
    "flash_attention_wide_tc_rescale": (
        "flash_attention", "attention_wide.cuh",
        ("      rescale(o[n], alpha);",
         "      if (wg == 0 || n == 0) rescale(o[n], alpha);"), FLASH),
    "flash_attention_simt": (
        "flash_attention", "flash_attention.cu",
        ("for (int d0 = 0; d0 < sh.hd; d0 += BK) {",
         "for (int d0 = 0; d0 < sh.hd - BK; d0 += BK) {"), FLASH),
    "stream_attention": ("stream_attention", "stream_attention.cu",
                         SKIP_LAST_LIVE_TILE, STREAM),
    # every sub-step reads buf[0], the block's own tile, not the forwarded one
    "stream_attention_own_tile": (
        "stream_attention", "stream_tc.cuh",
        ("const uint32_t tile = bufs + (s % 2) * TILE;",
         "const uint32_t tile = bufs;"), STREAM),
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
    # decode attention's tc route (bf16): the row's last live tile is never
    # loaded, or the merge leaves out the last split's values; its simt
    # route (f32): the last tile of each W chunk is skipped
    "decode_attention_tc_tile": (
        "decode_attention", "decode_attention.cu",
        ("const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;",
         "const int t_lo = lo / BK, "
         "t_hi = max(t_lo + 1, (hi + BK - 1) / BK - 1);"), DECODE),
    "decode_attention_tc_merge": (
        "decode_attention", "decode_attention.cu",
        ("        if (s0 + j < n_live) {\n"
         "          const float m_new = fmaxf(m, ms[j]);",
         "        if (s0 + j < n_live - 1) {\n"
         "          const float m_new = fmaxf(m, ms[j]);"), DECODE),
    "decode_attention_simt": ("decode_attention", "decode_attention.cu",
                              ("for (int t0 = t_lo; t0 < t_hi; t0 += BK)",
                               "for (int t0 = t_lo; t0 < t_hi - BK; t0 += BK)"),
                              DECODE),
    # the SSD scan's tc route (bf16): stage 3 drops the carry between
    # chunks (each chunk enters with the last one's own contribution), or
    # stage 4 writes no y for the last chunk; its simt route (f32): the
    # carry of the state from one chunk to the next is dropped
    "ssd_scan_tc_carry": (
        "ssd_scan", "ssd_scan.cu",
        ("      run = make_float4(fmaf(d[i], run.x, v[i].x), "
         "fmaf(d[i], run.y, v[i].y),\n"
         "                        fmaf(d[i], run.z, v[i].z), "
         "fmaf(d[i], run.w, v[i].w));",
         "      run = v[i];"), SSD),
    "ssd_scan_tc_last_chunk": (
        "ssd_scan", "ssd_scan.cu",
        ("      if (row[r] < tv && p < pw)",
         "      if (row[r] < tv && p < pw && ch + 1 < sh.nc)"), SSD),
    "ssd_scan_simt": ("ssd_scan", "ssd_scan.cu",
                      ("st[n * PS + p] = fmaf(decay, st[n * PS + p], acc[j]);",
                       "st[n * PS + p] = acc[j];"), SSD),
    # the backward kernels' tc route (bf16): dK/dV skips each head's last
    # query tile (the span rule both its producer and consumers read), flash
    # dQ its last live kv tile; the stream dK/dV drops the rotation terms of
    # the RoPE backward, or the second term of the qk-norm backward; dQ
    # leaves out the lo half of dS; the stream dQ skips the tile forwarded
    # once around its cluster (every round's sub-step 1)
    "flash_attention_bwd_tc_dkv": (
        "flash_attention_bwd", "attention_bwd_tc.cuh",
        ("  return j >= kv.lo && j < kv.hi;",
         "  return j >= kv.lo && j < kv.hi && q0 + bwd::BQ < sh.Sq;"),
        FLASH_BWD),
    "flash_attention_bwd_tc_dq": (
        "flash_attention_bwd", "flash_attention_bwd.cu", SKIP_LAST_LIVE_TILE,
        FLASH_BWD),
    # flash dK/dV: warpgroup 1 adds only its first group of spans to the
    # totals (its later sums are lost)
    "flash_attention_bwd_tc_flush": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        ("    named_sync(BAR_TURN0, CONSUMERS);\n    acc.flush(tot);",
         "    named_sync(BAR_TURN0, CONSUMERS);\n    if (!done) acc.flush(tot);"),
        FLASH_BWD),
    "stream_attention_bwd_tc_rope": (
        "stream_attention_bwd", "stream_attention_bwd.cu",
        ("          dk[a] = g1 * cs + g2 * sn;\n"
         "          dk[c] = g2 * cs - g1 * sn;",
         "          dk[a] = g1 * cs;\n"
         "          dk[c] = g2 * cs;"), STREAM_BWD),
    "stream_attention_bwd_tc_norm": (
        "stream_attention_bwd", "stream_attention_bwd.cu",
        ("dk[x] = r[h] * gm * dk[x] - r[h] * r[h] * r[h] * kp * dot[h] / HD;",
         "dk[x] = r[h] * gm * dk[x];"), STREAM_BWD),
    "flash_attention_bwd_tc_ds_lo": (
        "flash_attention_bwd", "attention_bwd_tc.cuh",
        ("    mma_rm(dq, d_lo, k_hi);\n", ""), FLASH_BWD),
    "stream_attention_bwd_tc_forwarded": (
        "stream_attention_bwd", "stream_attention_bwd.cu",
        ("      rows.tile(sh, j, tile, tile + PART, tile + 2 * PART, "
         "tile + 3 * PART, dos);",
         "      if ((j - kv.lo) % cluster_size() != (cluster_rank() + "
         "cluster_size() - 1) % cluster_size())\n"
         "        rows.tile(sh, j, tile, tile + PART, tile + 2 * PART, "
         "tile + 3 * PART, dos);"), STREAM_BWD),
    # the simt route (f32): flash dK/dV skips each head's last query tile,
    # flash dQ its last live kv tile; stream dK/dV drops the rotation terms
    # of the RoPE backward, or the second term of the qk-norm backward
    "flash_attention_bwd_dkv": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        ("for (int q0 = 0; q0 < sh.Sq; q0 += BQ) {",
         "for (int q0 = 0; q0 < sh.Sq - BQ; q0 += BQ) {"), FLASH_BWD),
    "flash_attention_bwd_dq": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        ("for (int j = kv.lo; j < kv.hi; ++j) {",
         "for (int j = kv.lo; j < kv.hi - 1; ++j) {"), FLASH_BWD),
    "stream_attention_bwd_rope": (
        "stream_attention_bwd", "stream_attention_bwd.cu",
        ("      kr[e] = g1 * cs + g2 * sn;\n"
         "      kr[e + half] = g2 * cs - g1 * sn;",
         "      kr[e] = g1 * cs;\n"
         "      kr[e + half] = g2 * cs;"), STREAM_BWD),
    "stream_attention_bwd_norm": (
        "stream_attention_bwd", "stream_attention_bwd.cu",
        ("kr[e] = r * sd.k_gamma[e] * kr[e] - r * r * r * kp[e] * dot / hd;",
         "kr[e] = r * sd.k_gamma[e] * kr[e];"), STREAM_BWD),
    # the flash backward's wide route: dK/dV leaves the last head of each
    # group out of its sum (its bf16 wgmma kernels: the last head slice
    # one head short; its SIMT ones in f32); the SIMT dQ skips its last
    # live kv tile; the bf16 kernels also: each dK/dV block skips its last
    # live query span, or the last head slice's partial is left out of the
    # sum, or dQ's products drop dS's lo half
    "flash_attention_bwd_wide_tc_head": (
        "flash_attention_bwd", "attention_bwd_wide_tc.cuh",
        ("hg1 = (sp + 1) * gr.gc / splits;",
         "hg1 = (sp + 1) * gr.gc / splits - (sp == splits - 1);"),
        FLASH_BWD_WIDE),
    "flash_attention_bwd_wide_tc_span": (
        "flash_attention_bwd", "attention_bwd_wide_tc.cuh",
        ("    ++nsteps;\n", "    ++nsteps;\n  nsteps -= nsteps > 0;\n"),
        FLASH_BWD_WIDE),
    "flash_attention_bwd_wide_tc_split": (
        "flash_attention_bwd", "attention_bwd_wide_tc.cuh",
        ("for (int s = 0; s < splits; ++s)", "for (int s = 0; s < splits - 1; ++s)"),
        FLASH_BWD_WIDE),
    "flash_attention_bwd_wide_tc_lo": (
        "flash_attention_bwd", "attention_bwd_wide_tc.cuh",
        ("        tc::wgmma_ss<1>(pt[bx], al, kb, 1);\n", "\n"),
        FLASH_BWD_WIDE),
    "flash_attention_bwd_wide_head": (
        "flash_attention_bwd", "attention_bwd_wide.cuh",
        ("  for (int gi = 0; gi < gr.gc; ++gi) {",
         "  for (int gi = 0; gi < gr.gc - 1; ++gi) {"), FLASH_BWD_WIDE),
    "flash_attention_bwd_wide_dq": (
        "flash_attention_bwd", "attention_bwd_wide.cuh",
        ("  for (int j = kv.lo; j < kv.hi; ++j) {",
         "  for (int j = kv.lo; j < kv.hi - 1; ++j) {"), FLASH_BWD_WIDE),
    # the SSD backward, simt (f32): the reverse pass carries the state
    # gradient into the chunk before without its decay; the chunk kernel's
    # exp(LD_last - LD_s) takes the wrong sign; tc (bf16): the same dropped
    # carry in its pass, dLD's column sums added with the wrong sign, the
    # lo halves of the split states left out of their products, or the
    # chunk's Q tile products (dc = Q B) without the chunk's first rows
    "ssd_scan_bwd_carry": (
        "ssd_scan_bwd", "ssd_scan_bwd.cu",
        ("      grad = fmaf(dc[k], grad, v[k]);", "      grad = v[k];"),
        SSD_BWD),
    "ssd_scan_bwd_sign": (
        "ssd_scan_bwd", "ssd_scan_bwd.cu",
        ("    wl[tid] = expf(ld[L - 1] - ld[tid]);",
         "    wl[tid] = expf(ld[tid] - ld[L - 1]);"), SSD_BWD),
    "ssd_scan_bwd_tc_carry": (
        "ssd_scan_bwd", "ssd_scan_bwd_tc.cuh",
        ("      run = fma4(dc[k], run, v[k]);",
         "      run = reverse ? v[k] : fma4(dc[k], run, v[k]);"),
        SSD_BWD),
    "ssd_scan_bwd_tc_sign": (
        "ssd_scan_bwd", "ssd_scan_bwd_tc.cuh",
        ("    dla[t] = dla[t] - cols + el[t] * y2s[t] - kks[t];",
         "    dla[t] = dla[t] + cols + el[t] * y2s[t] - kks[t];"), SSD_BWD),
    "ssd_scan_bwd_tc_lo": (
        "ssd_scan_bwd", "ssd_scan_bwd_tc.cuh",
        ("  wm::mma16816(acc[2 * jp], af, bl[0], bl[1]);\n", "\n"), SSD_BWD),
    "ssd_scan_bwd_tc_rows": (
        "ssd_scan_bwd", "ssd_scan_bwd_tc.cuh",
        ("      for (int kk = 0; kk <= warp; ++kk) {   // s <= t",
         "      for (int kk = 1; kk <= warp; ++kk) {   // s <= t"), SSD_BWD),
}
# Faults checked at the test cases only (the main shapes do not reach them).
CASES_ONLY = ("stream_attention_bwd_rope", "stream_attention_bwd_norm",
              "stream_attention_bwd_tc_rope", "stream_attention_bwd_tc_norm")
# Kernel -> the name prefixes of main shapes it is also checked at alone.
MAIN_SUBSETS = {"tile_gemm": ("hymba",)}
# Faults in an f32 route: their runs check f32, the others bf16.
F32_FAULTS = ("decode_attention_simt", "ssd_scan_simt",
              "flash_attention_simt", "flash_attention_bwd_wide_head",
              "flash_attention_bwd_wide_dq",
              "ssd_scan_bwd_carry", "ssd_scan_bwd_sign",
              "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
              "stream_attention_bwd_rope", "stream_attention_bwd_norm")
# Run inside the faulty copy: chip_smoke's bf16 check of one kernel, at
# its test cases only ("cases"), at the main path's shapes only ("main"),
# or at the main shapes whose names start with the part.
CHECK = """
import torch
import chip_smoke as c
cases, main, check = {names!r}
part = {part!r}
c.DTYPES = (torch.{dtype},)
for name in (main if part == "cases" else cases).split():
    setattr(c, name, {{}} if part == "cases" else [])
if part not in ("cases", "main"):
    for name in main.split():
        setattr(c, name, {{k: v for k, v in getattr(c, name).items()
                           if k.startswith(part)}})
c._build.build_all([{kernel!r}])
getattr(c, check)(torch.Generator(device="cuda").manual_seed(0), {{}})
"""
# Kernels whose fault must also fail a model-level check of chip_smoke:
# kernel -> (the check's code, the start of its failure message).
MODEL_CHECKS = {
    label: ("import chip_smoke as c\n"
            "c._build.build_all()\n"
            "c.ssm_checks('')\n", message)
    for label, message in (("ssd_scan_simt", "FAIL: f32 "),
                           ("ssd_scan_tc_carry", "FAIL: bf16 "))}


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
    chosen = sys.argv[1:] or list(FAULTS)
    unknown = sorted(set(chosen) - set(FAULTS))
    if unknown:
        sys.exit(f"FAIL: unknown faults {unknown}; known: {list(FAULTS)}")
    missed = []
    try:
        for label in chosen:
            kernel, source, (text, fault), names = FAULTS[label]
            copy = plant(label, source, text, fault)
            dtype = "float32" if label in F32_FAULTS else "bfloat16"
            runs = {part: (CHECK.format(names=names, part=part,
                                        kernel=kernel, dtype=dtype),
                           f"FAIL: {kernel}")
                    for part in (("cases",) if label in CASES_ONLY
                                 else ("cases", "main")
                                 + MAIN_SUBSETS.get(kernel, ()))}
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
