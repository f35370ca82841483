"""Where the bf16 ``flash_attention`` kernel (v4) spends its time, on one
CUDA card, at the LM arms' route shapes:

    PYTHONPATH=src python -m repro_torch.kernels.flash_study [--timeline | --probe | --against DIR]

Variants (the default): the kernel's source with one edit each, built by
``nvcc`` into a temporary directory and launched through the C entry point
on the same inputs and tiling as the wrapper's; device ms per call by CUDA
events (median of 5 runs of 20 back-to-back calls). Variants that skip work
compute garbage: they are timing probes, never results. A copy of q
(``clone``) is timed beside them as the device-memory floor of reading Q
and writing O. The unedited build's ``-Xptxas -v`` lines (registers,
spills) are printed first.

``--timeline``: the kernel built with ``clock64`` stamps at its phase
boundaries (thread 0 of each warpgroup) and ``%globaltimer`` at block entry
and exit, at the qwen and starcoder2 route shapes; prints the median cycles
of each phase of a warpgroup's first and second M tile, the blocks resident
per SM and the occupancy the runtime reports.

``--probe``: the rate at which ``cp.async`` brings a buffer into shared
memory with every SM copying, for a 16 MB buffer read before (resident in
the 50 MB L2) and for a 2 GB one (from device memory), at 128-512 threads
and 1-2 blocks an SM: the ceiling on the rate a kernel can refill its tiles.

``--against DIR``: this tree's kernel beside the checkout DIR's (e.g. the
parent's, ``git archive`` unpacked under ``build/checkout/``), in turns
(DIR, this, this, DIR) at every route shape and the training and binding
window shapes, with SDPA and the byte bound: DIR's entry point is called
with DIR's own argument list (read from its ``kernels/_build.py``); where
that is the earlier 15-argument entry, it is called as its wrapper called
it, q, k and v zero-padded to the template head dim and the output sliced.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import flash_attention as fa

SOURCE = _build.CSRC / "flash_attention.cu"
# name: (B, S, H, G, hd, window), the LM-arm route's shapes
SHAPES = {"recurrentgemma": (64, 127, 16, 1, 256, 2048), "smollm": (64, 127, 9, 3, 64, 0),
          "danube": (64, 127, 32, 8, 80, 4096), "starcoder2": (64, 127, 36, 4, 128, 0),
          "qwen": (64, 127, 64, 8, 128, 0), "moonshot": (64, 127, 16, 16, 128, 0)}
TIMELINE_SHAPES = ("qwen", "starcoder2")
# --against also times smollm-135m's training shape and danube's window where it binds
TABLE_SHAPES = {**SHAPES, "smollm training": (8, 512, 9, 3, 64, 0),
                "danube window": (1, 4608, 32, 8, 80, 4096)}
HBM_BYTES_PER_S = 3.35e12


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"edit anchor not found once in {SOURCE.name}: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """name -> source of each probe."""
    e = lambda old, new: _edit(src, old, new)
    return {
        "as is": src,
        "no tiles (Q in, O out)": e("    tb = hi > lo ? (hi - k_lo", "    tb = false && hi > lo ? (hi - k_lo"),
        "no Q load": _edit(e("      tma_load5(dst + cb * kRows * L::kW, &tm_q,",
                               "      if (false) tma_load5(dst + cb * kRows * L::kW, &tm_q,"),
                             "    mbar_expect(bar, kBlocks * L::kCols * pk.rb * pk.pb * 2);",
                             "    mbar_expect(bar, 0);"),
        "no K/V load": _edit(e("      tma_load4(ks + at, &tm_k,", "      if (false) tma_load4(ks + at, &tm_k,"),
                             "    mbar_expect(bar, 2 * kKVBytes);\n",
                             "    mbar_expect(bar, 0);\n")
                       .replace("      tma_load4(vs + at, &tm_v,", "      if (false) tma_load4(vs + at, &tm_v,"),
        "no S wgmma": e("        Wgmma<kKeys>::ss(", "        if (false) Wgmma<kKeys>::ss("),
        "no PV wgmma": e("        Wgmma<HD>::rs(", "        if (false) Wgmma<HD>::rs("),
        "no O store": e("        tma_store5(&tm_o,", "        if (false) tma_store5(&tm_o,"),
        "L2 policies normal": _edit(e("L2::evict_first.b64", "L2::evict_normal.b64"),
                                    "L2::evict_last.b64", "L2::evict_normal.b64"),
    }


# the unedited kernel at other tilings: name -> arguments of ``cut`` that
# replace the rule's (warpgroups a block, Q and O buffers, chunks x, keys streamed)
TILINGS = {"v4 at every ratio": {}, "O staged in the Q buffer": {"o_bufs": 0},
           "2 warpgroups": {"wgs": 2}}


def timeline_source(src: str) -> str:
    """The kernel with phase stamps, per warpgroup w of block bid (row 2 bid
    + w): slot 0 entry; for its M tiles i < 3, 1 + 8i Q landed, 2 + 8i the
    first K/V tile landed, 3 + 8i its S product done, 4 + 8i its softmax
    done, 5 + 8i its PV product done, 6 + 8i every tile done, 7 + 8i the
    stores issued; slot 31 exit."""
    s = _edit(src, "namespace {\n", """namespace {
__device__ unsigned long long g_clk[16384 * 32];
__device__ unsigned long long g_gt[8192 * 2];
__device__ int g_sm[8192];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); return t;
}
__device__ __forceinline__ int smid() { int s; asm volatile("mov.u32 %0, %smid;" : "=r"(s)); return s; }
""")
    s = _edit(s, "  const int lane = tid % 32;\n  const int g = blockIdx.x;\n", """  const int lane = tid % 32;
  const int bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const bool tr = wtid == 0 && bid < 8192;
  unsigned long long* const clk = g_clk + 32 * (2 * bid + wg);
  if (tr) { clk[0] = clock64(); if (wg == 0) { g_gt[2 * bid] = gtimer(); g_sm[bid] = smid(); } }
  const int g = blockIdx.x;
""")
    stamp = lambda slot, cond="": f"    if (tr && it < 3{cond}) clk[{slot} + 8 * it] = clock64();\n"
    s = _edit(s, "    mbar_wait(q_bar + 8 * (kMaxQBufs * wg + buf), (it / q_bufs) & 1);\n",
              "    mbar_wait(q_bar + 8 * (kMaxQBufs * wg + buf), (it / q_bufs) & 1);\n" + stamp(1))
    s = _edit(s, "      const uint32_t kt = ks + slot * kKVBytes;\n",
              "  " + stamp(2, " && t == ta") + "      const uint32_t kt = ks + slot * kKVBytes;\n")
    s = _edit(s, "      wgmma_wait_all();\n      pin(s);\n",
              "      wgmma_wait_all();\n      pin(s);\n" + "  " + stamp(3, " && t == ta"))
    s = _edit(s, "      pin(acc);\n      wgmma_fence();\n",
              "  " + stamp(4, " && t == ta") + "      pin(acc);\n      wgmma_fence();\n")
    s = _edit(s, "      wgmma_wait_all();\n      pin(acc);\n",
              "      wgmma_wait_all();\n      pin(acc);\n" + "  " + stamp(5, " && t == ta"))
    s = _edit(s, "    if (ta >= tb && o_bufs && m_next < n_m) {  // an M tile that saw no key\n",
              stamp(6) + "    if (ta >= tb && o_bufs && m_next < n_m) {  // an M tile that saw no key\n")
    s = _edit(s, "      bulk_commit();\n    }\n", "      bulk_commit();\n    }\n" + stamp(7))
    s = _edit(s, "  if (leader) bulk_wait();",
              "  if (tr) { clk[31] = clock64(); atomicMax(&g_gt[2 * bid + 1], gtimer()); }\n"
              "  if (leader) bulk_wait();")
    return s + """
extern "C" int flash_study_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_clk);
  cudaMemset(p, 0, sizeof(g_clk));
  cudaGetSymbolAddress(&p, g_gt);
  return (int)cudaMemset(p, 0, sizeof(g_gt));
}
extern "C" int flash_study_trace(void* clk, void* gt, void* sm) {
  cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));
  cudaMemcpyFromSymbol(gt, g_gt, sizeof(g_gt));
  return (int)cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));
}
template <int HD, int kKeys, int kWG>
int occupancy_of(int smem) {
  auto k = v4::flash_attention_kernel<HD, kKeys, kWG>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, 128 * kWG, smem);
  return n;
}
extern "C" int flash_study_occupancy(int hd, int wgs, int smem) {
  if (hd == 64) return wgs == 1 ? occupancy_of<64, 64, 1>(smem) : occupancy_of<64, 64, 2>(smem);
  if (hd == 128) return wgs == 1 ? occupancy_of<128, 64, 1>(smem) : occupancy_of<128, 64, 2>(smem);
  if (hd == 256) return wgs == 1 ? occupancy_of<256, 32, 1>(smem) : occupancy_of<256, 32, 2>(smem);
  return -1;
}
"""


PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// each block copies `rounds` rounds of 8 16-byte pieces a thread from src
// (wrapping at n_pieces) into shared memory, two rounds in flight
__global__ void fill_probe(const uint4* __restrict__ src, long long n_pieces, int rounds,
                           unsigned* sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int per_round = blockDim.x * 8;
  const long long start = (long long)blockIdx.x * rounds * per_round;
  for (int r = 0; r < rounds; ++r) {
    for (int i = 0; i < 8; ++i) {
      const int e = i * blockDim.x + threadIdx.x;
      const long long idx = (start + (long long)r * per_round + e) % n_pieces;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(base + ((r & 1) * per_round + e) * 16), "l"(src + idx));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) sink[blockIdx.x] = *reinterpret_cast<const unsigned*>(smem);
}
extern "C" int fill_probe_launch(const void* src, long long n_pieces, int rounds, void* sink,
                                 int blocks, int threads, void* stream) {
  const int smem = 2 * threads * 8 * 16;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fill_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fill_probe<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint4*)src, n_pieces, rounds, (unsigned*)sink);
  return (int)cudaGetLastError();
}
"""


def build(sources: dict, workdir: Path, ptxas: bool = False) -> dict:
    """name -> (ctypes library, compiler output), one ``nvcc`` per source,
    all started together."""
    procs = {}
    for name, src in sources.items():
        stem = workdir / re.sub(r"\W+", "_", name)
        stem.with_suffix(".cu").write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas else ()),
               "-o", str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        procs[name] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = (ctypes.CDLL(str(stem.with_suffix(".so"))), log)
    return libs


def entry_of(lib, argtypes):
    fn = lib.flash_attention_launch
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def inputs(dev, shapes: dict) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (B, S, H, G, hd, w) in shapes.items():
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev).to(torch.bfloat16)
                   for n in (H, G, G))
        out[name] = (q, k, v, w)
    return out


def launcher(fn, q, k, v, window, legacy: bool = False, changes=None):
    """One launch of entry ``fn`` on (q, k, v): this tree's convention (the
    wrapper's tiling, or ``cut`` with ``changes`` to the rule's arguments,
    no pad), or with ``legacy`` the earlier 15-argument entry as its wrapper
    called it (pad to the template head dim, slice)."""
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    tpl = fa.template_hd(hd)
    tl = fa.tiling(B, S, T, H, G, hd, q.dtype, True, window)
    if changes is not None:                  # v4, at every group ratio
        tl = fa.grouped(B, S, T, H, G, hd, q.dtype, True, window)
        rule = {"wgs": tl.warpgroups, "chunk_scale": 2 if tl.streaming_blocks else 1}
        if changes:
            tl = fa.cut(B, S, T, H, G, hd, q.dtype, True, window, **{**rule, **changes})

    def call():
        qq, kk, vv = (F.pad(t, (0, tpl - hd)) for t in (q, k, v)) if legacy and tpl != hd else (q, k, v)
        o = torch.empty_like(qq)
        head = (qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(), B, S, H, T, G)
        if legacy:
            err = fn(*head, tpl, 1, window, 1, scale, stream)
        else:
            err = fn(*head, hd, 1, window, fa.DESIGNS[tl.kernel], scale, tl.chunk_pos, tl.slots,
                     tl.q_bufs, tl.o_bufs, tl.warpgroups, tl.smem_bytes, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return o[..., :hd] if o.shape[-1] != hd else o
    return call


def events_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def sdpa_call(q, k, v, window):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if 0 < window < q.shape[1]:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)


def run_variants(dev, workdir: Path) -> None:
    data = inputs(dev, TABLE_SHAPES)
    print("clone of q: " + "; ".join(f"{n} {events_ms(lambda: d[0].clone()):.4f} ms"
                                       for n, d in data.items()), flush=True)
    libs = build(variants(SOURCE.read_text()), workdir, ptxas=True)
    ours = False                         # ptxas lines of the v4 kernels: name, then its numbers
    for line in libs["as is"][1].splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            ours = "v4" in line and "flash_attention_kernel" in line
        if ours:
            print(f"ptxas: {line.strip()}")
    argtypes = _build.KERNELS["flash_attention"][1]
    base = {}
    runs = [(name, lib, None) for name, (lib, _) in libs.items()]
    # the source probes edit v4: run them where the rule picks v3 too
    runs = [(n, lib, None if n == "as is" else {}) for n, lib, _ in runs]
    runs += [(name, libs["as is"][0], changes) for name, changes in TILINGS.items()]
    for name, lib, changes in runs:
        cols = []
        for shape, (q, k, v, w) in data.items():
            call = launcher(entry_of(lib, argtypes), q, k, v, w, changes=changes)
            try:
                out = call()
            except RuntimeError as err:          # a tiling the entry refuses at this shape
                cols.append(f"{shape} refused ({err})")
                continue
            torch.cuda.synchronize()
            base.setdefault(shape, out.clone())
            diff = float((out.float() - base[shape].float()).abs().max())
            cols.append(f"{shape} {events_ms(call):.4f} ms (max diff from 'as is' {diff:.3g})")
        print(f"{name:24s}: " + "; ".join(cols), flush=True)


def run_timeline(dev, workdir: Path) -> None:
    lib = build({"timeline": timeline_source(SOURCE.read_text())}, workdir)["timeline"][0]
    lib.flash_study_trace.argtypes = [ctypes.c_void_p] * 3
    argtypes = _build.KERNELS["flash_attention"][1]
    phases = (("Q landed", 0, 1), ("tile 0 landed", 1, 2), ("S0", 2, 3), ("softmax 0", 3, 4),
              ("PV 0", 4, 5), ("other tiles", 5, 6), ("epilogue", 6, 7))
    for shape, (q, k, v, w) in inputs(dev, {n: SHAPES[n] for n in TIMELINE_SHAPES}).items():
        B, S, H, hd = q.shape
        tl = fa.tiling(B, S, k.shape[1], H, k.shape[2], hd, q.dtype, True, w)
        call = launcher(entry_of(lib, argtypes), q, k, v, w)
        call()
        torch.cuda.synchronize()
        lib.flash_study_reset()
        call()
        torch.cuda.synchronize()
        clk = np.zeros(16384 * 32, np.uint64)
        gt = np.zeros(8192 * 2, np.uint64)
        sm = np.zeros(8192, np.int32)
        lib.flash_study_trace(clk.ctypes.data, gt.ctypes.data, sm.ctypes.data)
        nb = min(8192, int(np.prod(tl.grid)))
        clk = clk[:nb * 64].reshape(nb * 2, 32).astype(np.int64)[:nb * tl.threads // 128 * 2]
        if tl.threads == 128:                    # one warpgroup a block: rows 2 bid
            clk = clk[::2]
        gt = gt[:nb * 2].reshape(nb, 2).astype(np.int64)
        sm = sm[:nb]
        print(f"== {shape}: grid {tl.grid}, {nb} blocks over {len(np.unique(sm))} SMs, smem "
              f"{tl.smem_bytes} B, {lib.flash_study_occupancy(tl.template_hd, tl.warpgroups, tl.smem_bytes)} "
              f"blocks an SM (occupancy), span {(gt[:, 1].max() - gt[:, 0].min()) / 1e3:.1f} us "
              f"(globaltimer)")
        live = clk[clk[:, 1] > 0]
        print(f"  warpgroups with an M tile: {len(live)}; lifetime median "
              f"{np.median(live[:, 31] - live[:, 0]):.0f} cycles")
        for i in range(2):
            c = live[live[:, 1 + 8 * i] > 0]
            parts = []
            for label, a, b in phases:
                a_slot = 0 if (i == 0 and a == 0) else (a + 8 * i if a else 7 + 8 * (i - 1))
                ok = (c[:, b + 8 * i] > 0) & (c[:, a_slot] > 0)
                if ok.any():
                    parts.append(f"{label} {np.median(c[ok, b + 8 * i] - c[ok, a_slot]):.0f}")
            print(f"  M tile {i} ({len(c)} warpgroups): " + "; ".join(parts))
        most = []
        for s_ in np.unique(sm):
            ev = sorted([(a, 1) for a in gt[sm == s_, 0]] + [(b, -1) for b in gt[sm == s_, 1]])
            cur = top = 0
            for _, d in ev:
                cur += d
                top = max(top, cur)
            most.append(top)
        print(f"  most blocks resident on one SM at once: {max(most)} (median {np.median(most):.0f})")


def run_probe(dev, workdir: Path) -> None:
    lib = build({"probe": PROBE_SOURCE}, workdir)["probe"][0]
    fn = lib.fill_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty(8 * sms, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, nbytes in (("L2-resident 16 MB", 16 << 20), ("device memory 2 GB", 2 << 30)):
        buf = torch.ones(nbytes // 4, dtype=torch.int32, device=dev)
        buf.sum()                                    # read once: the small one stays in L2
        for threads in (128, 256, 512):
            for per_sm in (1, 2):
                blocks = sms * per_sm
                rounds = (8 << 20) // (threads * 8 * 16)     # 8 MB a block
                total = blocks * rounds * threads * 8 * 16

                def call():
                    err = fn(buf.data_ptr(), nbytes // 16, rounds, sink.data_ptr(), blocks,
                             threads, stream)
                    if err:
                        raise RuntimeError(f"probe launch failed: CUDA error {err}")
                ms = events_ms(call, reps=5, inner=3)
                rows.append({"buffer": label, "threads": threads, "blocks_per_sm": per_sm,
                             "ms": ms, "tb_per_s": total / ms / 1e9})
                print(json.dumps(rows[-1]), flush=True)
        del buf
    best = {lab: max(r["tb_per_s"] for r in rows if r["buffer"] == lab)
            for lab in {r["buffer"] for r in rows}}
    print(json.dumps({"probe_best_tb_per_s": best}))


def run_against(dev, other: Path, workdir: Path) -> None:
    spec = importlib.util.spec_from_file_location(
        "other_build", other / "src" / "repro_torch" / "kernels" / "_build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    other_args = other_build.KERNELS["flash_attention"][1]
    legacy = len(other_args) == 15
    libs = build({"this": SOURCE.read_text(),
                  "other": (other / "src" / "repro_torch" / "csrc" / "flash_attention.cu").read_text()},
                 workdir)
    this_fn = entry_of(libs["this"][0], _build.KERNELS["flash_attention"][1])
    other_fn = entry_of(libs["other"][0], other_args)
    for shape, (q, k, v, w) in inputs(dev, TABLE_SHAPES).items():
        calls = {"other": launcher(other_fn, q, k, v, w, legacy=legacy),
                 "this": launcher(this_fn, q, k, v, w)}
        a, b = calls["this"](), calls["other"]()
        torch.cuda.synchronize()
        row = {"shape": shape, "this_vs_other_max_diff": float((a.float() - b.float()).abs().max()),
               "other_ms": [], "this_ms": []}
        for side in ("other", "this", "this", "other"):
            row[f"{side}_ms"].append(events_ms(calls[side]))
        row["sdpa_ms"] = events_ms(sdpa_call(q, k, v, w))
        B, S, H, hd = q.shape
        row["byte_bound_ms"] = (2 * q.numel() + 2 * k.numel()) * 2 / HBM_BYTES_PER_S * 1e3
        tl = fa.tiling(B, S, k.shape[1], H, k.shape[2], hd, q.dtype, True, w)
        row["tiling"] = {"grid": tl.grid, "chunk_pos": tl.chunk_pos, "slots": tl.slots,
                         "smem_bytes": tl.smem_bytes, "fill_over_device": tl.fill_bytes / tl.device_bytes}
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--timeline", action="store_true", help="phase stamps instead of variants")
    mode.add_argument("--probe", action="store_true", help="the shared-memory fill rate")
    mode.add_argument("--against", metavar="DIR", type=Path,
                      help="time this kernel beside checkout DIR's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        if args.timeline:
            run_timeline(dev, Path(tmp))
        elif args.probe:
            run_probe(dev, Path(tmp))
        elif args.against:
            run_against(dev, args.against, Path(tmp))
        else:
            run_variants(dev, Path(tmp))


if __name__ == "__main__":
    main()
