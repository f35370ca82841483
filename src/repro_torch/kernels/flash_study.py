"""Where the bf16 ``flash_attention`` kernel (v3) spends its time, on one
CUDA card, at the LM arms' two path shapes:

    PYTHONPATH=src python -m repro_torch.kernels.flash_study [--timeline]

Variants: the kernel's source with one edit each, built by ``nvcc`` into a
temporary directory and launched through the C entry point on the same
inputs; device ms per call from a ``torch.profiler`` trace. Variants that
skip work compute garbage: they are timing probes, never results. A copy
of q (``clone``) is timed beside them as the device-memory floor of
reading Q and writing O.

``--timeline``: the kernel built with ``clock64`` stamps at its phase
boundaries (thread 0 of every block) and ``%globaltimer`` at entry and
exit; prints the median cycles of each phase for the short (first) and
long (second) query tile, the blocks resident per SM and the occupancy the
runtime reports.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC / "flash_attention.cu"
# name: (B, S, H, G, hd, window), the LM-arm route's two shapes
SHAPES = {"recurrentgemma": (64, 127, 16, 1, 256, 2048), "smollm": (64, 127, 9, 3, 64, 0)}


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"edit anchor not found once in {SOURCE.name}: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """name -> source of each probe."""
    e = lambda old, new: _edit(src, old, new)
    return {
        "as is": src,
        "divide in the epilogue": _edit(
            e("    inv[r] = 1.0f / fmaxf(l, 1e-30f);", "    inv[r] = fmaxf(l, 1e-30f);"),
            "pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);\n"
            "    *reinterpret_cast<uint32_t*>(q_ptr + L::at(kRows, wr + 8, col)) =\n"
            "        pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);",
            "pack_bf16(acc[4 * j] / inv[0], acc[4 * j + 1] / inv[0]);\n"
            "    *reinterpret_cast<uint32_t*>(q_ptr + L::at(kRows, wr + 8, col)) =\n"
            "        pack_bf16(acc[4 * j + 2] / inv[1], acc[4 * j + 3] / inv[1]);"),
        "no tiles (Q in, O out)": e("  const int n_tiles = k_hi > k_lo ?",
                                    "  const int n_tiles = false && k_hi > k_lo ?"),
        "no Q load": e("    cp_async16(qs + L::at(kRows, r, c),",
                       "    if (false) cp_async16(qs + L::at(kRows, r, c),"),
        "no S wgmma": e("      Wgmma<kKeys>::ss(", "      if (false) Wgmma<kKeys>::ss("),
        "no PV wgmma": e("      Wgmma<HD>::rs(", "      if (false) Wgmma<HD>::rs("),
        "no O store": e("    if (row < S)\n      *reinterpret_cast<uint4*>",
                        "    if (row < 0)\n      *reinterpret_cast<uint4*>"),
    }


def timeline_source(src: str) -> str:
    """The kernel with phase stamps: slot 0 entry, 1 + 4i tile i landed,
    2 + 4i its S product done, 3 + 4i its softmax done, 4 + 4i its PV
    product done (i < 3), 13 the tiles done, 14 the epilogue begun, 15 the
    block's stores issued."""
    s = _edit(src, "namespace {\n", """namespace {
__device__ unsigned long long g_clk[8192 * 16];
__device__ unsigned long long g_gt[8192 * 2];
__device__ int g_sm[8192];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); return t;
}
__device__ __forceinline__ int smid() { int s; asm volatile("mov.u32 %0, %smid;" : "=r"(s)); return s; }
""")
    s = _edit(s, "  using L = Tile<HD>;\n", """  using L = Tile<HD>;
  const int bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const bool tr = threadIdx.x == 0 && bid < 8192;
  if (tr) { g_gt[2 * bid] = gtimer(); g_sm[bid] = smid(); g_clk[16 * bid] = clock64(); }
""")
    stamp = lambda slot: f"    if (tr && it < 3) g_clk[16 * bid + {slot} + 4 * it] = clock64();\n"
    s = _edit(s, "    __syncthreads();                   // ... for every thread's pieces\n",
              "    __syncthreads();                   // ... for every thread's pieces\n" + stamp(1))
    s = _edit(s, "    wgmma_wait_all();\n    pin(s);\n", "    wgmma_wait_all();\n    pin(s);\n" + stamp(2))
    s = _edit(s, "    pin(acc);\n    wgmma_fence();\n", stamp(3) + "    pin(acc);\n    wgmma_fence();\n")
    s = _edit(s, "    pin(acc);\n    __syncthreads();", "    pin(acc);\n" + stamp(4) + "    __syncthreads();")
    s = _edit(s, "  cp_async_wait<0>();                  // Q's copy",
              "  if (tr) g_clk[16 * bid + 13] = clock64();\n  cp_async_wait<0>();                  // Q's copy")
    s = _edit(s, "  const int wr = warp * 16 + lane / 4;\n",
              "  if (tr) g_clk[16 * bid + 14] = clock64();\n  const int wr = warp * 16 + lane / 4;\n")
    s = _edit(s, """          *reinterpret_cast<const uint4*>(q_ptr + L::at(kRows, warp * 16 + r, c));
  }
}""", """          *reinterpret_cast<const uint4*>(q_ptr + L::at(kRows, warp * 16 + r, c));
  }
  __syncthreads();
  if (tr) { g_clk[16 * bid + 15] = clock64(); g_gt[2 * bid + 1] = gtimer(); }
}""")
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
template <int HD, int kKeys>
int occupancy_of() {
  constexpr int smem = (v3::kRows + 4 * kKeys) * HD * 2 + 1024;
  auto k = v3::flash_attention_kernel<HD, kKeys>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, v3::kThreads, smem);
  return n;
}
extern "C" int flash_study_occupancy(int hd) {
  return hd == 256 ? occupancy_of<256, 32>() : occupancy_of<64, 64>();
}
"""


def build(sources: dict, workdir: Path) -> dict:
    """name -> ctypes library, one ``nvcc`` per source, all started together."""
    procs = {}
    for name, src in sources.items():
        stem = workdir / re.sub(r"\W+", "_", name)
        stem.with_suffix(".cu").write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
               str(stem.with_suffix(".cu"))]
        procs[name] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(stem.with_suffix(".so")))
        fn = libs[name].flash_attention_launch
        fn.argtypes = _build.KERNELS["flash_attention"][1]
        fn.restype = ctypes.c_int
    return libs


def inputs(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (B, S, H, G, hd, w) in SHAPES.items():
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev).to(torch.bfloat16)
                   for n in (H, G, G))
        out[name] = (q, k, v, torch.empty_like(q), w)
    return out


def launcher(lib, q, k, v, o, window):
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, T, G, hd, 1,
            window, 1, stream)

    def call():
        err = lib.flash_attention_launch(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def device_ms(fn, n: int = 30) -> float:
    """Device ms per call: the kernel rows of a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / n / 1e3


def run_variants(dev, workdir: Path) -> None:
    data = inputs(dev)
    print("clone of q: " + "; ".join(f"{n} {device_ms(lambda: d[0].clone()):.4f} ms"
                                       for n, d in data.items()), flush=True)
    libs = build(variants(SOURCE.read_text()), workdir)
    base = {}
    for name, lib in libs.items():
        cols = []
        for shape, (q, k, v, o, w) in data.items():
            call = launcher(lib, q, k, v, o, w)
            call()
            torch.cuda.synchronize()
            base.setdefault(shape, o.clone())
            diff = float((o.float() - base[shape].float()).abs().max())
            cols.append(f"{shape} {device_ms(call):.4f} ms (max diff from 'as is' {diff:.3g})")
        print(f"{name:24s}: " + "; ".join(cols), flush=True)


def run_timeline(dev, workdir: Path) -> None:
    lib = build({"timeline": timeline_source(SOURCE.read_text())}, workdir)["timeline"]
    print(f"blocks an SM (occupancy): hd=256 {lib.flash_study_occupancy(256)}, "
          f"hd=64 {lib.flash_study_occupancy(64)}")
    phases = (("entry -> tile 0 landed", 0, 1), ("S0", 1, 2), ("softmax 0", 2, 3), ("PV 0", 3, 4),
              ("tile 1 landed", 4, 5), ("S1", 5, 6), ("softmax 1", 6, 7), ("PV 1", 7, 8),
              ("epilogue", 14, 15))
    for shape, (q, k, v, o, w) in inputs(dev).items():
        call = launcher(lib, q, k, v, o, w)
        call()
        torch.cuda.synchronize()
        lib.flash_study_reset()
        call()
        torch.cuda.synchronize()
        clk = np.zeros(8192 * 16, np.uint64)
        gt = np.zeros(8192 * 2, np.uint64)
        sm = np.zeros(8192, np.int32)
        lib.flash_study_trace(clk.ctypes.data, gt.ctypes.data, sm.ctypes.data)
        tiles = (q.shape[1] + 63) // 64
        nb = tiles * q.shape[2] * q.shape[0]
        clk = clk[:nb * 16].reshape(nb, 16).astype(np.int64)
        gt = gt[:nb * 2].reshape(nb, 2).astype(np.int64)
        sm = sm[:nb]
        print(f"== {shape}: {nb} blocks over {len(np.unique(sm))} SMs, "
              f"span {(gt[:, 1].max() - gt[:, 0].min()) / 1e3:.1f} us (globaltimer)")
        for qt in range(tiles):
            c = clk[np.arange(nb) % tiles == qt]
            parts = [f"{label} {np.median(c[:, b] - c[:, a]):.0f}" for label, a, b in phases
                     if (c[:, b] > 0).all() and (c[:, a] > 0).all()]
            print(f"  query tile {qt} ({len(c)} blocks): lifetime "
                  f"{np.median(c[:, 15] - c[:, 0]):.0f} cycles; " + "; ".join(parts))
        most = []
        for s in np.unique(sm):
            ev = sorted([(a, 1) for a in gt[sm == s, 0]] + [(b, -1) for b in gt[sm == s, 1]])
            cur = top = 0
            for _, d in ev:
                cur += d
                top = max(top, cur)
            most.append(top)
        print(f"  most blocks resident on one SM at once: {max(most)} (median {np.median(most):.0f})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timeline", action="store_true", help="phase stamps instead of variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        (run_timeline if args.timeline else run_variants)(dev, Path(tmp))


if __name__ == "__main__":
    main()
