"""The ``mc_correctness`` kernels' cluster size and resources, on one CUDA
card, at the two path shapes:

    PYTHONPATH=src python -m repro_torch.kernels.mc_study [--variants | --timeline |
                                                           --wide | --against DIR]

Prints what ``nvcc -Xptxas -v`` reports for both libraries and for
``belief_aggregate``'s (registers, spills, stack; SASS instruction,
branch and local-memory counts), then one JSON line: the device time of a one-element
``zero_()`` (the least a launch costs) and, for each kernel at its path
shape and each cluster size (the launch's own choice, 8 blocks, the
portable limit, and 16, the non-portable one), whether it equals its plain version bit for bit, its
device ms (``torch.profiler`` kernel rows) and its ``call_ms`` (CUDA
events, host dispatch included).

``--variants``: the shared body (``csrc/mc_tie_hist.cuh``) with one edit
each, built by ``nvcc`` into a temporary directory and launched through
the C entry points on the same inputs at the launch's own cluster size; device
ms per call. Variants that skip work compute garbage: they are timing
probes, never results.

``--timeline``: the shared body built with stamps (thread 0 of every
block): ``%globaltimer`` at entry and exit, ``clock64`` at the phase
boundaries (setup, draw loop, first cluster wait, push and barrier, rank
0's combine); prints, per kernel and cluster size, the kernel's span and
entry skew in ns and the median and largest cycles of each phase.

``--wide``: the wide kernel (L > 32) of ``mc_correctness`` at L=64 K=4
and at L=40 K=1000, built as it is (class by class where K <= n masked
arms, else first voter by first voter) and with each of its two bin
loops forced; per probe and shape, whether it equals the plain version
and its device ms.

``--against DIR``: ``belief_aggregate`` and both ``mc_correctness``
libraries built from this tree's sources and from those of the checkout
DIR (another commit, unpacked), each launched at its path shape at the
launch's own cluster size, the two timed in turns; device ms per call of
each side in each round, and whether the two sides' outputs are equal.

Device time comes from ``torch.profiler`` kernel rows of traces that
bracket the timed calls with spin kernels after a pause: a trace of bare
calls loses kernel rows (see ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import _build
from . import ref

CLUSTERS = (0, 8, 16)          # 0: the launch's own choice


def ptxas_report() -> dict:
    """``-Xptxas -v`` lines of each library, built with the port's flags,
    and per kernel instance its SASS instruction count, branches and
    local-memory accesses (``cuobjdump -sass``)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("mc_correctness", "mc_correctness_grouped", "belief_aggregate"):
            so = Path(tmp) / f"{name}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                   "-o", str(so), str(_build.CSRC / f"{name}.cu")]
            log = subprocess.run(cmd, capture_output=True, text=True, check=True)
            out[name] = [line.strip() for line in (log.stdout + log.stderr).splitlines()
                         if "ptxas info" in line or "stack frame" in line]
            cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
            sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                                  text=True, check=True).stdout
            counts, fn = {}, None
            for line in sass.splitlines():
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                    counts[fn] = {"instructions": 0, "BRA": 0, "LDL/STL": 0}
                elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", line):
                    op = line.split("*/", 1)[1].strip()
                    counts[fn]["instructions"] += 1
                    counts[fn]["BRA"] += " BRA " in f" {op} "
                    counts[fn]["LDL/STL"] += bool(re.search(r"\b(LDL|STL)\b", op))
            out[name].append(json.dumps(counts))
    return out


def device_ms(fn, n: int = 50, tries: int = 3) -> float:
    """Device ms per call of ``fn``, which launches one kernel: its kernel
    rows in a ``torch.profiler`` trace of ``n`` calls between spin kernels,
    which must hold ``n`` rows. A trace that does not is taken again, up to
    ``tries`` times; then the mean kernel row of the last trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    rows = us = 0
    for _ in range(tries):
        torch.cuda.synchronize()
        time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(2000)
            for _ in range(n):
                fn()
            for _ in range(4):
                torch.cuda._sleep(2000)
            torch.cuda.synchronize()
        kept = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
                and "spin_kernel" not in e.key]
        rows = sum(e.count for e in kept)
        us = sum(e.self_device_time_total for e in kept)
        if rows == n:
            break
    if rows == 0:
        raise RuntimeError(f"{tries} profiler traces held no kernel rows")
    return us / rows / 1e3


def call_ms(fn, reps: int = 7, inner: int = 50) -> float:
    """Median over ``reps`` of the CUDA-event ms per call of ``inner``
    back-to-back calls."""
    for _ in range(3):
        fn()
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


def path_inputs(dev) -> dict:
    """name -> (shape label, the C entry point's input tensors, output shape,
    sizes, plain version): ``mc_correctness`` at GreedyLLM's first round at
    the serve defaults (T=8471, 12 one-arm candidates) and
    ``mc_correctness_grouped`` at the serial planner's miss (G=1, C=3,
    T=16384)."""
    from repro_torch.core import McXiEstimator, prng
    from repro_torch.core.mc import GroupedXiEstimator

    rng = np.random.default_rng(0)
    est = McXiEstimator(prng.key(0, dev), rng.uniform(0.3, 0.95, 12), 4, 8471, device=dev)
    masks = torch.eye(12, dtype=torch.float32, device=dev)
    single = (est._responses, masks, est._w, est._empty.reshape(1))
    g = GroupedXiEstimator(prng.key(2, dev), rng.uniform(0.3, 0.95, (1, 12)), 4, [16384],
                           device=dev)
    gm = torch.as_tensor((rng.random((1, 3, 12)) < 0.5).astype(np.float32), device=dev)
    grouped = (g.responses, gm, g.log_weights, g.empty, g.valid, g.theta_f32)
    return {
        "mc_correctness": ("T=8471 L=12 C=12 K=4", single, (12,), (12, 8471, 12, 4),
                           lambda: ref.mc_correctness_ref(*single, 4)),
        "mc_correctness_grouped": ("G=1 C=3 T=16384 L=12 K=4", grouped, (1, 3),
                                   (1, 3, 16384, 12, 4),
                                   lambda: ref.mc_correctness_grouped_ref(*grouped, 4)),
    }


def entry_point(name: str, so: Path = None):
    """Kernel ``name``'s C entry point: from the port's build, or from the
    library ``so`` (a probe)."""
    if so is None:
        return _build.entry(name)
    symbol, argtypes = _build.KERNELS[name]
    fn = getattr(ctypes.CDLL(str(so)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def launcher(fn, inputs, dev):
    """``call(cluster)``: one launch of entry point ``fn`` on ``inputs`` (a
    :func:`path_inputs` entry) at a cluster size (0: the launch's own
    choice); returns its output."""
    _, args, out_shape, sizes, _ = inputs
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(cluster: int):
        out = torch.empty(out_shape, dtype=torch.float32, device=dev)
        err = fn(*[a.data_ptr() for a in args], out.data_ptr(), *sizes, cluster, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return call


def build_probe(name: str, header: str, workdir: Path, extra: str = "") -> Path:
    """Kernel ``name``'s source with ``header`` for the shared body (and
    ``extra`` appended), built with the port's flags into ``workdir``."""
    (workdir / HEADER).write_text(header)
    (workdir / f"{name}.cu").write_text((_build.CSRC / f"{name}.cu").read_text() + extra)
    so = workdir / f"{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(workdir / f"{name}.cu")], check=True, capture_output=True, text=True)
    return so


HEADER = "mc_tie_hist.cuh"


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) < 1:
        raise ValueError(f"edit anchor not found in {HEADER}: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """name -> header source of each probe."""
    return {
        "as is": src,
        "no work: return at entry": _edit(
            src, "  cg::cluster_group cluster = cg::this_cluster();",
            "  if (T >= 0) return;\n  cg::cluster_group cluster = cg::this_cluster();"),
        "no draw work (every draw in bin 0)": _edit(
            src, "int bin = take ? draw_bin<LMAX>(rv, mask, wr, e, K) : -1;",
            "int bin = take ? 0 : -1;"),
        "row loads kept, no draw work": _edit(
            src, "int bin = take ? draw_bin<LMAX>(rv, mask, wr, e, K) : -1;",
            "int bin = take && (rv[0] ^ rv[LMAX - 1]) == 0x7654321 ? 0 : -1;"),
        "blocks of at most 512 threads": _edit(src, "lmax <= 12 ? 1024", "lmax <= 12 ? 512"),
        "blocks of at most 256 threads": _edit(src, "lmax <= 12 ? 1024", "lmax <= 12 ? 256"),
        "no cluster barriers or remote writes": _edit(_edit(_edit(_edit(
            src, 'asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");', ""),
            'asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");', ""),
            'asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");',
            "__syncthreads();"),
            "cluster.map_shared_rank(&rank_hist[rank][0], 0)", "&rank_hist[rank][0]"),
    }


STAMPS = {
    "  cluster_arrive_relaxed();            // this block has started; waited on before the push":
        "  cluster_arrive_relaxed();\n  MC_STAMP(0, mc_globaltimer());\n  MC_STAMP(1, clock64());",
    "  const float e = empty[g];\n  __syncwarp();":
        "  const float e = empty[g];\n  __syncwarp();\n  MC_STAMP(2, clock64());",
    "  __syncthreads();\n  cluster_wait_acquire();              // every block of the cluster has started":
        "  __syncthreads();\n  MC_STAMP(3, clock64());\n  cluster_wait_acquire();\n"
        "  MC_STAMP(4, clock64());",
    "  cluster_wait_acquire();              // and every other rank's\n  if (rank != 0) return;":
        "  cluster_wait_acquire();\n  MC_STAMP(5, clock64());\n"
        "  if (rank != 0) { MC_STAMP(7, mc_globaltimer()); return; }",
    "  out[(long long)g * C + c] = (float)xi;":
        "  MC_STAMP(6, clock64());\n  out[(long long)g * C + c] = (float)xi;\n"
        "  MC_STAMP(7, mc_globaltimer());",
}
STAMP_DEFS = """namespace mc {
__device__ unsigned long long mc_stamps[8 * 8192];
__device__ __forceinline__ unsigned long long mc_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace mc
#define MC_STAMP(i, v)                                                                  \\
  do {                                                                                  \\
    const unsigned b_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \\
    if (threadIdx.x == 0 && b_ < 8192) mc::mc_stamps[b_ * 8 + (i)] = (v);               \\
  } while (0)
"""
READ_STAMPS = """
extern "C" int mc_read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, mc::mc_stamps, n * sizeof(unsigned long long));
}
"""


def timeline_header(src: str) -> str:
    for old, new in STAMPS.items():
        src = _edit(src, old, new)
    anchor = "namespace mc {\n\nnamespace cg"
    return _edit(src, anchor, STAMP_DEFS + "\n" + anchor)


def run_timeline(dev) -> dict:
    """Phase stamps of both kernels at their path shapes, per cluster size."""
    inputs = path_inputs(dev)
    header = timeline_header((_build.CSRC / HEADER).read_text())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("mc_correctness", "mc_correctness_grouped"):
            so = build_probe(name, header, Path(tmp), READ_STAMPS)
            call = launcher(entry_point(name, so), inputs[name], dev)
            read_stamps = ctypes.CDLL(str(so)).mc_read_stamps
            read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
            rows = {}
            for cluster in CLUSTERS[1:]:
                blocks = cluster * int(np.prod(inputs[name][2]))
                for _ in range(3):     # the last launch's stamps are read
                    call(cluster)
                torch.cuda.synchronize()
                st = np.zeros(blocks * 8, np.uint64)
                if read_stamps(st.ctypes.data, blocks * 8):
                    raise RuntimeError("reading the stamps failed")
                st = st.reshape(blocks, 8).astype(np.int64)
                rank0 = np.arange(blocks) % cluster == 0
                phase = {"setup": st[:, 2] - st[:, 1], "draw loop": st[:, 3] - st[:, 2],
                         "first cluster wait": st[:, 4] - st[:, 3],
                         "push and barrier": st[:, 5] - st[:, 4]}
                rows[str(cluster)] = {
                    "span_ns": int(st[:, 7].max() - st[:, 0].min()),
                    "entry_skew_ns": int(st[:, 0].max() - st[:, 0].min()),
                    "cycles_median_max": {k: [int(np.median(v)), int(v.max())]
                                          for k, v in phase.items()},
                    "rank0_combine_cycles": int(np.median(st[rank0, 6] - st[rank0, 5])),
                }
            out[name] = rows
    return out


def run_variants(dev) -> dict:
    """Device ms of each probe for both kernels at their path shapes, at
    the launch's own cluster size."""
    inputs = path_inputs(dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, header) in enumerate(variants((_build.CSRC / HEADER).read_text()).items()):
            d = Path(tmp) / f"v{i}"
            d.mkdir()
            row = {}
            for name in ("mc_correctness", "mc_correctness_grouped"):
                call = launcher(entry_point(name, build_probe(name, header, d)), inputs[name], dev)
                row[name] = device_ms(lambda: call(0))
            out[label] = row
    return out


# (T, L, C, K) of the wide kernel's probes: the `kernels` line's wide row
# and phase 3's K=1000 case
WIDE_SHAPES = ((8471, 64, 12, 4), (8471, 40, 8, 1000))
BY_CLASS = "const bool by_class = K <= n;"


def run_wide(dev) -> dict:
    """Device ms of the wide kernel at WIDE_SHAPES, as it is and with each
    bin loop forced, and whether each equals the plain version."""
    rng = np.random.default_rng(7)
    cases = {}
    for T, L, C, K in WIDE_SHAPES:
        args = (torch.as_tensor(rng.integers(-1, K, (T, L)), dtype=torch.int32, device=dev),
                torch.as_tensor((rng.random((C, L)) < 0.5).astype(np.float32), device=dev),
                torch.as_tensor(rng.uniform(0.3, 3.0, L), dtype=torch.float32, device=dev),
                torch.tensor([-1.0], dtype=torch.float32, device=dev))
        cases[f"T={T} L={L} C={C} K={K}"] = (
            "", args, (C,), (C, T, L, K), lambda args=args, K=K: ref.mc_correctness_ref(*args, K))
    src = (_build.CSRC / HEADER).read_text()
    probes = {"as is": src,
              "class by class only": _edit(src, BY_CLASS, "const bool by_class = true;"),
              "first voter only": _edit(src, BY_CLASS, "const bool by_class = false;")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, header) in enumerate(probes.items()):
            d = Path(tmp) / f"w{i}"
            d.mkdir()
            fn = entry_point("mc_correctness", build_probe("mc_correctness", header, d))
            row = {}
            for shape, inputs in cases.items():
                call = launcher(fn, inputs, dev)
                row[shape] = {"bitwise": bool(torch.equal(call(0), inputs[4]())),
                              "ms": device_ms(lambda: call(0), n=20)}
            out[label] = row
    return out


def build_from(csrc: Path, name: str, workdir: Path) -> Path:
    """Kernel ``name``'s library built from the sources in ``csrc`` with the
    port's flags into ``workdir``."""
    workdir.mkdir(parents=True, exist_ok=True)
    so = workdir / f"{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(csrc / f"{name}.cu")], check=True, capture_output=True, text=True)
    return so


def run_against(dev, other: Path, rounds: int = 3) -> dict:
    """Device ms per call of this tree's and checkout ``other``'s
    libraries at the path shapes, in turns (other first), ``rounds`` each,
    and whether the two sides' outputs are equal."""
    inputs = path_inputs(dev)
    rng = np.random.default_rng(5)
    B, M, K = 704, 10, 4               # the router's prefix-expanded rows
    resp = torch.as_tensor(rng.integers(-1, K, (B, M)), dtype=torch.int32, device=dev)
    w = torch.as_tensor(rng.uniform(0.3, 3.0, (B, M)), dtype=torch.float32, device=dev)
    empty = torch.as_tensor(rng.uniform(-3.0, -0.5, B), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def belief(fn):
        bel = torch.empty((B, K), dtype=torch.float32, device=dev)
        pred = torch.empty((B,), dtype=torch.int32, device=dev)

        def call():                    # one launch into its own outputs
            err = fn(resp.data_ptr(), w.data_ptr(), empty.data_ptr(), bel.data_ptr(),
                     pred.data_ptr(), B, M, K, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return bel, pred
        return call

    calls = {}
    with tempfile.TemporaryDirectory() as tmp:
        for side, csrc in (("other", other / "src" / "repro_torch" / "csrc"),
                           ("this", _build.CSRC)):
            for name in ("belief_aggregate", "mc_correctness", "mc_correctness_grouped"):
                fn = entry_point(name, build_from(csrc, name, Path(tmp) / side))
                if name == "belief_aggregate":
                    calls[side, name] = belief(fn)
                else:
                    run = launcher(fn, inputs[name], dev)
                    calls[side, name] = lambda run=run: (run(0),)
        out = {}
        for name in ("belief_aggregate", "mc_correctness", "mc_correctness_grouped"):
            mine, theirs = calls["this", name](), calls["other", name]()
            row = {"equal": all(torch.equal(a, b) for a, b in zip(mine, theirs)),
                   "other_ms": [], "this_ms": []}
            for _ in range(rounds):
                for side in ("other", "this"):
                    row[f"{side}_ms"].append(device_ms(calls[side, name]))
            out[name] = row
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="time single-edit probes of the shared body")
    parser.add_argument("--timeline", action="store_true",
                        help="stamp the shared body's phases")
    parser.add_argument("--wide", action="store_true",
                        help="time the wide kernel's bin loops")
    parser.add_argument("--against", metavar="DIR", type=Path,
                        help="time the kernels beside those of the checkout DIR")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mc_study: needs a CUDA device")
    dev = torch.device("cuda", 0)
    if opts.wide:
        print(json.dumps({"device": torch.cuda.get_device_name(0), "wide_ms": run_wide(dev)}))
        return
    if opts.against:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "against": str(opts.against),
                          "kernels": run_against(dev, opts.against)}))
        return
    if opts.timeline:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "timeline": run_timeline(dev)}))
        return
    if opts.variants:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "variants_ms": run_variants(dev)}))
        return
    for name, lines in ptxas_report().items():
        print(f"[ptxas {name}]")
        for line in lines:
            print(f"  {line}")
    one = torch.zeros(1, device=dev)
    result = {"device": torch.cuda.get_device_name(0),
              "launch_floor_ms": device_ms(lambda: one.zero_())}
    for name, inputs in path_inputs(dev).items():
        shape, plain = inputs[0], inputs[4]
        kernel = launcher(entry_point(name), inputs, dev)
        want = plain()
        rows = {}
        for c in CLUSTERS:
            got = kernel(c)
            torch.cuda.synchronize()
            rows[str(c)] = {"bitwise": bool(torch.equal(got, want)),
                            "ms": device_ms(lambda: kernel(c)),
                            "call_ms": call_ms(lambda: kernel(c))}
        result[name] = {"shape": shape, "by_cluster": rows}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
