"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source in ``src/repro_torch/csrc/`` has a plain C entry point that
launches its kernel on a given stream and returns ``cudaGetLastError()``.
:func:`build` compiles every source with ``nvcc`` into its own shared
library under ``build/repro_torch_kernels/`` at the repository root — one
``nvcc`` per source, all started together — named by a hash of the source,
every header in ``csrc/``, the flags and the compiler's ``nvcc --version``,
so an edited source or header, or another CUDA toolkit, rebuilds and an
unchanged one is reused.
Nothing is built when a module is imported: only the first launch on a
CUDA tensor (or an explicit :func:`build`) calls the compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# entry point -> ctypes argument types (pointers and the stream as c_void_p,
# strides as c_longlong, a float scalar as c_float)
KERNELS = {
    "belief_aggregate": (
        "belief_aggregate_launch", [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "mc_correctness": (
        "mc_correctness_launch", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "mc_correctness_grouped": (
        "mc_correctness_grouped_launch",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "flash_attention": (
        "flash_attention_launch",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P],
    ),
    "rglru_scan": ("rglru_scan_launch", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "mamba_scan": (
        "mamba_scan_launch",
        [_P, _P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "causal_conv1d": (
        "causal_conv1d_launch",
        [_P, _L, _L, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
}

_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@lru_cache(maxsize=None)
def nvcc_version() -> str:
    """What ``nvcc --version`` prints, read once per process; a fixed text
    where there is no compiler (then :func:`build` raises, and only the
    name of an existing library can be asked for)."""
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        return "no nvcc"
    return subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                          check=True).stdout


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: named by a hash of its source,
    of every ``csrc/*.cuh`` (name and bytes: a source may include any), of
    the flags and of the compiler's version."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build() -> Dict[str, Path]:
    """Compile every kernel that has no up-to-date library yet, in parallel.
    Returns ``{kernel name: library path}``; raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in KERNELS}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, todo[name])    # atomic: a reader never sees half a file
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def entry(name: str):
    """The ctypes entry point of kernel ``name``, building it on first use."""
    fn = _LOADED.get(name)
    if fn is None:
        lib = ctypes.CDLL(str(build()[name]))
        symbol, argtypes = KERNELS[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn
