"""Build csrc/*.cu with nvcc at first use and bind them with ctypes.

Each kernel source is one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes). Libraries are
cached under vulkan_renderer_tpu_torch/_build/ by a digest of the sources,
flags and defines, and loaded once per process. Every C entry point
launches on the stream it is given and returns cudaGetLastError(); the
wrappers raise on a nonzero code. Nothing here runs at import time.

All kernels are compiled with --fmad=false: nvcc would otherwise contract
a*b+c into FMAs, and the kernels then stop matching their plain PyTorch
versions (which round every product) on near-tie triangle edges and
sector boundaries. The one FMA they issue is written out
(csrc/techniques.cuh two_product), taken only where its error term equals
the plain version's Dekker split; outside that range the kernels run the
split itself. No -ftz and no --use_fast_math: the plain versions keep
subnormals, and so must the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBRARIES: dict[tuple, ctypes.CDLL] = {}
# name + defines -> (seconds spent in nvcc, ptxas report); for the records.
BUILD_REPORTS: dict[str, tuple[float, str]] = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _tag(name: str, defines: dict) -> str:
    return name + "".join(f"_{k}{v}" for k, v in sorted(defines.items()))


def build_library(name: str, defines: dict | None = None) -> Path:
    """Compile csrc/<name>.cu (plus the shared headers) into a cached .so."""
    defines = dict(defines or {})
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256()
    for path in [source] + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(repr((NVCC_FLAGS, sorted(defines.items()))).encode())
    tag = _tag(name, defines)
    out = BUILD_DIR / f"lib{tag}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS,
           *[f"-D{k}={v}" for k, v in sorted(defines.items())],
           "-I", str(CSRC_DIR), "-o", str(tmp), str(source)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag} (exit {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    BUILD_REPORTS[tag] = (seconds, proc.stderr + proc.stdout)
    os.replace(tmp, out)
    return out


def build_many(jobs) -> float:
    """Build several (name, defines) libraries at once, one nvcc process
    each, as many at a time as there are CPU cores; returns the wall
    seconds. A failed build raises."""
    import concurrent.futures
    start = time.perf_counter()
    workers = max(min(len(jobs), os.cpu_count() or 1), 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for future in [pool.submit(build_library, name, defines)
                       for name, defines in jobs]:
            future.result()
    return time.perf_counter() - start


def register_report(report: str) -> list[str]:
    """The ptxas lines of a build report naming each kernel instantiation
    with its registers and spills."""
    return [line.strip() for line in report.splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]


def ptxas_table(report: str) -> list[dict]:
    """One row per kernel of a build report (nvcc -Xptxas -v): the mangled
    name, registers, stack frame, spill stores and loads, and static
    shared memory in bytes."""
    rows = []
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            rows.append({"function": entry.group(1), "registers": 0,
                         "stack": 0, "spill_stores": 0, "spill_loads": 0,
                         "smem": 0})
            continue
        if not rows:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            rows[-1].update(stack=int(frame.group(1)),
                            spill_stores=int(frame.group(2)),
                            spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            rows[-1]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem"] = int(smem.group(1)) if smem else 0
    return rows


# Streaming multiprocessor limits of the H100 (sm_90).
SM_REGISTERS, SM_WARPS, SM_BLOCKS = 65536, 64, 32
SM_SHARED_BYTES, BLOCK_SHARED_RESERVED = 233472, 1024


def resident_warps(registers: int, threads: int, smem: int) -> int:
    """Theoretical warps resident on one SM for a kernel of this many
    registers a thread, block size and static shared memory: registers are
    allocated per warp in units of 256, shared memory per block with 1 KB
    reserved."""
    warps = -(-threads // 32)
    per_warp = -(-max(registers, 1) * 32 // 256) * 256
    blocks = min(SM_BLOCKS, SM_WARPS // warps,
                 SM_REGISTERS // (per_warp * warps),
                 SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVED))
    return blocks * warps


def load_library(name: str, functions: dict, defines: dict | None = None
                 ) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; `functions` maps each C
    entry point to its ctypes argtypes (every entry returns an int)."""
    key = (name, tuple(sorted((defines or {}).items())))
    lib = _LIBRARIES.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name, defines)))
        for fn, argtypes in functions.items():
            entry = getattr(lib, fn)
            entry.argtypes = argtypes
            entry.restype = ctypes.c_int
        _LIBRARIES[key] = lib
    return lib


def require_cuda(*tensors: torch.Tensor) -> None:
    """Kernel inputs must be CUDA tensors on one device (CPU tensors take
    the plain versions before reaching here)."""
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"kernel inputs must be CUDA tensors on "
                             f"{device}, got one on {t.device}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
