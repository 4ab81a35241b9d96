"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

The output goes to `build/repro_torch/` at the root of the checkout, built
at first use and cached by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags. `build_all` starts one nvcc for each source,
all together. Nothing here runs when the module is imported. The checks
every kernel wrapper makes before a launch live here too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {name: CSRC / f"{name}.cu" for name in (
    "ragged_decode", "fused_decode", "approx_score", "gather_attention",
    "flash_prefill", "flash_prefill_bwd")}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: List[str] = None, verbose: bool = False
              ) -> Dict[str, float]:
    """Compile every listed kernel (default: all) that is not built yet,
    one nvcc process per source, all started together. Returns the wall
    seconds each took (0.0 for a cached library); raises with nvcc's
    output when a build fails. `verbose` adds `-Xptxas -v` and prints the
    compiler's report of registers and shared memory."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, times = {}, {}
    t0 = time.monotonic()
    for name in names:
        out = library_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.monotonic() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        if verbose and log:
            print(log, end="")
        os.replace(tmp, out)
    return times


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------------
# checks shared by the kernel wrappers
# ---------------------------------------------------------------------------


def check_tensors(kernel: str, spec, dev: torch.device) -> None:
    """Raise unless every tensor of `spec` ({name: (tensor, shape, dtype)})
    has that shape and dtype and lies contiguous on the CUDA device
    `dev`."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on a CUDA tensor, got {dev}")
    for name, (t, shp, dt) in spec.items():
        if tuple(t.shape) != tuple(shp) or t.dtype != dt:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {tuple(shp)} {dt}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous on {dev}")


def check_aligned(kernel: str, *tensors) -> None:
    """Raise unless each int8 tensor starts 4-byte aligned (the kernel
    reads it in 4-byte words)."""
    if any(t.data_ptr() % 4 for t in tensors):
        raise ValueError(f"{kernel}: int8 rows must be 4-byte aligned for "
                         "the kernel's 4-byte words")


def check_copy_aligned(kernel: str, **needs) -> None:
    """Raise unless each tensor of `needs` ({name: (tensor, bytes)}) starts
    aligned to the width of the copies the kernel makes of it."""
    for name, (t, width) in needs.items():
        if t.data_ptr() % width:
            raise ValueError(f"{kernel}: {name} must start {width}-byte "
                             f"aligned for the kernel's {width}-byte copies")


def smem_limit(dev: torch.device) -> int:
    """The dynamic shared memory one block of `dev` may opt into, in
    bytes."""
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))


def check_smem(kernel: str, smem: int, dev: torch.device, what: str) -> None:
    """Raise when one CTA needs more dynamic shared memory (`smem` bytes,
    for `what`) than `dev` lets a block opt into."""
    limit = smem_limit(dev)
    if smem > limit:
        raise ValueError(f"{kernel}: {what} need {smem} bytes of shared "
                         f"memory per CTA, above the card's {limit}")


def check_launch(kernel: str, rc: int) -> None:
    """Raise when a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
