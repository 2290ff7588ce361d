"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Builds happen at first use, into ``build/kernels/`` at the root of the
checkout; a library's file name carries a hash of its sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
``build()`` starts one ``nvcc`` per missing library, all at once.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one right
after its kernel was accepted, and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Type codes shared with csrc/common.cuh.
NORM_CODES = {"l2": 0, "linf": 1}
IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
CODE_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
MAX_LEVELS = 256

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> (C function, its argument types)
KERNELS = {
    "quantize": ("repro_quantize",
                 (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P)),
    "dequantize": ("repro_dequantize",
                   (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P)),
    "bucket_stats": ("repro_bucket_stats",
                     (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P)),
}

LAUNCHES: collections.Counter = collections.Counter()
_loaded: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=tuple(KERNELS)) -> dict[str, float]:
    """Compile every named library that is not built yet, all in parallel.

    Returns the wall seconds of each build started (an already built
    library is not listed); raises with nvcc's output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def kernel(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    fn = _loaded.get(name)
    if fn is None:
        build((name,))
        symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise if
    the launch was refused, count it if it was accepted."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = kernel(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def block_threads(bucket_size: int) -> int:
    """Threads of a block that walks one bucket: a multiple of 32, at
    most 256, no more than the bucket needs."""
    return max(32, min(256, -(-bucket_size // 32) * 32))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
