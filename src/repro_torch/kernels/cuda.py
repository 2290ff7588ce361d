"""Build, load and count the port's CUDA kernels.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``; a
library may hold several kernels (``dequantize.cu`` holds dequantize and
dequantize_mean).  Builds happen at first use, into ``build/kernels/`` at
the root of the checkout; a library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build()`` starts one ``nvcc`` per missing library,
all at once.

``nvcc`` runs with ``-Xptxas -v``; its report (registers, shared memory
and spill bytes of every entry point) is kept beside each library and
read by ``ptxas_report``.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one right
after its kernel was accepted, and nowhere else.  ``LAYOUTS`` counts the
same launches by kernel and bucket layout.

``bucket_launch`` decides how the two kernels that read whole buckets
(quantize, bucket_stats) lay a bucket out: in registers, staged in shared
memory, or read twice.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Type codes shared with csrc/common.cuh.
NORM_CODES = {"l2": 0, "linf": 1}
IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
CODE_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
MAX_LEVELS = 256
# Layout codes shared with csrc/bucket.cuh.
LAYOUT_CODES = {"regs": 0, "smem": 1, "stream": 2}
# Register-resident shapes, bucket size -> (threads, elements a thread),
# that bucket_launch picks; csrc/bucket.cuh::with_reg_shape compiles the
# same shapes.  At 8192, 512 x 16 beat 256 x 32 by 10% on an H100: both fit
# 2 blocks an SM, and twice the warps hide more of quantize's division and
# search latency.
REG_SHAPES = {1024: (128, 8), 8192: (512, 16)}
SMEM_LIMIT = 232_448   # shared memory a block may use on sm_90, bytes
STATIC_SMEM = 4_096    # kept for the kernels' own tables and barrier

# Threads of a block of the streaming kernels' persistent grids
# (dequantize, dequantize_mean; csrc/dequantize.cu): 512 ran 0.5-1% faster
# than 256 and 128 on an H100 (experiments/dequantize_variants.py).
STREAM_THREADS = 512

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel name -> (source stem, C function, its argument types)
KERNELS = {
    "quantize": ("quantize", "repro_quantize",
                 (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _P)),
    "dequantize": ("dequantize", "repro_dequantize",
                   (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P)),
    "dequantize_mean": ("dequantize", "repro_dequantize_mean",
                        (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I,
                         _P)),
    "bucket_stats": ("bucket_stats", "repro_bucket_stats",
                     (_P, _P, _P, _P, _LL, _I, _I, _I,
                      _I, _I, _I, _I, _P)),
}
# the sources, one library each, in KERNELS' order
SOURCES = tuple(dict.fromkeys(src for src, _, _ in KERNELS.values()))

LAUNCHES: collections.Counter = collections.Counter()
LAYOUTS: collections.Counter = collections.Counter()
_loaded: dict[str, ctypes._CFuncPtr] = {}
_libraries: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()
    LAYOUTS.clear()


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
    """The library built from ``csrc/<name>.cu`` (``name`` a source in
    ``SOURCES``)."""
    h = hashlib.sha256()
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source's library that is not built yet, all in
    parallel.

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
        out.with_suffix(".ptxas").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def kernel(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    fn = _loaded.get(name)
    if fn is None:
        source, symbol, argtypes = KERNELS[name]
        lib = _libraries.get(source)
        if lib is None:
            build((source,))
            lib = _libraries[source] = ctypes.CDLL(str(library_path(source)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, device: torch.device, *args,
           layout: str | None = None) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise if
    the launch was refused, count it (under ``layout`` too, if given) if
    it was accepted."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = kernel(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    if layout is not None:
        LAYOUTS[f"{name}/{layout}"] += 1


def block_threads(bucket_size: int) -> int:
    """Threads of a block that walks one bucket: a multiple of 32, at
    most 256, no more than the bucket needs."""
    return max(32, min(256, -(-bucket_size // 32) * 32))


@dataclasses.dataclass(frozen=True)
class BucketLaunch:
    """How a kernel walks (nb, bs) buckets (see csrc/bucket.cuh)."""

    layout: str        # "regs", "smem" or "stream"
    threads: int       # a block's threads
    ept: int = 0       # elements a thread holds in registers ("regs")
    smem: int = 0      # dynamic shared memory, bytes ("smem")

    def args(self) -> tuple[int, int, int, int]:
        return (LAYOUT_CODES[self.layout], self.threads, self.ept, self.smem)


def bucket_launch(bs: int, itemsize: int, ptrs: Sequence[int]
                  ) -> BucketLaunch:
    """The layout of buckets of ``bs`` values of ``itemsize`` bytes whose
    tensors start at the addresses ``ptrs`` (every tensor the kernel reads
    or writes per element).

    Registers at the sizes of ``REG_SHAPES``, when every pointer and every
    row is 16-byte aligned (the kernel loads 16-byte vectors); otherwise
    the bucket is staged in shared memory, and only a bucket larger than
    shared memory is read twice.
    """
    aligned = (bs * itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    if aligned and bs in REG_SHAPES:
        return BucketLaunch("regs", *REG_SHAPES[bs])
    smem = bs * itemsize + 16     # + room to align the bulk copy
    if smem + STATIC_SMEM <= SMEM_LIMIT:
        return BucketLaunch("smem", block_threads(bs), smem=smem)
    return BucketLaunch("stream", block_threads(bs))


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """Entry point -> registers, static shared memory, stack frame and
    spill bytes, from ``-Xptxas -v`` output."""
    out: dict[str, dict[str, int]] = {}
    props = entry = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            out.setdefault(entry, {})
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _SPILL.search(line)) and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        elif (m := _USED.search(line)) and entry is not None:
            out[entry].update(registers=int(m.group(1)),
                              smem=int(m.group(2) or 0))
    return out


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """``parse_ptxas`` of the library that holds kernel or source ``name``
    (mangled entry names)."""
    source = KERNELS[name][0] if name in KERNELS else name
    return parse_ptxas(library_path(source).with_suffix(".ptxas")
                       .read_text())


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
