"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by its own `nvcc` process for
`sm_90a`, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with `ctypes`. The library goes to
`build/torch_kernels/` at the repository root, named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
loaded as it is. Nothing is built when the module is imported; the first
kernel launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("flash_attention.cu", "rglru_scan.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> Optional[str]:
    """`$CUDA_HOME/bin/nvcc` (default /usr/local/cuda), else `nvcc` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    return shutil.which("nvcc")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels (if their sources changed) and return the path of
    the shared library. The compiler's per-kernel resource report (registers,
    shared memory, spills) is kept beside it as `<lib>.log`."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME to a CUDA toolkit or put nvcc on "
            "PATH; the port's kernels are built from "
            f"{CSRC} for sm_90a and have no prebuilt copy")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    lib = build_dir / f"librepro_torch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [build_dir / f"{Path(n).stem}.{tag}.o" for n in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / n), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for n, o in zip(SOURCES, objs)]
    outs = [proc.communicate()[0] for proc in procs]   # wait for every nvcc
    logs = []
    for name, proc, out in zip(SOURCES, procs, outs):
        logs.append(f"== {name}\n{out}")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode}):\n{out}")
    tmp = build_dir / f"{lib.stem}.{tag}.tmp.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs), "-ldl"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for o in objs:
        o.unlink()
    if link.returncode:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
    lib.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                              i, i, i, i, i, ctypes.c_float, i, p]
    lib.repro_flash_attention_fwd.restype = i
    lib.repro_flash_decode_blocks_per_sm.argtypes = [i, i, ctypes.POINTER(i)]
    lib.repro_flash_decode_blocks_per_sm.restype = i
    lib.repro_rglru_scan.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.repro_rglru_scan.restype = i
    return lib
