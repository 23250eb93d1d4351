"""Build hand-written CUDA sources into shared libraries, at first use.

Each source under the package's `csrc/` has a plain C entry point.  It is
compiled by `nvcc` for Hopper (`sm_90a`) into `_build/` (listed in
.gitignore), keyed by a hash of the source and the flags, and loaded with
ctypes.  Nothing here runs at import time, and nothing falls back: a
missing `nvcc` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: IEEE division and square root, full-precision math
# functions.  -fmad=false: a multiply-add is fused only where the source
# writes fmaf, which is the precision contract the kernels share with
# their plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        candidate = Path(root) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built from source at first use"
    )


def build_library(source: str) -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/<source>` (if not built yet) and load it.

    Returns (library, compiler log); the log holds `-Xptxas -v`'s
    register and spill report when this call compiled, else ""."""
    src = CSRC_DIR / source
    # the digest covers the shared headers too: a header edit rebuilds
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}"
            )
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), log
