"""Build the CUDA sources of ``csrc/`` with nvcc and bind them with ctypes.

Each kernel source is compiled at first use into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xptxas -v -shared -Xcompiler -fPIC \
         -o _build/lib<name>_<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of the ``csrc/`` headers it
includes (``#include "name.cuh"``, followed into the headers' own
includes) and of the flags, so an edited source or header is rebuilt.  The build goes to ``kernels/_build/`` (git-ignored).
A failed build raises with nvcc's stderr; there is no fallback.  ptxas's
report of each kernel's registers, shared memory and spills (``-Xptxas
-v``) is kept in ``ptxas_report``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "kernels", "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

# seconds spent in nvcc per library, for the build report
build_seconds: dict[str, float] = {}
# ptxas's -v report per library built by this process
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _source_bytes(path: str, seen: set[str]) -> bytes:
    """The bytes of ``path`` followed by those of each ``csrc/`` file it
    includes with quotes, recursively, each once."""
    seen.add(path)
    with open(path, "rb") as fh:
        src = fh.read()
    out = [src]
    for inc in _INCLUDE.findall(src):
        dep = os.path.join(CSRC, inc.decode())
        if dep not in seen and os.path.exists(dep):
            out.append(_source_bytes(dep, seen))
    return b"".join(out)


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (hash-named)."""
    src = _source_bytes(os.path.join(CSRC, f"{name}.cu"), set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    out = library_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (rc {r.returncode}):\n"
                f"{' '.join(cmd)}\n{r.stderr}")
        ptxas_report[name] = r.stderr
        os.replace(tmp, out)
    else:
        build_seconds.setdefault(name, 0.0)
    return ctypes.CDLL(out)
