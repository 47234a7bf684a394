"""Build the port's CUDA kernels with nvcc at first use and load them by ctypes.

Each library is compiled from ``adfmsl_torch/csrc`` into a plain-C shared
object for ``sm_90a`` (no PyTorch headers, so a build takes seconds) under
``adfmsl_torch/_build/``, which git ignores. The directory name carries a hash
of the sources, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source builds anew and an unchanged one is reused. A diagnostic variant of a
library (``defines``, passed to nvcc as ``-D``) builds beside it under a key of
its own. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Every kernel library of the port: name -> its sources under csrc/.
LIBRARIES = {"resblock_eval": ("resblock_eval.cu",),
             "bn_relu_bwd": ("bn_relu_bwd.cu",),
             "sinc_abs_pool": ("sinc_abs_pool.cu",),
             "sinc_abs_pool_bwd": ("sinc_abs_pool_bwd.cu",),
             "lfcc_fused": ("lfcc_fused.cu",)}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from adfmsl_torch/csrc at first use")


def library_path(name: str, defines: tuple = ()) -> Path:
    """Compile the sources of library ``name`` (with ``-D`` each of
    ``defines``) into lib<name>.so unless an identical build exists; returns
    its path. The compiler's resource report (-Xptxas -v) is kept beside it as
    build.log."""
    sources = LIBRARIES[name]
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(" ".join(flags).encode())
    for s in (*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))):  # headers too
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    out_dir = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-o", tmp, *[str(CSRC / s) for s in sources]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        f"{' '.join(cmd)}\n# {secs:.2f} s, exit {proc.returncode}\n"
        f"{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)                   # atomic: concurrent builds agree
    return lib


def build_all() -> dict:
    """Build every library at once, one nvcc process each; name -> path."""
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        return dict(zip(LIBRARIES, pool.map(library_path, LIBRARIES)))


@functools.lru_cache(maxsize=None)
def load_library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load once per process."""
    return ctypes.CDLL(str(library_path(name, defines)))
