"""Build the port's native libraries at first use and load them by ctypes.

Each CUDA library is compiled from ``adfmsl_torch/csrc`` with nvcc into a
plain-C shared object for ``sm_90a`` (no PyTorch headers, so a build takes
seconds); the host library of the audio decoder (``HOST_LIBRARIES``) is
compiled with the host's C++ compiler (``$CXX``, else ``g++``). Both land
under ``adfmsl_torch/_build/``, which git ignores. The directory name carries
a hash of the sources, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source builds anew and an unchanged one is reused. A diagnostic
variant of a library (``defines``, passed to the compiler as ``-D``) builds
beside it under a key of its own. A failed build raises with the compiler's
log. Nothing here runs at import time.
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
             "sinc_bn_act": ("sinc_bn_act.cu",),
             "lfcc_fused": ("lfcc_fused.cu",),
             "wavlm_attention": ("wavlm_attention.cu",)}
# Host libraries (built with the C++ compiler, not nvcc): name -> sources.
# adfmsl's io_native/src/Makefile flags, without -march=native: the cache key
# does not name the host.
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra"]
HOST_LIBRARIES = {"adfmsl_torch_io": ("audio_decode.cc",)}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from adfmsl_torch/csrc at first use")


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(name: str, defines: tuple = ()) -> Path:
    """Compile the sources of library ``name`` (with ``-D`` each of
    ``defines``) into lib<name>.so unless an identical build exists; returns
    its path. The compiler's output (for nvcc its -Xptxas -v resource report)
    is kept beside it as build.log."""
    host = name in HOST_LIBRARIES
    sources = HOST_LIBRARIES[name] if host else LIBRARIES[name]
    flags = [*(HOST_FLAGS if host else NVCC_FLAGS), *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(" ".join(flags).encode())
    headers = () if host else sorted(p.name for p in CSRC.glob("*.cuh"))
    for s in (*sources, *headers):
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    out_dir = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    compiler = _cxx() if host else _nvcc()
    cmd = [compiler, *flags, "-o", tmp, *[str(CSRC / s) for s in sources],
           *(["-lpthread"] if host else [])]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:                   # the compiler itself is missing
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {compiler} to build {name}: {e}") from e
    secs = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        f"{' '.join(cmd)}\n# {secs:.2f} s, exit {proc.returncode}\n"
        f"{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(compiler).name} failed for {name}:\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)                   # atomic: concurrent builds agree
    return lib


def build_all() -> dict:
    """Build every library at once, one compiler process each; name -> path."""
    names = [*LIBRARIES, *HOST_LIBRARIES]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(library_path, names)))


@functools.lru_cache(maxsize=None)
def load_library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load once per process."""
    return ctypes.CDLL(str(library_path(name, defines)))
