"""Build a CUDA source of the port into a shared library and load it.

Each source under `cvaegan_tpu_torch/csrc/` exposes a plain C interface.
At first use it is compiled with `nvcc` for `sm_90a` into
`cvaegan_tpu_torch/_build/` (listed in `.gitignore`), named by a hash of
the source, the shared headers (`csrc/*.cuh`) and the flags so that an
edited source or header is rebuilt, and loaded with
`ctypes`. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is "
                           "needed to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> pathlib.Path:
    """Where the library built from `csrc/<source>` lives: named by a hash
    of the source, every header under `csrc/` and the flags, so that an
    edited header rebuilds every source."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> pathlib.Path:
    """Compile `csrc/<source>` unless its library exists. Returns the
    library's path; raises with the compiler's output on failure. The
    compiler's report (registers, shared memory, spills) is kept beside
    the library as `<name>.log`."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of `csrc/<source>`."""
    return ctypes.CDLL(str(build(source)))
