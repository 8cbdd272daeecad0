"""Build a C++ source of the port into a shared library and load it.

The CSV readers (`data/native_csv.py`, `data/streaming.py`) are the port's
own copies of the JAX package's, under `cvaegan_tpu_torch/native/`. At
first use each is compiled with `g++` into `cvaegan_tpu_torch/_build/`
(listed in `.gitignore`, shared with the CUDA libraries of
`kernels/_build.py`), named by a hash of the source, the flags and the
host's CPU (`-march=native` builds for it), so that an edited source is
rebuilt and a build directory shared by two machines serves neither the
other's library; nothing is written beside the source. Where
no C++ compiler exists, `load_native` says so in one line and returns
None, and the callers take their plain Python readers; a source that does
not compile raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Callable, Dict, Optional

from cvaegan_tpu_torch.kernels._build import BUILD_DIR, PACKAGE_DIR

NATIVE_DIR = PACKAGE_DIR / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
#: source name -> loaded library, or None where no compiler exists
_CACHE: Dict[str, Optional[ctypes.CDLL]] = {}


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (Linux), else its name."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(sorted({line for line in f
                                    if line.startswith((b"model name", b"flags"))}))
    except OSError:
        return platform.processor().encode()


def library_path(source: str):
    """Where the library built from `native/<source>` lives."""
    src = NATIVE_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_host_cpu())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _build(source: str):
    """Compile `native/<source>` unless its library exists; None where
    there is no `g++`."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(NATIVE_DIR / source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError:
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def load_native(source: str, configure: Callable[[ctypes.CDLL], None]
                ) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load `native/<source>`; `configure` declares
    its functions' argument and result types. None, said once per source,
    where no C++ compiler exists."""
    with _LOCK:
        if source in _CACHE:
            return _CACHE[source]
        path = _build(source)
        lib = None
        if path is None:
            print(f"{source}: no C++ compiler (g++) found; the plain Python "
                  "reader parses the CSV files instead")
        else:
            lib = ctypes.CDLL(str(path))
            configure(lib)
        _CACHE[source] = lib
        return lib
