"""ctypes binding of the native C++ CSV parser, the counterpart of
`cvaegan_tpu/data/native_csv.py`.

`native/csv_loader.cpp` (the port's copy) is built with `g++` at first use
into `cvaegan_tpu_torch/_build/` (`data/_native_build.py`).
`load_csv_native(path)` parses a headerless CSV on all cores: every cell
coerced to float32, non-numeric, empty and NaN cells 0.0, the width from
the first line, short rows zero-padded and long ones truncated.
`data.tabular.load_csv` prefers it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from cvaegan_tpu_torch.data._native_build import load_native

SOURCE = "csv_loader.cpp"


def _configure(lib: ctypes.CDLL) -> None:
    lib.csv_dims.restype = ctypes.c_int
    lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int64)]
    lib.csv_parse.restype = ctypes.c_int
    lib.csv_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                              ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64)]


def _get_lib() -> Optional[ctypes.CDLL]:
    return load_native(SOURCE, _configure)


def load_csv_native(file_path) -> np.ndarray:
    """Parse a headerless CSV into float32 `[rows, cols]`; raises
    RuntimeError where the native parser is unavailable or fails (the
    caller then takes another reader)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native CSV parser unavailable")
    path = str(file_path).encode()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    if lib.csv_dims(path, ctypes.byref(rows), ctypes.byref(cols)) != 0:
        raise RuntimeError(f"csv_dims failed for {file_path}")
    out = np.empty((rows.value, cols.value), dtype=np.float32)
    rc = lib.csv_parse(path, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       out.size, ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise RuntimeError(f"csv_parse failed ({rc}) for {file_path}")
    return out
