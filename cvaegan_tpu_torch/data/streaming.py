"""Streaming CSV ingestion, the counterpart of `cvaegan_tpu/data/streaming.py`.

For corpora that should not be held in host memory at once (Car-Hacking
captures hold millions of frames per attack file): a C++ reader thread
(`native/stream_reader.cpp`, the port's copy, built at first use by
`data/_native_build.py`) parses fixed-size row chunks behind the
consumer, so host memory stays O(chunk) and parsing overlaps whatever the
consumer does next (a device upload, statistics, inference).

    StreamingCSV(path, chunk_rows)  float32 [rows, cols] numpy chunks;
                                    `backend` says which reader ran
    stream_minmax(path)             one-pass per-column (min, max)
    load_csv_streamed(path)         a device tensor built by chunked uploads
    prefetch_to_device(it, size)    device tensors `size` uploads ahead

Cells as in the native reader: headerless; the schema (column count) is
the first non-empty line's; every cell coerced to float, non-numeric,
empty and NaN cells 0.0; longer rows truncated, shorter ones zero-padded;
empty lines skipped. Where no C++ compiler exists a plain Python reader
gives the same cells (it splits each line on commas as the native reader
does: no quoting, which the `csv` module would apply); the JAX package
takes pandas there, which the GPU machine does not have.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import math
import os
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from cvaegan_tpu_torch.core.state import resolve_device
from cvaegan_tpu_torch.data._native_build import load_native

SOURCE = "stream_reader.cpp"


def _configure(lib: ctypes.CDLL) -> None:
    lib.stream_open.restype = ctypes.c_int64
    lib.stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.stream_cols.restype = ctypes.c_int64
    lib.stream_cols.argtypes = [ctypes.c_int64]
    lib.stream_next.restype = ctypes.c_int
    lib.stream_next.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int64)]
    lib.stream_close.restype = None
    lib.stream_close.argtypes = [ctypes.c_int64]


def _get_lib() -> Optional[ctypes.CDLL]:
    return load_native(SOURCE, _configure)


def parse_cell(cell: str) -> float:
    """One cell as the native reader's `parse_cell` (C `strtof` over the
    whole cell) reads it: spaces and tabs stripped (and a trailing
    carriage return), the rest must parse completely, else 0.0; NaN is
    0.0."""
    cell = cell.lstrip(" \t").rstrip(" \t\r")
    if not cell or not cell.isascii() or "_" in cell or cell[-1].isspace():
        return 0.0  # strtof takes no digit separators, no trailing space, ASCII only
    try:
        value = float(cell)
    except ValueError:
        body = cell.lstrip().lstrip("+-")
        if not body[:2].lower() == "0x":
            return 0.0
        try:  # strtof also reads C99 hexadecimal floats
            value = float.fromhex(cell.lstrip())
        except ValueError:
            return 0.0
    return 0.0 if math.isnan(value) else value


def _float32(rows) -> np.ndarray:
    """Rows of Python floats as float32; beyond its range a cell becomes
    inf, as `strtof` gives it."""
    with np.errstate(over="ignore"):
        return np.asarray(rows, np.float32)


def _schema(path: str) -> int:
    """Columns of the first non-empty line (a lone carriage return counts
    as empty), as `stream_open` finds them."""
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line and line != b"\r":
                return line.count(b",") + 1
    raise ValueError(f"empty csv: {path}")


class StreamingCSV:
    """Iterate float32 `[rows, cols]` chunks of a headerless CSV.

    The native background reader where a C++ compiler exists, else the
    plain Python reader with the same cells; `backend` is "native" or
    "plain". Each `iter()` opens its own stream. Usable as a context
    manager: closing releases the native streams early.

    Thread ownership: a StreamingCSV and its iterators belong to one
    consumer thread. `close()` frees the native streams; a concurrent
    `stream_next` from another thread (ctypes releases the GIL) would then
    wait on a freed condition variable.
    """

    def __init__(self, path, chunk_rows: int = 262_144):
        self.path = str(path)
        self.chunk_rows = int(chunk_rows)
        #: handles of this object's live native streams
        self._handles: set = set()
        self._lib = _get_lib()
        #: which reader parses the file: "native" or "plain"
        self.backend = "plain" if self._lib is None else "native"

    def _iter_native(self) -> Iterator[np.ndarray]:
        lib = self._lib
        handle = lib.stream_open(self.path.encode(), self.chunk_rows)
        if handle == 0:
            if not os.path.exists(self.path):
                raise FileNotFoundError(self.path)
            raise ValueError(f"empty csv: {self.path}")
        self._handles.add(handle)
        cols = lib.stream_cols(handle)
        buf = np.empty((self.chunk_rows, cols), dtype=np.float32)
        rows = ctypes.c_int64(0)
        try:
            while True:
                rc = lib.stream_next(handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                     ctypes.byref(rows))
                if rc == 1:
                    break
                if rc != 0:
                    raise IOError(f"I/O error mid-stream on {self.path}: the corpus "
                                  "would be truncated")
                yield buf[: rows.value].copy()
        finally:
            if handle in self._handles:
                self._handles.discard(handle)
                lib.stream_close(handle)

    def _iter_plain(self) -> Iterator[np.ndarray]:
        cols = _schema(self.path)
        rows: List[List[float]] = []
        with open(self.path, "rb") as f:
            for line in f:
                line = line.rstrip(b"\n")
                if not line:
                    continue
                cells = line.decode("utf-8", "replace").split(",")[:cols]
                rows.append([parse_cell(c) for c in cells] + [0.0] * (cols - len(cells)))
                if len(rows) == self.chunk_rows:
                    yield _float32(rows)
                    rows = []
        if rows:
            yield _float32(rows)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._lib is not None:
            return self._iter_native()
        return self._iter_plain()

    def close(self) -> None:
        if self._lib is not None:
            while self._handles:
                self._lib.stream_close(self._handles.pop())

    def __enter__(self) -> "StreamingCSV":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream_minmax(path, chunk_rows: int = 262_144) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass per-column (min, max): the statistics `renormalized()`
    needs, in O(chunk) memory."""
    lo = hi = None
    for chunk in StreamingCSV(path, chunk_rows):
        c_lo, c_hi = chunk.min(axis=0), chunk.max(axis=0)
        lo = c_lo if lo is None else np.minimum(lo, c_lo)
        hi = c_hi if hi is None else np.maximum(hi, c_hi)
    if lo is None:
        raise ValueError(f"empty csv: {path}")
    return lo, hi


def load_csv_streamed(path, chunk_rows: int = 262_144, device="cuda") -> torch.Tensor:
    """A float32 tensor on `device` built by chunked uploads: host memory
    stays O(chunk), the corpus is whole only on the device (the final
    concatenation holds it twice there for a moment, as in the JAX
    package)."""
    parts = list(prefetch_to_device(StreamingCSV(path, chunk_rows), device=device))
    if not parts:
        raise ValueError(f"empty csv: {path}")
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def prefetch_to_device(iterable: Iterable[np.ndarray], size: int = 2,
                       device="cuda") -> Iterator[torch.Tensor]:
    """Yield the chunks as tensors on `device`, `size` uploads ahead of the
    consumer: on CUDA each chunk is copied into pinned host memory and
    uploaded with `non_blocking`, so the copy overlaps the consumer's
    work on the device (the yielded tensor is ordered on the current
    stream)."""
    device = resolve_device(device)
    pin = device.type == "cuda"

    def upload(chunk):
        host = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        if pin:
            host = host.pin_memory()
        return host.to(device, non_blocking=pin)

    it = iter(iterable)
    queue = collections.deque(upload(chunk) for chunk in itertools.islice(it, size))
    while queue:
        out = queue.popleft()
        chunk = next(it, None)
        if chunk is not None:
            queue.append(upload(chunk))
        yield out
