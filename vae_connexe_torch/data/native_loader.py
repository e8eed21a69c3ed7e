"""The native out-of-core window loader (port of
``vae_connexe_tpu/data/native_loader.py``).

``native/window_loader.cc`` (at the repository's root, beside both
packages) memory-maps a float32 (T, p) series file and assembles window
minibatches in C++: the host-side data path for series too long to hold
their windows in device memory (``train/streaming.py``).  It is bound
through ctypes and built at first use with ``g++`` into the package's own
``build/`` directory (listed in ``.gitignore``), named after a hash of the
source and the flags, as ``ops/_build.py`` names the CUDA libraries; an
edited source is rebuilt.  Nothing is built when this module is imported.

For in-memory series ``data.windows`` is the right tool; this loader is
for the out-of-core regime.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from vae_connexe_torch.ops._build import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "window_loader.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def library_path() -> pathlib.Path:
    """Where the loader builds to: a hash of its source and the flags."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwindow_loader-{h.hexdigest()[:12]}.so"


@functools.cache
def _load() -> ctypes.CDLL:
    """The built loader with its C signatures declared (built if missing,
    under a temporary name then renamed, so concurrent first uses never
    load a half-written library)."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"native source missing: {SOURCE}")
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.wl_open.restype = vp
    lib.wl_open.argtypes = [ctypes.c_char_p, i64, i64]
    lib.wl_open_inline.restype = vp
    lib.wl_open_inline.argtypes = [vp, i64, i64]
    lib.wl_num_windows.restype = i64
    lib.wl_num_windows.argtypes = [vp, i64, ctypes.c_int]
    lib.wl_fill_batch.restype = ctypes.c_int
    lib.wl_fill_batch.argtypes = [vp, vp, i64, i64, vp]
    lib.wl_fill_shifted_batch.restype = ctypes.c_int
    lib.wl_fill_shifted_batch.argtypes = [vp, vp, i64, i64, vp, vp]
    lib.wl_standardize.restype = ctypes.c_int
    lib.wl_standardize.argtypes = [vp]
    lib.wl_close.restype = None
    lib.wl_close.argtypes = [vp]
    return lib


def _out(out: Optional[np.ndarray], shape) -> np.ndarray:
    """``out`` checked to be a C-contiguous float32 array of ``shape``, or a
    new one."""
    if out is None:
        return np.empty(shape, np.float32)
    if (out.shape != tuple(shape) or out.dtype != np.float32
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous float32 of shape "
                         f"{tuple(shape)}, got {out.dtype} {out.shape}")
    return out


class NativeWindowLoader:
    """Sliding-window batches from a file-backed (or in-memory) series.

    Usage:
        with NativeWindowLoader.from_file("series.f32", t, p) as loader:
            batch = loader.sample_batch(rng, batch_size=256, context=20)
    """

    def __init__(self, handle: int, t: int, p: int,
                 keepalive: Optional[np.ndarray] = None):
        self._lib = _load()
        self._h = handle
        self.t = t
        self.p = p
        self._keepalive = keepalive   # pins the inline buffer

    # ---------------- constructors ----------------

    @classmethod
    def from_file(cls, path: str, t: int, p: int) -> "NativeWindowLoader":
        """Memory-map a raw float32 (t, p) row-major file (zero-copy)."""
        h = _load().wl_open(str(path).encode(), t, p)
        if not h:
            raise OSError(f"wl_open failed for {path} (t={t}, p={p})")
        return cls(h, t, p)

    @classmethod
    def from_array(cls, series: np.ndarray) -> "NativeWindowLoader":
        """Wrap an in-memory float32 (t, p) array without copying."""
        arr = np.ascontiguousarray(series, dtype=np.float32)
        h = _load().wl_open_inline(arr.ctypes.data, arr.shape[0], arr.shape[1])
        if not h:
            raise ValueError("wl_open_inline failed")
        return cls(h, arr.shape[0], arr.shape[1], keepalive=arr)

    # ---------------- API ----------------

    def num_windows(self, context: int, shifted: bool = False) -> int:
        """T - context + 1 plain windows (``sliding_windows``), or
        T - context shifted input/target pairs (``arrange_input``)."""
        return int(self._lib.wl_num_windows(self._h, context, int(shifted)))

    def standardize(self) -> None:
        """Per-variable (x - mean) / std over time: one streaming Welford
        pass stores O(p) stats that the fill paths apply on the fly."""
        rc = self._lib.wl_standardize(self._h)
        if rc != 0:
            raise RuntimeError(f"wl_standardize failed ({rc})")

    def gather(self, idx: np.ndarray, context: int, *,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """Windows at explicit start indices.  Returns (n, context, p),
        written into ``out`` when it is given (for instance a pinned
        buffer's numpy view)."""
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        out = _out(out, (len(idx), context, self.p))
        rc = self._lib.wl_fill_batch(self._h, idx.ctypes.data, len(idx),
                                     context, out.ctypes.data)
        if rc != 0:
            raise IndexError(f"wl_fill_batch failed ({rc}); valid starts are "
                             f"[0, {self.num_windows(context)})")
        return out

    def gather_shifted(self, idx: np.ndarray,
                       context: int) -> Tuple[np.ndarray, np.ndarray]:
        """(inputs, one-step-shifted targets): the arrange_input contract."""
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        inputs = np.empty((len(idx), context, self.p), np.float32)
        targets = np.empty_like(inputs)
        rc = self._lib.wl_fill_shifted_batch(
            self._h, idx.ctypes.data, len(idx), context,
            inputs.ctypes.data, targets.ctypes.data)
        if rc != 0:
            raise IndexError(f"wl_fill_shifted_batch failed ({rc})")
        return inputs, targets

    def sample_batch(self, rng: np.random.Generator, batch_size: int,
                     context: int) -> np.ndarray:
        """Uniform with-replacement minibatch over all T - context + 1 plain
        windows (host-side analogue of ``data.windows.sample_batch``)."""
        idx = rng.integers(0, self.num_windows(context), batch_size,
                           dtype=np.int64)
        return self.gather(idx, context)

    def close(self) -> None:
        if self._h:
            self._lib.wl_close(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
