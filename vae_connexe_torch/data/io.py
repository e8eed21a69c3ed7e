"""Loading user-supplied time series from disk (the port's own copy of
``vae_connexe_tpu/data/io.py``; plain numpy).

Accepted layouts:

- ``(T, p)``       one multivariate series, T time steps of p variables;
- ``(N, T, p)``    a stack of N realisations of the same system (windows
                   are built per realisation and pooled).

Formats, chosen by extension:

- ``.npy``         any float array of the above shapes;
- ``.npz``         the array under the key ``series``, else the first one;
- ``.csv/.tsv/.txt`` delimited text, rows = time steps, columns =
                   variables; a non-numeric first row is a header and is
                   returned as the variable names;
- anything else    raw little-endian float32, reshaped to ``shape=``,
                   which the caller must give (the native window loader's
                   on-disk format, ``native/window_loader.cc``).
"""

from __future__ import annotations

import pathlib

import numpy as np


def load_series(path: str, *, shape: tuple[int, ...] | None = None,
                delimiter: str | None = None):
    """Load a time-series file.  Returns ``(series, names)``: ``series``
    float32 of shape (T, p) or (N, T, p), ``names`` the header's column
    names, or ``None`` when the file has no header."""
    p = pathlib.Path(path)
    if not p.exists():
        raise FileNotFoundError(f"series file not found: {path}")
    suffix = p.suffix.lower()
    names = None
    if suffix == ".npy":
        arr = np.load(p)
    elif suffix == ".npz":
        with np.load(p) as z:
            key = "series" if "series" in z.files else z.files[0]
            arr = z[key]
    elif suffix in (".csv", ".tsv", ".txt"):
        arr, names = _load_delimited(p, delimiter)
    else:
        if shape is None:
            raise ValueError(
                f"unrecognized extension {suffix!r}: raw float32 files need "
                "an explicit shape=(T, p) (the .f32 convention of the native "
                "window loader)")
        arr = np.fromfile(p, dtype=np.float32)
        expected = int(np.prod(shape))
        if arr.size != expected:
            raise ValueError(
                f"raw file holds {arr.size} float32 values, shape {shape} "
                f"needs {expected}")
        arr = arr.reshape(shape)
    return _validate(arr, path), names


def _load_delimited(p: pathlib.Path, delimiter: str | None):
    if delimiter is None:
        suffix = p.suffix.lower()
        # .txt splits on any whitespace.
        delimiter = {".tsv": "\t", ".txt": None}.get(suffix, ",")
    with open(p) as f:
        first = f.readline()
    tokens = (first.strip().split(delimiter) if delimiter
              else first.strip().split())
    names = None
    skip = 0
    if tokens and not _all_numeric(tokens):
        names = [t.strip().strip('"') for t in tokens]
        skip = 1
    arr = np.loadtxt(p, delimiter=delimiter, skiprows=skip, ndmin=2)
    if names is not None and len(names) != arr.shape[1]:
        raise ValueError(
            f"header has {len(names)} names but data rows have "
            f"{arr.shape[1]} columns in {p}")
    return arr, names


def _all_numeric(tokens) -> bool:
    try:
        [float(t) for t in tokens]
        return True
    except ValueError:
        return False


def _validate(arr: np.ndarray, path: str) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim not in (2, 3):
        raise ValueError(
            f"series must be (T, p) or (N, T, p); {path} holds shape "
            f"{arr.shape}")
    if not np.isfinite(arr).all():
        bad = int((~np.isfinite(arr)).sum())
        raise ValueError(
            f"{path} contains {bad} non-finite values (NaN/Inf) — clean or "
            "impute the series before discovery")
    if arr.shape[-2] < 8:
        raise ValueError(
            f"{path}: only {arr.shape[-2]} time steps — need at least a few "
            "context windows (rows are time steps, columns variables; "
            "transpose if your file is (p, T))")
    return arr
