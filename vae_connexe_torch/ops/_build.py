"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``vae_connexe_torch/csrc/`` has a plain C interface; it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under the
package's ``build/`` directory (listed in ``.gitignore``), named after a
hash of the source and the flags so that an edited source is rebuilt.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` or the toolkit's
    default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA toolkit is "
            "needed to build vae_connexe_torch's kernels")
    return str(path)


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns ``(library path, compiler output)``; the output holds ptxas's
    register and shared-memory report when a build ran, else is empty.
    """
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename: concurrent first uses in
    # several processes never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def rollout_library() -> ctypes.CDLL:
    """The built ``csrc/rollout.cu``, with its C signatures declared."""
    lib = ctypes.CDLL(str(build("rollout")[0]))
    lib.vcx_crvae_free_run.argtypes = [_P] * 10 + [_I] * 4 + [
        ctypes.c_float, _I, _P]
    lib.vcx_crvae_free_run.restype = _I
    lib.vcx_errvae_sample.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.vcx_errvae_sample.restype = _I
    lib.vcx_smem_optin.argtypes = [_I]
    lib.vcx_smem_optin.restype = _I
    lib.vcx_error_string.argtypes = [_I]
    lib.vcx_error_string.restype = ctypes.c_char_p
    return lib
