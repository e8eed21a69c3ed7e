"""Build the port's CUDA kernels at first use and load them with ctypes.

Three libraries, each from one ``.cu`` file under ``vae_connexe_torch/csrc/``
with a plain C interface: ``rollout`` (the serving kernels), ``gru`` (the
recurrence forward and backward) and ``step`` (the whole phase-1 step);
``gru`` and ``step`` share the backward phases of ``gru_bwd.cuh`` and the
staging helpers of ``gru_tile.cuh``, whose forward block body only ``step``
runs (``gru``'s forward is ``gru_fwd.cuh``, whose staging helpers and
thread tile ``rollout`` reuses, and which includes the other two).  Each is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under the
package's ``build/`` directory (listed in ``.gitignore``), named after a
hash of its sources and the flags so that an edited source is rebuilt.
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


# The files each library is compiled from; the first is the translation
# unit, the rest are headers it includes.  All of them name the library.
SOURCES = {
    "rollout": ("rollout.cu", "gru_tile.cuh", "gru_bwd.cuh", "gru_fwd.cuh"),
    "gru": ("gru.cu", "gru_tile.cuh", "gru_bwd.cuh", "gru_fwd.cuh",
            "gru_wide.cuh"),
    "step": ("step.cu", "gru_tile.cuh", "gru_bwd.cuh"),
}


def library_path(name: str) -> pathlib.Path:
    """Where library ``name`` builds to (content-addressed: a hash of its
    sources and the flags)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names) -> dict[str, tuple[pathlib.Path, str]]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per library, all started together.

    Returns ``{name: (library path, compiler output)}``; the output holds
    ptxas's register and shared-memory report when a build ran, else is
    empty.  Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done, running = {}, {}
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                done[name] = (lib, "")
                continue
            # Build under a temporary name and rename: concurrent first
            # uses in several processes never load a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 str(CSRC / SOURCES[name][0])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running[name] = (lib, tmp, proc)
        failed = []
        for name, (lib, tmp, proc) in running.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{SOURCES[name][0]}:\n{out}")
                continue
            os.replace(tmp, lib)
            done[name] = (lib, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for lib, tmp, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return done


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile library ``name`` unless it is built; see ``build_all``."""
    return build_all([name])[name]


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def rollout_library() -> ctypes.CDLL:
    """The built ``csrc/rollout.cu``, with its C signatures declared."""
    lib = ctypes.CDLL(str(build("rollout")[0]))
    # Each launch has a float32 entry point and a bf16 one (suffix _bf16)
    # of the same signature.
    for suffix in ("", "_bf16"):
        for fn, args in (
                ("vcx_crvae_free_run_streamed",
                 [_P] * 11 + [_I] * 4 + [ctypes.c_float, _I, _P]),
                ("vcx_crvae_free_run_resident",
                 [_P] * 10 + [_I] * 4 + [ctypes.c_float] + [_I] * 4 + [_P]),
                ("vcx_errvae_sample_streamed", [_P] * 9 + [_I] * 5 + [_P]),
                ("vcx_errvae_sample_resident", [_P] * 8 + [_I] * 6 + [_P])):
            getattr(lib, fn + suffix).argtypes = args
            getattr(lib, fn + suffix).restype = _I
    lib.vcx_crvae_max_clusters.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    lib.vcx_resident_block.argtypes = [_I] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.vcx_resident_block.restype = None
    lib.vcx_streamed_block.argtypes = [_I] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.vcx_streamed_block.restype = None
    lib.vcx_device_limits.argtypes = [_I, ctypes.POINTER(_I)]
    for fn in ("vcx_crvae_max_clusters", "vcx_device_limits"):
        getattr(lib, fn).restype = _I
    lib.vcx_error_string.argtypes = [_I]
    lib.vcx_error_string.restype = ctypes.c_char_p
    return lib


_L = ctypes.c_longlong


@functools.cache
def gru_library() -> ctypes.CDLL:
    """The built ``csrc/gru.cu``, with its C signatures declared."""
    lib = ctypes.CDLL(str(build("gru")[0]))
    head = [_P, _L, _L, _L] + [_P] * 5 + [_L, _L]
    lib.vcx_gru_forward.argtypes = head + [_P] * 2 + [_I] * 6 + [_P]
    lib.vcx_gru_forward.restype = _I
    lib.vcx_gru_bwd_chain.argtypes = head + [_P] * 4 + [_I] * 7 + [_P]
    lib.vcx_gru_bwd_chain.restype = _I
    lib.vcx_gru_xproj.argtypes = [_P, _L, _L, _L, _P, _P, _P] + [_I] * 5 + [_P]
    lib.vcx_gru_xproj.restype = _I
    lib.vcx_wide_chain_block.argtypes = [_I] * 2 + [ctypes.POINTER(_L)]
    lib.vcx_wide_chain_block.restype = None
    lib.vcx_wide_fwd_block.argtypes = [_I] * 2 + [ctypes.POINTER(_L)]
    lib.vcx_wide_fwd_block.restype = None
    lib.vcx_gru_bwd_wgrad.argtypes = ([_P, _P, _L, _L, _L, _P, _L, _L]
                                      + [_P] * 4 + [_I] * 7 + [_P])
    lib.vcx_gru_bwd_wgrad.restype = _I
    lib.vcx_gru_backward.argtypes = head + [_P] * 6 + [_I] * 9 + [_P]
    lib.vcx_gru_backward.restype = _I
    lib.vcx_device_limits.argtypes = [_I, ctypes.POINTER(_I)]
    lib.vcx_device_limits.restype = _I
    lib.vcx_error_string.argtypes = [_I]
    lib.vcx_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def step_library() -> ctypes.CDLL:
    """The built ``csrc/step.cu``, with its C signatures declared.  Raises
    if the library's buffer constants differ from ``cuda_step``'s, which
    sizes the buffers the kernels write."""
    from vae_connexe_torch.ops.cuda_step import READOUT_ROWS, RIDGE_PARTS, StepArgs

    lib = ctypes.CDLL(str(build("step")[0]))
    lib.vcx_phase1_step.argtypes = [ctypes.POINTER(StepArgs), _P]
    lib.vcx_phase1_step.restype = _I
    lib.vcx_step_constants.argtypes = [ctypes.POINTER(_I)]
    lib.vcx_step_constants.restype = _I
    got = (_I * 2)()
    lib.vcx_step_constants(got)
    if tuple(got) != (READOUT_ROWS, RIDGE_PARTS):
        raise RuntimeError(f"csrc/step.cu's constants {tuple(got)} differ "
                           f"from cuda_step's {(READOUT_ROWS, RIDGE_PARTS)}")
    lib.vcx_error_string.argtypes = [_I]
    lib.vcx_error_string.restype = ctypes.c_char_p
    return lib
