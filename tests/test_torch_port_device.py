"""The port's boundaries: no JAX inside it, no silent CPU fallback, and the
kernels on the card.

This file imports no JAX, so its card test runs where JAX is absent:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_device.py``.
"""

import subprocess
import sys

import pytest
import torch

from vae_connexe_torch import _device
from vae_connexe_torch.models import CRVAE, ErrorVAE, masked_heads
from vae_connexe_torch.ops import cuda_rollout

_MODULES = ["vae_connexe_torch", "vae_connexe_torch._device",
            "vae_connexe_torch.cli", "vae_connexe_torch.convert",
            "vae_connexe_torch.models.crvae", "vae_connexe_torch.models.error_vae",
            "vae_connexe_torch.ops._build", "vae_connexe_torch.ops.cuda_rollout",
            "vae_connexe_torch.ops.gru", "vae_connexe_torch.server",
            "vae_connexe_torch.serving", "vae_connexe_torch.train.crvae_trainer",
            "vae_connexe_torch.utils.layers"]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'vae_connexe_tpu')))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CRVAE(p=3, hidden=4).init(torch.Generator().manual_seed(0))
    from vae_connexe_torch.serving import load_generator
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_generator(b"")
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_is_content_addressed():
    """The library path names a hash of the source and flags; nothing is
    built at import."""
    from vae_connexe_torch.ops import _build

    path = _build.library_path("rollout")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path("rollout")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    """Both kernels against their plain versions on the card, ragged batch,
    random parents mask.  Tolerance 1e-4 absolute: 21 float32 steps, FMA
    order differs from cuBLAS's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    p, hidden, b, t = 6, 16, 37, 21
    params = CRVAE(p, hidden).init(g, cuda_device)
    err = ErrorVAE(p, hidden).init(g, cuda_device)
    parents = (torch.rand((p, p), generator=g) > 0.3).float()
    heads = masked_heads(params.heads, parents)
    h0 = torch.randn((b, hidden), generator=g).to(cuda_device)
    noise = torch.randn((b, t, p), generator=g).to(cuda_device)
    x0 = torch.zeros((b, p), device=cuda_device)
    k1 = cuda_rollout.crvae_free_run_fused(heads, params.readout, x0, h0,
                                           noise, 0.1)
    ref1 = cuda_rollout.crvae_free_run_plain(heads, params.readout, x0, h0,
                                             noise, 0.1)
    k2 = cuda_rollout.errvae_sample_fused(err.dec, err.out, h0, p, t)
    ref2 = cuda_rollout.errvae_sample_plain(err.dec, err.out, h0, p, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(k1, ref1, rtol=0, atol=1e-4)
    torch.testing.assert_close(k2, ref2, rtol=0, atol=1e-4)
