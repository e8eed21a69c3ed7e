"""Whole-rollout serving kernels (port of ``vae_connexe_tpu/ops/pallas_rollout.py``).

``crvae_free_run_fused`` and ``errvae_sample_fused`` keep the JAX entry
points' signatures and layouts.  On a CUDA tensor each launches its
hand-written kernel from ``csrc/rollout.cu`` (built at first use, see
``_build.py``) and adds one to its count in ``LAUNCHES``; on a CPU tensor it
runs its plain PyTorch version below, the per-step loop of
``CRVAE._free_run`` / ``ErrorVAE.sample``.  There is no fallback from the
kernel to the plain version: a CUDA input either launches or raises.

The kernels run in float32; sums are taken in another order than the
plain versions' ``einsum``, so the two agree to float32 rounding
(``chip_smoke.py`` states the tolerance and checks it on the card).
"""

from __future__ import annotations

import ctypes

import torch

from vae_connexe_torch.ops.gru import GRUParams, gru_cell, gru_step_heads
from vae_connexe_torch.utils.layers import Dense, dense

# Kernel launches per wrapper, counted where the kernel is launched.
LAUNCHES = {"crvae_free_run": 0, "errvae_sample": 0}

# Batch tiles the kernels are instantiated for (csrc/rollout.cu, launch()).
_TILES = (8, 4, 2, 1)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tile_smem_bytes(bt: int, heads: int, hidden: int, d: int) -> int:
    """Dynamic shared memory of one block: double-buffered hidden states of
    every head plus the tile's input row, float32."""
    return 4 * (2 * heads * bt * hidden + bt * d)


def pick_bt(batch: int, heads: int, hidden: int, d: int, budget: int,
            n_sm: int) -> int:
    """Batch tile of the rollout kernels: the widest tile whose shared
    memory fits ``budget`` bytes and that still gives every one of the
    ``n_sm`` SMs a block; one row per block when the batch is too small for
    that.  A wider tile reuses each weight it loads for more rows, but a
    block runs on one SM, so below one block per SM width only idles SMs.
    Raises when even one row does not fit.  A ragged last tile is masked in
    the kernel."""
    fitting = [bt for bt in _TILES
               if tile_smem_bytes(bt, heads, hidden, d) <= budget]
    if not fitting:
        raise ValueError(
            f"rollout kernel: one batch row of {heads} heads x hidden "
            f"{hidden} needs {tile_smem_bytes(1, heads, hidden, d)} bytes of "
            f"shared memory, over the device's {budget}")
    for bt in fitting:
        if -(-batch // bt) >= n_sm:
            return bt
    return fitting[-1]


def _check(device: torch.device, what: str, **expected) -> None:
    """Each ``name=(tensor, shape)`` lies on ``device``, is float32 and has
    exactly ``shape``: the kernel reads it by that shape."""
    for name, (t, shape) in expected.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}; "
                             f"the kernel takes float32 on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def _launch(fn_name: str, device: torch.device, tensors, ints, bt: int,
            scale=None) -> None:
    """Call one C entry point of the rollout library on ``device``'s current
    stream; raise on the CUDA error it returns."""
    from vae_connexe_torch.ops._build import rollout_library

    lib = rollout_library()
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    extra = [] if scale is None else [ctypes.c_float(scale)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*ptrs, *ints, *extra, bt,
                                   ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.vcx_error_string(rc).decode()} (cuda {rc})")


def _pick_bt_on(device: torch.device, batch: int, heads: int, hidden: int,
                d: int) -> int:
    """``pick_bt`` with ``device``'s shared-memory limit and SM count."""
    from vae_connexe_torch.ops._build import rollout_library

    budget = rollout_library().vcx_smem_optin(device.index or 0)
    if budget < 0:
        raise RuntimeError(f"cannot read the shared-memory limit of {device}")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return pick_bt(batch, heads, hidden, d, budget, n_sm)


# --------------------------------------------------------------------------
# K1: CRVAE free run, p heads; the emitted x feeds every head's next step.
# --------------------------------------------------------------------------

def crvae_free_run_plain(heads: GRUParams, readout: Dense, x0: torch.Tensor,
                         h0_shared: torch.Tensor, noise: torch.Tensor,
                         noise_scale: float) -> torch.Tensor:
    """Plain PyTorch version of K1: ``CRVAE._free_run``'s per-step loop."""
    p = heads.w_ih.shape[0]
    h = h0_shared.expand(p, *h0_shared.shape)
    x = x0
    outs = []
    for t in range(noise.shape[1]):
        h = gru_step_heads(heads, x, h)                       # (p, B, H)
        out = torch.einsum("pbh,poh->pbo", h, readout.w) + readout.b[:, None, :]
        x = out[..., 0].T + noise_scale * noise[:, t]         # (B, p)
        outs.append(x)
    return torch.stack(outs, dim=1)


def crvae_free_run_fused(heads: GRUParams, readout: Dense, x0: torch.Tensor,
                         h0_shared: torch.Tensor, noise: torch.Tensor,
                         noise_scale: float) -> torch.Tensor:
    """Whole CRVAE free run in one kernel (K1).

    heads: stacked, already masked GRUParams (p, 3H, D); readout: stacked
    Dense (p, 1, H)/(p, 1); x0 (B, D); h0_shared (B, H), the one state every
    head starts from; noise (B, T, D).  Returns (B, T, D) float32, D = p.
    """
    if x0.device.type == "cpu":
        return crvae_free_run_plain(heads, readout, x0, h0_shared, noise,
                                    noise_scale)
    dev = x0.device
    p, hidden = heads.w_ih.shape[0], heads.hidden
    b, t_len = noise.shape[:2]
    g = 3 * hidden
    _check(dev, "crvae_free_run", w_ih=(heads.w_ih, (p, g, p)),
           w_hh=(heads.w_hh, (p, g, hidden)), b_ih=(heads.b_ih, (p, g)),
           b_hh=(heads.b_hh, (p, g)), ro_w=(readout.w, (p, 1, hidden)),
           ro_b=(readout.b, (p, 1)), x0=(x0, (b, p)),
           h0=(h0_shared, (b, hidden)), noise=(noise, (b, t_len, p)))
    bt = _pick_bt_on(dev, b, p, hidden, p)
    out = torch.empty((b, t_len, p), device=dev, dtype=torch.float32)
    tensors = (x0.contiguous(), h0_shared.contiguous(), noise.contiguous(),
               heads.w_ih.transpose(1, 2).contiguous(),
               heads.w_hh.transpose(1, 2).contiguous(),
               heads.b_ih.contiguous(), heads.b_hh.contiguous(),
               readout.w.contiguous(), readout.b.contiguous(), out)
    _launch("vcx_crvae_free_run", dev, tensors, (b, t_len, p, hidden), bt,
            scale=float(noise_scale))
    LAUNCHES["crvae_free_run"] += 1
    return out


# --------------------------------------------------------------------------
# K2: ErrorVAE free run, one GRU + readout, from x0 = 0.
# --------------------------------------------------------------------------

def errvae_sample_plain(dec: GRUParams, out: Dense, h0: torch.Tensor,
                        d: int, t_len: int) -> torch.Tensor:
    """Plain PyTorch version of K2: ``ErrorVAE.sample``'s per-step loop."""
    h = h0
    x = torch.zeros((h0.shape[0], d), device=h0.device, dtype=h0.dtype)
    outs = []
    for _ in range(t_len):
        h = gru_cell(dec, x, h)
        x = dense(out, h)
        outs.append(x)
    return torch.stack(outs, dim=1)


def errvae_sample_fused(dec: GRUParams, out: Dense, h0: torch.Tensor,
                        d: int, t_len: int) -> torch.Tensor:
    """Whole ErrorVAE free run in one kernel (K2): from x0 = 0, roll
    ``t_len`` steps.  h0 (B, H).  Returns (B, t_len, D); the caller prepends
    the reference's leading zero step."""
    if h0.device.type == "cpu":
        return errvae_sample_plain(dec, out, h0, d, t_len)
    dev = h0.device
    b, hidden = h0.shape
    g = 3 * hidden
    _check(dev, "errvae_sample", w_ih=(dec.w_ih, (g, d)),
           w_hh=(dec.w_hh, (g, hidden)), b_ih=(dec.b_ih, (g,)),
           b_hh=(dec.b_hh, (g,)), ro_w=(out.w, (d, hidden)),
           ro_b=(out.b, (d,)), h0=(h0, (b, hidden)))
    bt = _pick_bt_on(dev, b, 1, hidden, d)
    res = torch.empty((b, t_len, d), device=dev, dtype=torch.float32)
    tensors = (h0.contiguous(), dec.w_ih.T.contiguous(), dec.w_hh.T.contiguous(),
               dec.b_ih.contiguous(), dec.b_hh.contiguous(),
               out.w.contiguous(), out.b.contiguous(), res)
    _launch("vcx_errvae_sample", dev, tensors, (b, t_len, d, hidden), bt)
    LAUNCHES["errvae_sample"] += 1
    return res
