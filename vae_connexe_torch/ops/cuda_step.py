"""The whole phase-1 step in one kernel family (port of ``vae_connexe_tpu/ops/pallas_step.py``).

``fused_phase1_step(model, cfg, params, parents, batch, eps)`` keeps the JAX
entry point's signature and metrics dict: one CRVAE phase-1 step (KL
regulariser) on the given batch (B, T, p) and reparameterisation draw eps
(B, H), returning (new CRVAEParams, metrics).  The loss is measured at the
incoming parameters; no best-model tracking (that is the fit's).

On a CUDA tensor it launches B3, ``csrc/step.cu`` (built at first use, see
``_build.py``): six kernels on the current stream that reduce their
partial sums in a fixed order, so a step is deterministic; it adds one to
``LAUNCHES["phase1_step"]``.  On a CPU tensor it runs the plain version,
one ``make_phase1_step`` body on the same batch and eps with the plain
recurrences called directly.  There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vae_connexe_torch.models.crvae import CRVAE, CRVAEParams
from vae_connexe_torch.ops.cuda_gru import (
    _launch,
    bwd_smem_bytes,
    device_limits,
    fwd_smem_bytes,
    pick_tile,
)
from vae_connexe_torch.ops.gru import gru_scan, gru_scan_heads
from vae_connexe_torch.utils.tree import tree_leaves, tree_unflatten

LAUNCHES = {"phase1_step": 0}

METRICS = ("loss", "recon", "latent_reg", "mean_loss", "variable_usage")

# The parameter leaves in ``tree_leaves(CRVAEParams)`` order, as step.cu
# names them.
LEAVES = ("enc_wih", "enc_whh", "enc_bih", "enc_bhh", "mu_w", "mu_b", "lv_w",
          "lv_b", "hd_wih", "hd_whh", "hd_bih", "hd_bhh", "ro_w", "ro_b")
_SCRATCH = ("henc", "hdec", "mu", "lv", "z", "dz_part", "kl_part", "sq_part",
            "usage")
_RED_FLOATS = 512      # gru_tile.cuh kMaxThreads: a block's reduction scratch


class StepArgs(ctypes.Structure):
    """Mirror of ``StepArgs`` in csrc/step.cu, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("batch", "eps", "mask")]
                + [(n, ctypes.c_void_p) for n in LEAVES]
                + [("o_" + n, ctypes.c_void_p) for n in LEAVES]
                + [("metrics", ctypes.c_void_p)]
                + [(n, ctypes.c_void_p) for n in _SCRATCH]
                + [("g_" + n, ctypes.c_void_p) for n in LEAVES]
                + [(n, ctypes.c_int) for n in ("B", "T", "P", "H", "E",
                                               "bt_enc", "bt_dec")]
                + [(n, ctypes.c_float) for n in ("lr", "lam", "lam_ridge",
                                                 "beta")])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def decoder_smem_bytes(bt: int, p: int, hidden: int, t_dec: int) -> int:
    """Shared memory of a decoder block (step.cu ``dec_smem``)."""
    return bwd_smem_bytes(bt, p, hidden) + 4 * (bt * t_dec + _RED_FLOATS)


def encoder_smem_bytes(bt: int, p: int, hidden: int) -> int:
    """The larger shared memory of the two encoder kernels (step.cu
    ``enc_fwd_smem``, ``enc_bwd_smem``)."""
    return max(fwd_smem_bytes(bt, p, hidden) + 4 * _RED_FLOATS,
               bwd_smem_bytes(bt, p, hidden) + 4 * 3 * bt * hidden)


def fused_phase1_step_plain(model: CRVAE, cfg, params: CRVAEParams,
                            parents: torch.Tensor, batch: torch.Tensor,
                            eps: torch.Tensor):
    """Plain PyTorch version of B3: one ``make_phase1_step`` body on the
    given batch and eps, with the plain recurrences (``gru_scan``,
    ``gru_scan_heads``) called directly."""
    from vae_connexe_torch.train.crvae_trainer import _phase1_update

    return _phase1_update(model, cfg, params, parents, batch, eps,
                          recurrences=(gru_scan, gru_scan_heads))


def _flat_views(sizes: dict, device) -> dict:
    """One float32 buffer cut into named views of the given shapes."""
    total = sum(math.prod(s) for s in sizes.values())
    flat = torch.empty(total, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in sizes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def fused_phase1_step(model: CRVAE, cfg, params: CRVAEParams,
                      parents: torch.Tensor, batch: torch.Tensor,
                      eps: torch.Tensor):
    """One phase-1 step (B3).  batch (B, T, p), eps (B, H), parents (p, p).
    Returns (new CRVAEParams, {loss, recon, latent_reg, mean_loss,
    variable_usage} as 0-d tensors)."""
    if batch.device.type == "cpu":
        return fused_phase1_step_plain(model, cfg, params, parents, batch, eps)
    from vae_connexe_torch.ops._build import step_library

    dev = batch.device
    b, t, p = batch.shape
    hidden, e = model.hidden, model.enc_len
    t_dec = t - e
    if p != model.p or t_dec < 1:
        raise ValueError(f"batch {tuple(batch.shape)} does not fit CRVAE(p="
                         f"{model.p}, enc_len={e})")
    leaves = tree_leaves(params)
    for name, v in zip(LEAVES, leaves):
        if v.device != dev or v.dtype != torch.float32:
            raise ValueError(f"fused_phase1_step: {name} is {v.dtype} on "
                             f"{v.device}; the kernel takes float32 on {dev}")
    for name, v, shape in (("eps", eps, (b, hidden)), ("parents", parents,
                                                       (p, p))):
        if v.device != dev or tuple(v.shape) != shape:
            raise ValueError(f"fused_phase1_step: {name} is {tuple(v.shape)} "
                             f"on {v.device}, expected {shape} on {dev}")
    limits = device_limits(dev)
    bt_dec = pick_tile(b, p, hidden,
                       lambda n: decoder_smem_bytes(n, p, hidden, t_dec),
                       limits)
    bt_enc = pick_tile(b, 1, hidden,
                       lambda n: encoder_smem_bytes(n, p, hidden), limits)
    nbe, nbd = math.ceil(b / bt_enc), math.ceil(b / bt_dec)

    outs = _flat_views({n: tuple(v.shape) for n, v in zip(LEAVES, leaves)}
                       | {"metrics": (len(METRICS),)}, dev)
    parts = {"g_" + n: ((p, nbd) if n.startswith(("hd_", "ro_")) else (nbe,))
             + tuple(v.shape[1:] if n.startswith(("hd_", "ro_")) else v.shape)
             for n, v in zip(LEAVES, leaves)}
    scratch = _flat_views({
        "henc": (b, e, hidden), "hdec": (p, b, t_dec, hidden),
        "mu": (b, hidden), "lv": (b, hidden), "z": (b, hidden),
        "dz_part": (p, b, hidden), "kl_part": (nbe,), "sq_part": (p, nbd),
        "usage": (p, p)} | parts, dev)
    ins = {"batch": batch.float().contiguous(), "eps": eps.float().contiguous(),
           "mask": parents.to(device=dev, dtype=torch.float32).contiguous()}
    ins |= {n: v.contiguous() for n, v in zip(LEAVES, leaves)}
    ptr = {n: v.data_ptr() for n, v in ins.items()}
    ptr |= {"o_" + n: outs[n].data_ptr() for n in LEAVES}
    ptr |= {"metrics": outs["metrics"].data_ptr()}
    ptr |= {n: v.data_ptr() for n, v in scratch.items()}
    args = StepArgs(**ptr, B=b, T=t, P=p, H=hidden, E=e, bt_enc=bt_enc,
                    bt_dec=bt_dec, lr=float(cfg.lr), lam=float(cfg.lam),
                    lam_ridge=float(cfg.lam_ridge), beta=float(cfg.beta))
    _launch(step_library(), "vcx_phase1_step", dev, (ctypes.byref(args),))
    LAUNCHES["phase1_step"] += 1
    new_params = tree_unflatten(params, [outs[n] for n in LEAVES])
    metrics = {k: outs["metrics"][i] for i, k in enumerate(METRICS)}
    return new_params, metrics
