"""The whole phase-1 step in one kernel family (port of ``vae_connexe_tpu/ops/pallas_step.py``).

``fused_phase1_step(model, cfg, params, parents, batch, eps)`` keeps the JAX
entry point's signature and metrics dict: one CRVAE phase-1 step (KL
regulariser) on the given batch (B, T, p) and reparameterisation draw eps
(B, H), returning (new CRVAEParams, metrics).  The loss is measured at the
incoming parameters; no best-model tracking (that is the fit's).

On a CUDA tensor it launches B3, ``csrc/step.cu`` (built at first use, see
``_build.py``): eleven kernels on the current stream that reduce their
partial sums in a fixed order, so a step is deterministic; it adds one to
``LAUNCHES["phase1_step"]``.  The backward of both GRUs is B2's two phases
(``csrc/gru_bwd.cuh``): a serial dh chain and a weight-gradient kernel
parallel over B*T, so no weight-gradient sum runs inside a time loop.  On
a CPU tensor it runs the plain version, one ``make_phase1_step`` body on
the same batch and eps with the plain recurrences called directly.  There
is no fallback from the kernel to the plain version.

The phases that B3 adds to B2's have plain versions here:
``decoder_readout_plain`` (the masked, teacher-forced decoder forward and
the readout: hdec, the chain's input douts, the squared error and the
readout gradients) and ``latent_plain`` (the latent and KL terms, the fc
gradients and d loss / d h_E).  Composed with ``cuda_gru.bwd_chain_plain``
and ``bwd_wgrad_plain`` they reproduce ``fused_phase1_step_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vae_connexe_torch.models.crvae import (
    CRVAE,
    CRVAEParams,
    decoder_input,
    masked_heads,
)
from vae_connexe_torch.ops.cuda_gru import (
    _launch,
    chain_tile,
    device_limits,
    fwd_smem_bytes,
    pick_tile,
    wgrad_splits,
)
from vae_connexe_torch.ops.gru import gru_scan, gru_scan_heads
from vae_connexe_torch.utils.tree import tree_leaves, tree_unflatten

LAUNCHES = {"phase1_step": 0}

METRICS = ("loss", "recon", "latent_reg", "mean_loss", "variable_usage")

# The parameter leaves in ``tree_leaves(CRVAEParams)`` order, as step.cu
# names them.
LEAVES = ("enc_wih", "enc_whh", "enc_bih", "enc_bhh", "mu_w", "mu_b", "lv_w",
          "lv_b", "hd_wih", "hd_whh", "hd_bih", "hd_bhh", "ro_w", "ro_b")
_SCRATCH = ("henc", "hdec", "mu", "lv", "z", "douts", "gh", "dz_part",
            "douts_enc", "gh_enc", "dh0_enc", "kl_part", "sq_part",
            "ridge_part", "usage", "g_enc", "g_hd", "g_mu_w", "g_mu_b",
            "g_lv_w", "g_lv_b", "g_ro_w", "g_ro_b")
_PLAN = ("B", "T", "P", "H", "E", "bt_enc", "bt_dec", "bt_chain_dec",
         "bt_chain_enc", "splits_dec", "chunk_dec", "splits_enc", "chunk_enc")
_RED_FLOATS = 512      # gru_tile.cuh kMaxThreads: a block's reduction scratch
# step.cu's kReadoutRows (rows of B*td a readout block takes) and
# kLeaves * kUpdateBlocks (the update's ridge partials); step_library()
# checks both against the built library.
READOUT_ROWS, RIDGE_PARTS = 128, 14 * 120


class StepArgs(ctypes.Structure):
    """Mirror of ``StepArgs`` in csrc/step.cu, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("batch", "eps", "mask")]
                + [(n, ctypes.c_void_p) for n in LEAVES]
                + [("o_" + n, ctypes.c_void_p) for n in LEAVES]
                + [("metrics", ctypes.c_void_p)]
                + [(n, ctypes.c_void_p) for n in _SCRATCH]
                + [(n, ctypes.c_int) for n in _PLAN]
                + [(n, ctypes.c_float) for n in ("lr", "lam", "lam_ridge",
                                                 "beta")])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def encoder_fwd_smem_bytes(bt: int, p: int, hidden: int) -> int:
    """Shared memory of an encoder-forward block (step.cu
    ``enc_fwd_smem``): B1's tile plus a block's reduction scratch."""
    return fwd_smem_bytes(bt, p, hidden) + 4 * _RED_FLOATS


def readout_plain(readout, batch: torch.Tensor, hdec: torch.Tensor,
                  enc_len: int):
    """Plain version of B3's readout phase from the decoder states hdec
    (P, B, td, H): (douts (P, B, td, H) = dpred * ro_w, the squared error
    summed over everything, g_ro_w (P, 1, H), g_ro_b (P, 1)), with
    dpred = 2 / (B * td) * (pred - target), the gradient of the summed
    per-variable MSEs."""
    _, b, td, _ = hdec.shape
    w = readout.w[:, 0]                                   # (P, H)
    pred = torch.einsum("pbth,ph->pbt", hdec, w) + readout.b[:, :, None]
    err = pred - batch[:, enc_len:].permute(2, 0, 1)
    dpred = (2.0 / (b * td)) * err
    douts = dpred[..., None] * w[:, None, None, :]
    g_ro_w = torch.einsum("pbt,pbth->ph", dpred, hdec)[:, None]
    return douts, (err * err).sum(), g_ro_w, dpred.sum(dim=(1, 2))[:, None]


def decoder_readout_plain(params: CRVAEParams, parents: torch.Tensor,
                          batch: torch.Tensor, z: torch.Tensor,
                          enc_len: int):
    """Plain version of B3's decoder forward and readout: the p heads with
    the parents mask on W_ih, the teacher-forced input and h0 = z; returns
    (hdec (P, B, td, H), *``readout_plain``)."""
    heads = masked_heads(params.heads, parents)
    hdec, _ = gru_scan_heads(heads, decoder_input(batch, enc_len), z[None])
    return (hdec, *readout_plain(params.readout, batch, hdec, enc_len))


def latent_plain(params: CRVAEParams, mu, lv, z, h_e, dz, beta: float):
    """Plain version of B3's latent phase.  From the encoder's last state
    h_e (B, H), the latent mu, lv, z and dz (B, H), the summed d loss / d z
    of the heads: (g_mu_w, g_mu_b, g_lv_w, g_lv_b, dhe), dhe (B, H) the
    encoder's d loss / d h_E through fc_mu and fc_std."""
    c = beta / mu.shape[0]
    dmu = dz + c * mu
    dlv = 0.5 * dz * (z - mu) + 0.5 * c * (torch.exp(lv) - 1.0)
    dhe = (torch.einsum("bo,ok->bk", dmu, params.fc_mu.w)
           + torch.einsum("bo,ok->bk", dlv, params.fc_std.w))
    return (torch.einsum("bo,bk->ok", dmu, h_e), dmu.sum(0),
            torch.einsum("bo,bk->ok", dlv, h_e), dlv.sum(0), dhe)


def encoder_douts(dhe: torch.Tensor, enc_len: int) -> torch.Tensor:
    """The encoder chain's douts (B, enc_len, H): dhe at the last step,
    zero before it."""
    out = dhe.new_zeros((dhe.shape[0], enc_len, dhe.shape[1]))
    out[:, -1] = dhe
    return out


def fused_phase1_step_plain(model: CRVAE, cfg, params: CRVAEParams,
                            parents: torch.Tensor, batch: torch.Tensor,
                            eps: torch.Tensor):
    """Plain PyTorch version of B3: one ``make_phase1_step`` body without
    a prior (B3 is the KL step, as the JAX package's) on the given batch
    and eps, with the plain recurrences (``gru_scan``, ``gru_scan_heads``)
    called directly."""
    from vae_connexe_torch.train.crvae_trainer import _phase1_update

    new, _, metrics = _phase1_update(model, cfg, params, None, parents,
                                     batch, eps,
                                     recurrences=(gru_scan, gru_scan_heads))
    return new, metrics


def _flat_views(flat: torch.Tensor, shapes: dict) -> dict:
    """``flat`` cut into named views of the given shapes, end to end."""
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


@functools.cache
def _plan(b: int, t: int, p: int, hidden: int, e: int, dev: torch.device):
    """B3's tiles and chunks at one shape on ``dev`` ({StepArgs int field:
    value}), the shapes of its scratch buffers, laid end to end in one
    float32 buffer, their offsets in it (floats) and its length.  The
    encoder and the decoder forward take B1's tile rule, each with its own
    shared memory; both chains and weight-gradient kernels take B2's
    (``chain_tile``, ``wgrad_splits``), with both weights in shared memory:
    B3 has no wide variant."""
    limits = device_limits(dev)
    td = t - e
    bt_enc = pick_tile(b, 1, hidden,
                       lambda n: encoder_fwd_smem_bytes(n, p, hidden), limits)
    bt_dec = pick_tile(b, p, hidden, lambda n: fwd_smem_bytes(n, p, hidden),
                       limits)

    def chain_plan(heads: int, steps: int):
        bt = chain_tile(b, heads, p, hidden, limits)
        if bt is None:
            raise ValueError(f"B3: no chain tile fits the device's shared "
                             f"memory at p={p}, H={hidden}")
        return (bt, *wgrad_splits(b, steps, p, hidden, heads, limits[2]))

    chain_dec, splits_dec, chunk_dec = chain_plan(p, td)
    chain_enc, splits_enc, chunk_enc = chain_plan(1, e)
    plan = dict(B=b, T=t, P=p, H=hidden, E=e, bt_enc=bt_enc, bt_dec=bt_dec,
                bt_chain_dec=chain_dec, bt_chain_enc=chain_enc,
                splits_dec=splits_dec, chunk_dec=chunk_dec,
                splits_enc=splits_enc, chunk_enc=chunk_enc)
    nbe, nrc = math.ceil(b / bt_enc), math.ceil(b * td / READOUT_ROWS)
    wpf = 3 * hidden * (hidden + p + 2)     # gru_bwd.cuh wgrad_part_floats
    h = hidden
    shapes = {
        "henc": (b, e, h), "hdec": (p, b, td, h), "mu": (b, h), "lv": (b, h),
        "z": (b, h), "douts": (p, b, td, h), "gh": (p, b, td, 4 * h),
        "dz_part": (p, b, h), "douts_enc": (b, e, h),
        "gh_enc": (b, e, 4 * h), "dh0_enc": (b, h), "kl_part": (nbe,),
        "sq_part": (p, nrc), "ridge_part": (RIDGE_PARTS,), "usage": (p, p),
        "g_enc": (splits_enc, wpf), "g_hd": (p, splits_dec, wpf),
        "g_mu_w": (nbe, h, h), "g_mu_b": (nbe, h), "g_lv_w": (nbe, h, h),
        "g_lv_b": (nbe, h), "g_ro_w": (p, nrc, h), "g_ro_b": (p, nrc)}
    assert tuple(shapes) == _SCRATCH, "every StepArgs scratch field is sized"
    sizes = [math.prod(v) for v in shapes.values()]
    offsets = [sum(sizes[:k]) for k in range(len(sizes))]
    return plan, shapes, offsets, sum(sizes)


def _step_launch(model: CRVAE, cfg, params: CRVAEParams,
                 parents: torch.Tensor, batch: torch.Tensor,
                 eps: torch.Tensor):
    """B3 on CUDA tensors: returns (the updated leaves and the metrics by
    step.cu's names, the step's scratch buffer, the shapes it holds end to
    end; ``_flat_views`` cuts it into named views)."""
    from vae_connexe_torch.ops._build import step_library

    dev = batch.device
    b, t, p = batch.shape
    hidden, e = model.hidden, model.enc_len
    if p != model.p or t - e < 1:
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
    plan, shapes, offsets, total = _plan(b, t, p, hidden, e, dev)
    outs = _flat_views(
        torch.empty(sum(v.numel() for v in leaves) + len(METRICS),
                    device=dev, dtype=torch.float32),
        {n: v.shape for n, v in zip(LEAVES, leaves)}
        | {"metrics": (len(METRICS),)})
    # The scratch buffers are passed by address; no views are cut here.
    scratch = torch.empty(total, device=dev, dtype=torch.float32)
    base = scratch.data_ptr()
    ins = (batch.float().contiguous(), eps.float().contiguous(),
           parents.to(device=dev, dtype=torch.float32).contiguous(),
           *(v.contiguous() for v in leaves))
    args = StepArgs(*(v.data_ptr() for v in ins),
                    *(outs[n].data_ptr() for n in LEAVES),
                    outs["metrics"].data_ptr(),
                    *(base + 4 * o for o in offsets),
                    *(plan[n] for n in _PLAN),
                    float(cfg.lr), float(cfg.lam), float(cfg.lam_ridge),
                    float(cfg.beta))
    _launch(step_library(), "vcx_phase1_step", dev, (ctypes.byref(args),))
    LAUNCHES["phase1_step"] += 1
    return outs, scratch, shapes


def fused_phase1_step(model: CRVAE, cfg, params: CRVAEParams,
                      parents: torch.Tensor, batch: torch.Tensor,
                      eps: torch.Tensor):
    """One phase-1 step (B3).  batch (B, T, p), eps (B, H), parents (p, p).
    Returns (new CRVAEParams, {loss, recon, latent_reg, mean_loss,
    variable_usage} as 0-d tensors)."""
    if batch.device.type == "cpu":
        return fused_phase1_step_plain(model, cfg, params, parents, batch, eps)
    outs, _, _ = _step_launch(model, cfg, params, parents, batch, eps)
    new_params = tree_unflatten(params, [outs[n] for n in LEAVES])
    metrics = dict(zip(METRICS, outs["metrics"].unbind()))
    return new_params, metrics
