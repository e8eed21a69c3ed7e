"""Serialized serving artifacts (port of ``vae_connexe_tpu/serving.py``).

A trained generator exports to one artifact that ``load_generator`` turns
back into ``fn(seed) -> np.ndarray (batch, rollout_len, p)`` (the crvae
family's compensated generator, ``export_generator``) or ``fn(seed,
context)`` (the win family's context-conditioned one,
``export_win_generator``: context (batch, tau, p)):

    blob = export_generator(model, err_model, params, err_params, batch=64)
    pathlib.Path("gen.vcxt").write_bytes(blob)
    fn, meta = load_generator("gen.vcxt")      # on cuda by default
    samples = fn(0)                            # deterministic per seed

Layout: 8-byte magic ``VCXTORC1`` + uint32 header length + JSON header (the
reference's keys: ``kind``, ``batch``, ``rollout_len``, ``p``, ``hidden``,
``noise_scale``, ``serve_dtype``, ``kernel``, ``platforms``, with
``torch_version`` in place of ``jax_version``) + a ``torch.save`` of the four
weight groups generation needs (masked ``heads``, ``readout``, error-VAE
``dec`` and ``out``), read back with ``weights_only=True``.  A win
artifact's header adds ``tau`` (no ``noise_scale`` or ``kernel``, as the
reference's) and its weights are the encoder, ``fc_mu``, ``fc_logsig``,
``z2h``, ``w_in``, ``heads`` and ``readout``; ``fn(seed, context)`` seeds
one generator on the device that draws the latent epsilon.

The reference bakes the program into StableHLO; here the loader rebuilds
the generator from the port's own modules, so the artifact needs this
package to run.  ``fn(seed)`` seeds one ``torch.Generator`` on the device
and draws the error VAE's h0 first, then the rollout's h0 (the order of the
reference's key split): the same seed always gives the same samples within
the port.  JAX's threefry bits are not reproduced.
"""

from __future__ import annotations

import dataclasses
import io
import json
import pathlib
import struct
from typing import Optional

import numpy as np
import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.models.crvae import (
    CRVAE,
    masked_heads,
    no_reduced_precision,
)
from vae_connexe_torch.models.crvae_win import WInCRVAE, WInCRVAEParams
from vae_connexe_torch.models.error_vae import ErrorVAE
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.train.crvae_trainer import KERNELS, generate_from_draws
from vae_connexe_torch.utils.layers import Dense

_MAGIC = b"VCXTORC1"
_KIND = "crvae_compensated_generator"
_GROUPS = {"heads": GRUParams, "readout": Dense, "dec": GRUParams,
           "out": Dense}


def export_generator(model: CRVAE, err_model: ErrorVAE, params, err_params, *,
                     batch: int, parents=None, length: Optional[int] = None,
                     platforms: Optional[list[str]] = None,
                     serve_dtype: Optional[str] = None,
                     kernel: str = "lax") -> bytes:
    """Export the compensated generator as artifact bytes.

    Args:
      model / err_model: the trained ``CRVAE`` + ``ErrorVAE`` pair.
      params / err_params: their (phase-2) parameters.
      batch: rollouts per call.
      parents: optional (p, p) binary mask the heads are projected with
        before they are saved.
      length: rollout length override (default ``model.rollout_len``).
      platforms: ``None`` or ``["cuda"]``: the port's artifacts run on the
        card.
      serve_dtype: ``None`` or ``"float32"``; bfloat16 serving is not
        ported yet.
      kernel: the reference's switch, validated and kept for its signature;
        every value serves through the CUDA rollout kernels.
    """
    if serve_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"serve_dtype must be 'float32' or 'bfloat16', "
                         f"got {serve_dtype!r}")
    no_reduced_precision(serve_dtype)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    _cuda_platforms(platforms)
    heads = params.heads if parents is None else masked_heads(params.heads, parents)
    groups = {"heads": heads, "readout": params.readout,
              "dec": err_params.dec, "out": err_params.out}
    weights = {name: {k: v.detach().cpu().contiguous()
                      for k, v in dataclasses.asdict(g).items()}
               for name, g in groups.items()}
    body = io.BytesIO()
    torch.save(weights, body)
    header = json.dumps({
        "kind": _KIND,
        "batch": batch,
        "rollout_len": model.rollout_len if length is None else length,
        "p": model.p,
        "hidden": model.hidden,
        "noise_scale": model.noise_scale,
        "serve_dtype": "float32",
        "kernel": "fused",
        "platforms": ["cuda"],
        "torch_version": torch.__version__,
    }).encode()
    return _MAGIC + struct.pack("<I", len(header)) + header + body.getvalue()


_WIN_KIND = "win_conditioned_generator"
_WIN_GROUPS = {"enc": GRUParams, "fc_mu": Dense, "fc_logsig": Dense,
               "z2h": Dense, "heads": GRUParams, "readout": Dense}


def export_win_generator(model: WInCRVAE, params, *, batch: int, length: int,
                         platforms: Optional[list[str]] = None,
                         serve_dtype: Optional[str] = None) -> bytes:
    """Export a trained W_in-family generator (``WInCRVAE``) as artifact
    bytes.

    The win generation is context-conditioned (encode the last tau context
    steps, then roll), so the loaded entry takes two arguments:
    ``fn(seed, context)`` with ``context`` float32 of shape (batch, tau,
    d); it returns (batch, length, d) forecasts.  The artifact holds the
    weights generation reads (the encoder, fc layers, z2h, W_in, heads and
    readout) and a header with the reference's keys.  ``platforms``:
    ``None`` or ``["cuda"]``; ``serve_dtype``: ``None`` or ``"float32"``
    (bfloat16, ROADMAP A5, raises).
    """
    if serve_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"serve_dtype must be 'float32' or 'bfloat16', "
                         f"got {serve_dtype!r}")
    no_reduced_precision(serve_dtype)
    _cuda_platforms(platforms)
    weights = {name: {k: v.detach().cpu().contiguous() for k, v in
                      dataclasses.asdict(getattr(params, name)).items()}
               for name in _WIN_GROUPS}
    weights["w_in"] = params.w_in.detach().cpu().contiguous()
    body = io.BytesIO()
    torch.save(weights, body)
    header = json.dumps({
        "kind": _WIN_KIND,
        "batch": batch,
        "rollout_len": length,
        "p": model.d,
        "hidden": model.hidden,
        "tau": model.tau,
        "serve_dtype": "float32",
        "platforms": ["cuda"],
        "torch_version": torch.__version__,
    }).encode()
    return _MAGIC + struct.pack("<I", len(header)) + header + body.getvalue()


def _cuda_platforms(platforms) -> None:
    if platforms is not None and [t.lower() for t in platforms] != ["cuda"]:
        raise ValueError(f"the port's artifacts run on cuda; got platforms "
                         f"{platforms}")


def load_generator(source, device=None):
    """Load a generator artifact.

    ``source``: a path or the artifact bytes.  ``device``: where it runs
    (default ``cuda``).  Returns ``(fn, meta)``: ``meta`` is the header dict
    and ``fn(seed) -> np.ndarray`` of shape (batch, rollout_len, p).
    """
    dev = resolve_device(device)
    if isinstance(source, (str, pathlib.Path)):
        data = pathlib.Path(source).read_bytes()
    else:
        data = bytes(source)
    if data[:8] != _MAGIC:
        raise ValueError(
            "not a vae_connexe_torch generator artifact (bad magic; expected "
            f"{_MAGIC!r})")
    (hlen,) = struct.unpack("<I", data[8:12])
    meta = json.loads(data[12:12 + hlen].decode())
    if meta.get("kind") not in (_KIND, _WIN_KIND):
        raise ValueError(f"unknown artifact kind {meta.get('kind')!r}; this "
                         f"build serves {_KIND!r} and {_WIN_KIND!r}")
    weights = torch.load(io.BytesIO(data[12 + hlen:]), map_location=dev,
                         weights_only=True)
    want = (set(_WIN_GROUPS) | {"w_in"} if meta["kind"] == _WIN_KIND
            else set(_GROUPS))
    if set(weights) != want:
        raise ValueError(f"artifact of kind {meta['kind']!r} holds the "
                         f"weight groups {sorted(weights)}, not "
                         f"{sorted(want)}")
    if meta["kind"] == _WIN_KIND:
        return _win_fn(meta, weights, dev), meta
    g = {name: cls(**weights[name]) for name, cls in _GROUPS.items()}
    batch, steps = meta["batch"], meta["rollout_len"]
    model = CRVAE(p=meta["p"], hidden=meta["hidden"], rollout_len=steps,
                  noise_scale=meta["noise_scale"])
    err_model = ErrorVAE(d=meta["p"], hidden=g["dec"].hidden)

    def fn(seed: int) -> np.ndarray:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        h0_err = torch.randn((batch, err_model.hidden), generator=gen,
                             device=dev)
        h0 = torch.randn((batch, model.hidden), generator=gen, device=dev)
        out = generate_from_draws(model, err_model, g["heads"], g["readout"],
                                  g["dec"], g["out"], h0_err, h0, steps)
        return out.cpu().numpy()

    return fn, meta


def _win_fn(meta: dict, weights: dict, dev):
    """``fn(seed, context)`` of a win artifact: the shape check and message
    of the reference, then ``WInCRVAE.generate`` with one generator seeded
    ``seed`` on the device drawing the latent epsilon."""
    model = WInCRVAE(d=meta["p"], hidden=meta["hidden"], tau=meta["tau"])
    g = {name: cls(**weights[name]) for name, cls in _WIN_GROUPS.items()}
    # Generation reads no error-VAE leaf.
    params = WInCRVAEParams(w_in=weights["w_in"], err=None, **g)
    shape = (meta["batch"], meta["tau"], meta["p"])

    def fn(seed: int, context) -> np.ndarray:
        ctx = torch.as_tensor(np.asarray(context, np.float32), device=dev)
        if tuple(ctx.shape) != shape:
            raise ValueError(
                f"context shape {tuple(ctx.shape)} != artifact's {shape} "
                f"(batch, tau, p); slice the last tau={meta['tau']} "
                f"steps of each series")
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        with torch.no_grad():
            out = model.generate(params, ctx, gen, meta["rollout_len"])
        return out.cpu().numpy()

    return fn
