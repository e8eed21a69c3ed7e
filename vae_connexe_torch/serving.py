"""Serialized serving artifacts (port of ``vae_connexe_tpu/serving.py``).

A trained generator exports to one self-contained artifact that
``load_generator`` turns back into ``fn(seed) -> np.ndarray (batch,
rollout_len, p)`` (the crvae family's compensated generator,
``export_generator``) or ``fn(seed, context)`` (the win family's
context-conditioned one, ``export_win_generator``: context (batch, tau,
p)), in any later process, without the model code:

    blob = export_generator(model, err_model, params, err_params, batch=64)
    pathlib.Path("gen.vcxt").write_bytes(blob)
    fn, meta = load_generator("gen.vcxt")      # on cuda by default
    samples = fn(0)                            # deterministic per seed

The artifact is a ``torch.export`` program with the (masked, optionally
bfloat16) weights as buffers.  Its inputs are the random draws: the error
VAE's h0 and the rollout's h0 (crvae), or the context and the latent
epsilon (win); its body calls the kernels as the custom ops of
``ops/library.py`` (K2 then K1; B1 for the win encoder, whose free run is
plain PyTorch ops, as JAX's is a ``lax.scan``).  ``load_generator`` needs
only ``torch``, numpy and ``ops/library.py``: it seeds one
``torch.Generator`` on the device, draws the error VAE's h0 first and the
rollout's h0 second (the order of the reference's key split; the win
entry draws its epsilon), and calls the program, so an artifact gives the
samples in-process generation gives from a generator of the same seed.
JAX's threefry bits are not reproduced.

Layout: 8-byte magic ``VCXTORC2`` + uint32 header length + JSON header
(the reference's keys: ``kind``, ``batch``, ``rollout_len``, ``p``,
``hidden``, ``noise_scale``, ``serve_dtype``, ``kernel``, ``platforms``,
with ``torch_version`` in place of ``jax_version`` and ``err_hidden``, the
width of the error VAE's draw; a win artifact has ``tau`` and ``latent``
and no ``noise_scale`` or ``kernel``) + the ``torch.export.save`` bytes.
``platforms`` lists the devices the artifact may run on (``cuda``,
``cpu``); a load on another raises.  The program is exported on the CPU
and moved to the device it is loaded on.  The first layout
(``VCXTORC1``, weights that only the port's model code could rebuild)
raises with a message to re-export.
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

import vae_connexe_torch.ops.library  # noqa: F401  (registers the ops)
from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.ops.cuda_rollout import serve_dtype as _serve_dtype

_MAGIC = b"VCXTORC2"
_OLD_MAGIC = b"VCXTORC1"
_KIND = "crvae_compensated_generator"
_WIN_KIND = "win_conditioned_generator"
PLATFORMS = ("cuda", "cpu")


def _platforms(platforms, weights: torch.Tensor) -> list[str]:
    """The artifact's platforms: ``platforms`` (a subset of ``PLATFORMS``),
    or the weights' device type by default."""
    if platforms is None:
        return [weights.device.type]
    got = [t.lower() for t in platforms]
    if not got or any(t not in PLATFORMS for t in got):
        raise ValueError(f"platforms must be some of {list(PLATFORMS)}, got "
                         f"{platforms}")
    return list(dict.fromkeys(got))


def _add_buffers(module: torch.nn.Module, name: str, group,
                 dtype: torch.dtype) -> None:
    """Each leaf of the weight group as a CPU buffer ``<name>_<leaf>``."""
    for f in dataclasses.fields(group):
        module.register_buffer(
            f"{name}_{f.name}",
            getattr(group, f.name).detach().to("cpu", dtype).contiguous())


def _leaves(module: torch.nn.Module, name: str, fields=("w_ih", "w_hh",
                                                        "b_ih", "b_hh")):
    return [getattr(module, f"{name}_{f}") for f in fields]


class _CompensatedProgram(torch.nn.Module):
    """(h0_err (B, H_err), h0 (B, H)) -> (B, steps, p) float32: K2 from
    h0_err, its leading zero step kept and the sequence cut to ``steps``,
    then K1 from x0 = 0 and h0 with that noise (``generate_from_draws``)."""

    def __init__(self, groups: dict, dtype: torch.dtype, p: int, steps: int,
                 noise_scale: float):
        super().__init__()
        for name, group in groups.items():
            _add_buffers(self, name, group, dtype)
        self.p, self.steps, self.noise_scale = p, steps, noise_scale

    def forward(self, h0_err: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        b, p = h0.shape[0], self.p
        errs = torch.ops.vae_connexe.errvae_sample(
            *_leaves(self, "dec"), self.out_w, self.out_b, h0_err, p,
            self.steps)
        noise = torch.cat([torch.zeros((b, 1, p), device=h0.device), errs],
                          dim=1)[:, :self.steps]
        return torch.ops.vae_connexe.crvae_free_run(
            *_leaves(self, "heads"), self.readout_w, self.readout_b,
            torch.zeros((b, p), device=h0.device), h0, noise,
            self.noise_scale)


def _header_and_program(header: dict, module: torch.nn.Module,
                        example: tuple) -> bytes:
    program = torch.export.export(module, example)
    body = io.BytesIO()
    torch.export.save(program, body)
    head = json.dumps({**header, "torch_version": torch.__version__}).encode()
    return _MAGIC + struct.pack("<I", len(head)) + head + body.getvalue()


def export_generator(model, err_model, params, err_params, *, batch: int,
                     parents=None, length: Optional[int] = None,
                     platforms: Optional[list[str]] = None,
                     serve_dtype: Optional[str] = None,
                     kernel: str = "lax") -> bytes:
    """Export the compensated generator as artifact bytes.

    Args:
      model / err_model: the trained ``CRVAE`` + ``ErrorVAE`` pair.
      params / err_params: their (phase-2) parameters, baked into the
        artifact as buffers.
      batch: rollouts per call.
      parents: optional (p, p) binary mask the heads are projected with.
      length: rollout length override (default ``model.rollout_len``).
      platforms: the devices it may run on, some of ``["cuda", "cpu"]``;
        default the device the weights lie on.
      serve_dtype: ``"float32"`` (default) or ``"bfloat16"``: the weights
        are stored in bf16 and both rollouts run the kernels' bf16
        instantiations (float32 output), as ``generate_with_compensation(
        dtype=torch.bfloat16)``.
      kernel: the reference's switch, validated and kept for its
        signature; every value serves through the rollout kernels.
    """
    from vae_connexe_torch.models.crvae import masked_heads
    from vae_connexe_torch.train.crvae_trainer import KERNELS

    dtype = _serve_dtype(serve_dtype, "serve_dtype")
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    heads = params.heads if parents is None else masked_heads(params.heads, parents)
    plats = _platforms(platforms, heads.w_ih)
    steps = model.rollout_len if length is None else length
    module = _CompensatedProgram(
        {"heads": heads, "readout": params.readout, "dec": err_params.dec,
         "out": err_params.out}, dtype, model.p, steps,
        model.noise_scale)
    example = (torch.zeros((batch, err_model.hidden)),
               torch.zeros((batch, model.hidden)))
    return _header_and_program({
        "kind": _KIND,
        "batch": batch,
        "rollout_len": steps,
        "p": model.p,
        "hidden": model.hidden,
        "err_hidden": err_model.hidden,
        "noise_scale": model.noise_scale,
        "serve_dtype": str(dtype).removeprefix("torch."),
        "kernel": "fused",
        "platforms": plats,
    }, module, example)


class _WinProgram(torch.nn.Module):
    """(context (B, tau, d), eps (B, Z)) -> (B, length, d) float32: the
    encoder through B1, z = mu + exp(logsig) * eps, h0 = tanh(z2h(z)) for
    every head, then ``crvae_win.win_rollout`` in ``dtype``."""

    def __init__(self, params, dtype: torch.dtype, length: int):
        super().__init__()
        for name in ("enc", "fc_mu", "fc_logsig", "z2h"):
            _add_buffers(self, name, getattr(params, name), torch.float32)
        for name in ("heads", "readout"):
            _add_buffers(self, name, getattr(params, name), dtype)
        self.register_buffer("w_in",
                             params.w_in.detach().to("cpu", dtype).contiguous())
        self.dtype, self.length = dtype, length

    def forward(self, context: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        from vae_connexe_torch.models.crvae_win import win_rollout
        from vae_connexe_torch.ops.gru import GRUParams
        from vae_connexe_torch.utils.layers import Dense, dense

        b, d = context.shape[0], context.shape[-1]
        enc = [t[None] for t in _leaves(self, "enc")]
        h0 = torch.zeros((1, b, self.enc_w_hh.shape[-1]),
                         device=context.device)
        h_t = torch.ops.vae_connexe.gru_forward(*enc, context, h0)[0, :, -1]
        mu = dense(Dense(self.fc_mu_w, self.fc_mu_b), h_t)
        logsig = dense(Dense(self.fc_logsig_w, self.fc_logsig_b), h_t)
        z = mu + torch.exp(logsig) * eps
        h = torch.tanh(dense(Dense(self.z2h_w, self.z2h_b), z)).expand(d, -1,
                                                                       -1)
        return win_rollout(self.w_in, GRUParams(*_leaves(self, "heads")),
                           Dense(self.readout_w, self.readout_b),
                           context[:, -1, :], h, self.length, self.dtype)


def export_win_generator(model, params, *, batch: int, length: int,
                         platforms: Optional[list[str]] = None,
                         serve_dtype: Optional[str] = None) -> bytes:
    """Export a trained W_in-family generator (``WInCRVAE``) as artifact
    bytes.

    The win generation is context-conditioned (encode the last tau context
    steps, then roll), so the loaded entry takes two arguments:
    ``fn(seed, context)`` with ``context`` float32 of shape (batch, tau,
    d); it returns (batch, length, d) forecasts.  ``platforms`` as in
    ``export_generator``; ``serve_dtype="bfloat16"`` stores the rollout's
    weights in bf16 and runs its free run in bf16 (the one-pass encoder
    stays float32), as ``WInCRVAE.generate(dtype=torch.bfloat16)``.
    """
    dtype = _serve_dtype(serve_dtype, "serve_dtype")
    plats = _platforms(platforms, params.w_in)
    module = _WinProgram(params, dtype, length)
    example = (torch.zeros((batch, model.tau, model.d)),
               torch.zeros((batch, model.latent)))
    return _header_and_program({
        "kind": _WIN_KIND,
        "batch": batch,
        "rollout_len": length,
        "p": model.d,
        "hidden": model.hidden,
        "latent": model.latent,
        "tau": model.tau,
        "serve_dtype": str(dtype).removeprefix("torch."),
        "platforms": plats,
    }, module, example)


def load_generator(source, device=None):
    """Load a generator artifact.

    ``source``: a path or the artifact bytes.  ``device``: where it runs
    (default ``cuda``); it must be one of the artifact's ``platforms``.
    Returns ``(fn, meta)``: ``meta`` is the header dict; ``fn(seed) ->
    np.ndarray`` of shape (batch, rollout_len, p), or for a win artifact
    ``fn(seed, context)``.  Imports no model or trainer code.
    """
    dev = resolve_device(device)
    if isinstance(source, (str, pathlib.Path)):
        data = pathlib.Path(source).read_bytes()
    else:
        data = bytes(source)
    if data[:8] == _OLD_MAGIC:
        raise ValueError(
            "this artifact has the first layout (VCXTORC1: weights that only "
            "the model code could rebuild); re-export it with "
            "export_generator / export_win_generator or `cli export`")
    if data[:8] != _MAGIC:
        raise ValueError(
            "not a vae_connexe_torch generator artifact (bad magic; expected "
            f"{_MAGIC!r})")
    (hlen,) = struct.unpack("<I", data[8:12])
    meta = json.loads(data[12:12 + hlen].decode())
    if meta.get("kind") not in (_KIND, _WIN_KIND):
        raise ValueError(f"unknown artifact kind {meta.get('kind')!r}; this "
                         f"build serves {_KIND!r} and {_WIN_KIND!r}")
    if dev.type not in meta["platforms"]:
        raise ValueError(f"the artifact runs on {meta['platforms']}, not on "
                         f"{dev.type}; export it with platforms="
                         f"[{dev.type!r}]")
    program = torch.export.load(io.BytesIO(data[12 + hlen:]))
    batch = meta["batch"]
    want = ([(batch, meta.get("tau"), meta.get("p")),
             (batch, meta.get("latent"))] if meta["kind"] == _WIN_KIND else
            [(batch, meta.get("err_hidden")), (batch, meta.get("hidden"))])
    names = set(program.graph_signature.user_inputs)
    got = [tuple(n.meta["val"].shape) for n in program.graph.nodes
           if n.op == "placeholder" and n.name in names]
    if got != want:
        raise ValueError(f"artifact of kind {meta['kind']!r}: its program "
                         f"takes inputs of shapes {got}, its header says "
                         f"{want}")
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    run = program.module()

    if meta["kind"] == _WIN_KIND:
        shape = (batch, meta["tau"], meta["p"])

        def fn(seed: int, context) -> np.ndarray:
            ctx = torch.as_tensor(np.asarray(context, np.float32), device=dev)
            if tuple(ctx.shape) != shape:
                raise ValueError(
                    f"context shape {tuple(ctx.shape)} != artifact's {shape} "
                    f"(batch, tau, p); slice the last tau={meta['tau']} "
                    f"steps of each series")
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            eps = torch.randn((batch, meta["latent"]), generator=gen,
                              device=dev)
            with torch.no_grad():
                return run(ctx, eps).cpu().numpy()

        return fn, meta

    def fn(seed: int) -> np.ndarray:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        h0_err = torch.randn((batch, meta["err_hidden"]), generator=gen,
                             device=dev)
        h0 = torch.randn((batch, meta["hidden"]), generator=gen, device=dev)
        with torch.no_grad():
            return run(h0_err, h0).cpu().numpy()

    return fn, meta
