"""Out-of-core streaming fits backed by the native window loader (port of
``vae_connexe_tpu/train/streaming.py``).

The in-memory ``fit_phase1``/``fit_phase2`` hold every window on the
device and gather each minibatch there.  For series whose windows do not
fit, these variants keep the series on disk (or in host memory) behind
``data.native_loader.NativeWindowLoader`` and feed each step its batch from
the host.

They equal the in-memory fits bit for bit, resume included: the steps are
``make_phase1_step``/``make_phase2_step`` with ``stream=True``, which draw
their indices from the fit's generator and discard them, so the
generator's draws are the in-memory fit's; and the host knows which
windows to gather by replaying those draws.  JAX replays its threefry key
chain on the host; a CUDA generator's Philox stream cannot be replayed on
the CPU, so at each chunk the host mirror (``_index_chunk``) replays the
chunk's draws on a clone of the generator, on the generator's own device,
in the step's order (the indices, epsilon, and in phase 2 the error VAE's
epsilon), and copies the chunk's indices to the host once.  The mirror
starts from the generator as the first step sees it (after the GMM prior's
draws and, on a resumed fit, as restored) and runs one chunk ahead.

Pipelining: a host thread gathers the next chunk with the C++ loader into
pinned memory while the card runs the current one; the chunk goes to the
device with one non-blocking copy.  Chunks are check_every chunks split so
that a host block stays under ``io_budget_bytes``.

With ``mesh=`` (``parallel/mesh.py``) each rank replays the whole draws,
as the meshed steps draw them, and gathers only its dp slice of each
batch's indices: every chunk lands on the rank dp-sliced, and the steps
are the meshed in-memory fits' (``train/crvae_trainer.py``), bit for bit.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from vae_connexe_torch.data.native_loader import NativeWindowLoader
from vae_connexe_torch.models.crvae import CRVAE, CRVAEParams
from vae_connexe_torch.models.error_vae import ErrorVAE, ErrorVAEParams
from vae_connexe_torch.optim.adam import adam_init
from vae_connexe_torch.train.config import (
    Phase1Config,
    Phase2Config,
    check_latent_reg,
)
from vae_connexe_torch.train.crvae_trainer import (
    Phase1State,
    Phase2State,
    _chunk_lengths,
    _init_prior,
    _gathered,
    _make_checkpointer,
    _mesh_checks,
    _restore_if_resuming,
    _run_chunked,
    _shard_state,
    _sp_context,
    _stepper,
    make_phase1_step,
    make_phase2_step,
)


def _index_chunk(mirror: torch.Generator, length: int, batch_size: int,
                 n_windows: int, draws) -> np.ndarray:
    """Replay ``length`` steps' draws on ``mirror`` (advancing it): each
    step's indices over ``n_windows``, then one normal draw of each shape of
    ``draws``.  Returns the (length, B) indices, copied to the host once."""
    dev = mirror.device
    idxs = []
    for _ in range(length):
        idxs.append(torch.randint(0, n_windows, (batch_size,),
                                  generator=mirror, device=dev))
        for shape in draws:
            torch.randn(shape, generator=mirror, device=dev)
    return torch.stack(idxs).cpu().numpy()


def _io_chunks(max_iter: int, check_every: int, step_bytes: int,
               io_budget_bytes: int) -> list[list[int]]:
    """The check_every chunks of the in-memory fit, each split into
    sub-chunks whose host block stays under the IO budget."""
    cap = max(1, io_budget_bytes // max(1, step_bytes))
    groups = []
    for length in _chunk_lengths(max_iter, check_every):
        full, rem = divmod(length, cap)
        groups.append([cap] * full + ([rem] if rem else []))
    return groups


def _remaining(groups: list[list[int]], start: int) -> list[int]:
    """The sub-chunk lengths of the groups a fit resumed at step ``start``
    still runs (``_run_chunked`` raises if ``start`` is not a boundary)."""
    lengths, end = [], 0
    for group in groups:
        end += sum(group)
        if end > start:
            lengths += group
    return lengths


def _rank_rows(batch_sharding, batch_size: int) -> slice:
    """The rows of each batch this rank gathers: its dp slice, or all."""
    if batch_sharding is None:
        return slice(None)
    from vae_connexe_torch.parallel.mesh import axis_index, axis_size

    k = batch_size // axis_size(batch_sharding.mesh, "dp")
    d = axis_index(batch_sharding.mesh, "dp")
    return slice(d * k, (d + 1) * k)


def _gather_chunk(loader: NativeWindowLoader, idxs: np.ndarray, context: int,
                  pin: bool) -> torch.Tensor:
    """(length, B) start indices -> a (length, B, context, p) float32 host
    block (pinned when ``pin``) filled by one native gather."""
    length, batch = idxs.shape
    block = torch.empty((length, batch, context, loader.p), pin_memory=pin)
    loader.gather(idxs.reshape(-1), context,
                  out=block.numpy().reshape(length * batch, context, loader.p))
    return block


def _streamed_batches(loader, context: int, generator: torch.Generator,
                      lengths: list[int], batch_size: int, n_windows: int,
                      draws, device: torch.device, pool: ThreadPoolExecutor,
                      io_stats: dict, rows: slice = slice(None)):
    """Yield every step's batch on ``device``, chunk by chunk: the next
    chunk's indices are replayed and its gather submitted to ``pool``
    before the current chunk's steps are yielded.  Adds the time spent
    waiting on a gather to ``io_stats["gather_wait_s"]``.  ``rows``: the
    batch rows this rank gathers (its dp slice on a mesh)."""
    mirror = torch.Generator(device=generator.device)
    mirror.set_state(generator.get_state())
    pin = device.type == "cuda"

    def prepare(length):
        idxs = _index_chunk(mirror, length, batch_size, n_windows, draws)
        return pool.submit(_gather_chunk, loader,
                           np.ascontiguousarray(idxs[:, rows]), context, pin)

    fut = prepare(lengths[0]) if lengths else None
    for i, length in enumerate(lengths):
        t0 = time.perf_counter()
        block = fut.result()
        io_stats["gather_wait_s"] += time.perf_counter() - t0
        io_stats["chunks"] += 1
        chunk = block.to(device, non_blocking=True)
        if i + 1 < len(lengths):
            fut = prepare(lengths[i + 1])
        for s in range(length):
            yield chunk[s]


def fit_phase1_streaming(model: CRVAE, params: CRVAEParams,
                         loader: NativeWindowLoader, context: int,
                         parents: torch.Tensor, cfg: Phase1Config,
                         generator: torch.Generator,
                         n_windows: Optional[int] = None,
                         verbose: bool = False, log_fn=print, callback=None,
                         io_budget_bytes: int = 128 << 20, mesh=None,
                         io_stats: Optional[dict] = None,
                         checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 0, resume: bool = False):
    """Phase 1 with host-streamed minibatches; bit for bit ``fit_phase1``
    on ``arrange_input(series, context)[0]`` of the same series and
    generator.  Returns what ``fit_phase1`` does.

    The fit runs on ``parents``'s device.  ``n_windows`` defaults to
    ``loader.t - context``, the ``arrange_input`` window count the
    in-memory fit draws over.  With ``cfg.resample_batches`` false the one
    fixed batch is drawn from ``generator`` as ``fit_phase1`` draws it and
    gathered through the loader.  ``io_stats``, if given, is filled with
    ``gather_wait_s`` (wall time the loop waited on the next host block)
    and ``chunks``.  ``checkpoint_dir`` / ``checkpoint_every`` /
    ``resume`` as in ``fit_phase1``; on resume the host mirror restarts
    from the restored generator.  ``mesh`` as in ``fit_phase1``: each
    rank gathers its dp slice of every batch (module doc).
    """
    check_latent_reg(cfg)
    bs = _mesh_checks(mesh, model, cfg, context)
    rows = _rank_rows(bs, cfg.batch_size)
    dev = parents.device
    if n_windows is None:
        n_windows = loader.t - context
    prior = _init_prior(cfg, model, generator, dev)
    if not cfg.resample_batches:
        idx = torch.randint(0, n_windows, (cfg.batch_size,),
                            generator=generator, device=generator.device)
        fixed = torch.from_numpy(
            loader.gather(idx.cpu().numpy()[rows], context)).to(dev)
        step = make_phase1_step(model, cfg, None, parents, fixed,
                                batch_sharding=bs, n_windows=n_windows)
    else:
        step = make_phase1_step(model, cfg, None, parents, batch_sharding=bs,
                                stream=True, n_windows=n_windows)
    state = Phase1State(params=params, prior=prior, best_params=params,
                        best_loss=torch.tensor(float("inf"), device=dev),
                        generator=generator, step=0)
    state, sharding = _shard_state(state, mesh)
    ckpt = _make_checkpointer(checkpoint_dir, checkpoint_every, mesh,
                              sharding)
    state, resume_metrics = _restore_if_resuming(ckpt, state, resume)
    stats = {"gather_wait_s": 0.0, "chunks": 0}
    with ThreadPoolExecutor(1) as pool:
        batches = None
        if cfg.resample_batches:
            groups = _io_chunks(cfg.max_iter, cfg.check_every,
                                cfg.batch_size * context * model.p * 4,
                                io_budget_bytes)
            batches = _streamed_batches(
                loader, context, state.generator,
                _remaining(groups, int(state.step)), cfg.batch_size,
                n_windows, [(cfg.batch_size, model.hidden)], dev, pool,
                stats, rows)
        with _sp_context(mesh):
            state, metrics = _run_chunked(_stepper(step, "phase1", batches),
                                          state, cfg, ckpt, resume_metrics,
                                          verbose, log_fn, callback, "phase1")
    if io_stats is not None:
        io_stats.update(stats)
    return _gathered(state.best_params, mesh), state, metrics


def fit_phase2_streaming(model: CRVAE, err_model: ErrorVAE,
                         params: CRVAEParams, err_params: ErrorVAEParams,
                         loader: NativeWindowLoader, context: int,
                         parents: torch.Tensor, cfg: Phase2Config,
                         generator: torch.Generator,
                         n_windows: Optional[int] = None,
                         verbose: bool = False, log_fn=print, callback=None,
                         io_budget_bytes: int = 128 << 20, mesh=None,
                         checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 0, resume: bool = False, *,
                         io_stats: Optional[dict] = None):
    """Phase 2 with host-streamed minibatches; bit for bit ``fit_phase2``
    on the same series and generator (the phase-2 step always resamples).
    Returns what ``fit_phase2`` does.  The arguments as in
    ``fit_phase1_streaming``; each step's replayed draws are its indices,
    epsilon (B, H) and the error VAE's epsilon (B, Z)."""
    check_latent_reg(cfg)
    bs = _mesh_checks(mesh, model, cfg, context)
    rows = _rank_rows(bs, cfg.batch_size)
    dev = parents.device
    if n_windows is None:
        n_windows = loader.t - context
    prior = _init_prior(cfg, model, generator, dev)
    step = make_phase2_step(model, err_model, cfg, None, parents,
                            batch_sharding=bs, stream=True,
                            n_windows=n_windows)
    state = Phase2State(params=params, err_params=err_params,
                        err_opt=adam_init(err_params), prior=prior,
                        best_params=params,
                        best_loss=torch.tensor(float("inf"), device=dev),
                        generator=generator, step=0)
    state, sharding = _shard_state(state, mesh)
    ckpt = _make_checkpointer(checkpoint_dir, checkpoint_every, mesh,
                              sharding)
    state, resume_metrics = _restore_if_resuming(ckpt, state, resume)
    stats = {"gather_wait_s": 0.0, "chunks": 0}
    groups = _io_chunks(cfg.max_iter, cfg.check_every,
                        cfg.batch_size * context * model.p * 4,
                        io_budget_bytes)
    with ThreadPoolExecutor(1) as pool:
        batches = _streamed_batches(
            loader, context, state.generator,
            _remaining(groups, int(state.step)), cfg.batch_size, n_windows,
            [(cfg.batch_size, model.hidden),
             (cfg.batch_size, err_model.latent)], dev, pool, stats, rows)
        with _sp_context(mesh):
            state, metrics = _run_chunked(_stepper(step, "phase2", batches),
                                          state, cfg, ckpt, resume_metrics,
                                          verbose, log_fn, callback, "phase2")
    if io_stats is not None:
        io_stats.update(stats)
    return (_gathered(state.best_params, mesh), state.err_params, state,
            metrics)
