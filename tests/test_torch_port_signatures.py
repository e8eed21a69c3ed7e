"""Every public callable that both packages define under the same dotted
name takes JAX's positional parameters in JAX's order.

The walk covers every module of ``vae_connexe_torch`` that has a
counterpart of the same dotted name in ``vae_connexe_tpu``: each public
function and class defined there, each class's ``__init__`` (for a
dataclass, its field order) and each public method both classes define.
A module added to the port later is walked too.  It would have caught
F1 (``ErrorVAE.__init__``'s positional order), F3 (``fit_phase1`` without
``checkpoint_every``) and F4 (``CRVAE.rollout``,
``CRVAE.conditioned_rollout``, ``ErrorVAE.sample`` and the initialisers'
``device`` in ``dtype``'s place).

The only exceptions, each documented where the port defines it:

- ``key`` becomes ``generator`` in the same place, or the draw tensor the
  port takes in its place (``eps``, ``h0``, ``eps_z``, ...), and ``keys``
  (one a seed) becomes ``generators``;
- trailing port-only parameters that are draws (``DRAWS``) or the port's
  ``device``, which every entry point takes after JAX's parameters;
- JAX parameters of features the port does not have yet (``UNPORTED``,
  each with the ROADMAP item or the reason), dropped from JAX's side.
Port-only parameters of any other kind are keyword-only.
"""

import importlib
import inspect
import pkgutil

import vae_connexe_torch

DRAWS = {"generator", "eps", "h0", "noise", "idx", "x0_draw", "noise_draw",
         "eps_z", "eps_e", "eps_err", "coins", "comp"}
PORT_EXTRAS = DRAWS | {"device"}
UNPORTED = {
    "interpret": "Pallas interpret mode: the CPU runs the plain versions",
}
# ... and of one callable only.
UNPORTED_IN = {
    "vae_connexe_torch.train.crvae_trainer.make_phase2_step": {
        "err_opt": "the written-out Adam at cfg.lr_error (optim/adam.py)"},
}
_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind in _POS]


def _defined_in(obj, module) -> bool:
    return getattr(obj, "__module__", None) == module.__name__


def shared_callables():
    """[(dotted name, port callable, JAX callable)] of every public
    function, ``__init__`` and method defined under the same dotted name
    in both packages."""
    pairs = []
    for info in pkgutil.walk_packages(vae_connexe_torch.__path__,
                                      "vae_connexe_torch."):
        port = importlib.import_module(info.name)
        name = "vae_connexe_tpu" + info.name[len("vae_connexe_torch"):]
        try:
            ref = importlib.import_module(name)
        except ModuleNotFoundError:
            continue
        for attr, obj in vars(port).items():
            other = getattr(ref, attr, None)
            if (attr.startswith("_") or other is None
                    or not _defined_in(obj, port)
                    or not _defined_in(other, ref)):
                continue
            if inspect.isclass(obj):
                for meth in ["__init__"] + sorted(vars(obj)):
                    f, g = vars(obj).get(meth), getattr(other, meth, None)
                    if ((meth.startswith("_") and meth != "__init__")
                            or not inspect.isfunction(f)
                            or not inspect.isfunction(g)):
                        continue
                    pairs.append((f"{info.name}.{attr}.{meth}", f, g))
            elif inspect.isfunction(obj) and callable(other):
                # ``callable``: the JAX side may be a ``jax.jit`` wrapper.
                pairs.append((f"{info.name}.{attr}", obj, other))
    return pairs


def mismatch(name, port_fn, ref_fn):
    """None when the port's positional names are JAX's under the
    documented exceptions, else a description."""
    got = _positional(port_fn)
    skip = UNPORTED.keys() | UNPORTED_IN.get(name, {}).keys()
    want = [n for n in _positional(ref_fn) if n not in skip]
    if len(got) < len(want):
        return f"port {got} lacks JAX's {want[len(got):]} (JAX {want})"
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w and not (w == "key" and g in DRAWS) and not (
                w == "keys" and g == "generators"):
            return f"position {i}: port {g!r}, JAX {w!r} (port {got}, JAX {want})"
    extra = [n for n in got[len(want):] if n not in PORT_EXTRAS]
    if extra:
        return (f"port-only positional {extra} are neither draws nor the "
                f"device (port {got}, JAX {want})")
    return None


def test_shared_callables_take_jax_positional_parameters():
    pairs = shared_callables()
    checked = {name for name, _, _ in pairs}
    print(f"{len(pairs)} shared callables checked:\n" + "\n".join(sorted(checked)))
    # The walk reaches the sites of F1, F3 and F4 and this slice's modules.
    for name in ("models.error_vae.ErrorVAE.__init__",
                 "models.error_vae.ErrorVAE.sample",
                 "models.crvae.CRVAE.rollout",
                 "models.crvae.CRVAE.conditioned_rollout",
                 "train.crvae_trainer.fit_phase1", "ops.gru.init_gru",
                 "ops.gru.init_stacked_gru", "utils.layers.init_dense",
                 "utils.layers.init_stacked_dense",
                 "models.crvae_win.WInCRVAE.forward",
                 "models.crvae_win.WInCRVAEParams.__init__",
                 "train.win_trainer.WInTrainer.fit_many",
                 "data.henon.coupled_henon", "data.var.var_process",
                 "optim.prox.proximal_sgd", "losses.kl.kl_gaussian_logsigma",
                 "serving.export_win_generator", "discover.discover",
                 "train.crvae_trainer.Phase1State.__init__",
                 "train.crvae_trainer.Phase2State.__init__",
                 "losses.cs_divergence.cs_divergence_gmm",
                 "models.gmm_prior.init_gmm_prior",
                 "models.csrae.MixtureCSRAE.sample",
                 "train.csrae_trainer.fit_csrae", "ops.rnn_cells.lstm_scan",
                 "models.vrae.VRAE.decode", "models.vrae.VRAE.forward",
                 "train.vrae_trainer.fit_vrae",
                 "data.timegan_utils.train_test_divide",
                 "utils.debug.nan_debugging", "utils.profiling.trace",
                 "utils.scalers.minmax_scale",
                 "train.streaming.fit_phase1_streaming",
                 "train.streaming.fit_phase2_streaming",
                 "train.crvae_trainer.make_phase1_step",
                 "train.crvae_trainer.make_phase2_step",
                 "data.native_loader.NativeWindowLoader.__init__",
                 "data.native_loader.NativeWindowLoader.gather",
                 "serving.export_generator", "serving.load_generator",
                 "parallel.mesh.make_mesh", "parallel.mesh.global_device_put",
                 "parallel.mesh.shard_crvae_params",
                 "parallel.multihost.initialize_multihost",
                 "parallel.sharded.make_sharded_phase1_step",
                 "parallel.sharded.make_sharded_phase2_step",
                 "parallel.sharded.check_sp_compat",
                 "parallel.seq_parallel.seq_sharded_gru_heads",
                 "parallel.seq_parallel.seq_sharded_gru",
                 "parallel.serve.make_sharded_generator",
                 "parallel.multiprocess.launch_multiprocess_fit",
                 "parallel.multiprocess.launch_multiprocess_experiment",
                 "parallel.multiprocess.worker_main",
                 "ops.dispatch.set_seq_parallel", "ops.dispatch.seq_parallel"):
        assert f"vae_connexe_torch.{name}" in checked, name
    bad = {name: why for name, f, g in pairs
           if (why := mismatch(name, f, g)) is not None}
    assert not bad, "\n".join(f"{k}: {v}" for k, v in sorted(bad.items()))


def test_version_matches_jax():
    import vae_connexe_tpu

    assert vae_connexe_torch.__version__ == vae_connexe_tpu.__version__
