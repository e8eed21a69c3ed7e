"""Checkpoints and resume (port of ``vae_connexe_tpu/utils/checkpoint.py``).

A checkpoint is one file written by ``torch.save`` and read back with
``torch.load(..., weights_only=True)``: the state's tree (dataclasses,
dicts and tuples of tensors, ints, floats and None, such as an absent
prior) as nested dicts and lists of CPU tensors, and each
``torch.Generator`` as its ``get_state()`` bytes, CPU or CUDA.
Restoring walks a template of the same structure and puts every tensor
back on the template's device.  The binary GC matrix, the phase-1 to
phase-2 handoff, is saved beside a checkpoint as ``<path>.gc.npy``.

``TrainCheckpointer`` keeps mid-phase snapshots for the chunked fits:
``state_<step>`` and ``metrics_<step>.json`` under its directory, with a
``LATEST`` marker written last by an atomic rename, so a kill during a save
never spoils the previous snapshot; older snapshots are pruned after the
marker lands.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Any, Optional

import numpy as np
import torch

_GEN = "__generator_state__"


def _saveable(tree):
    """The tree as nested dicts and lists of CPU tensors and scalars."""
    if dataclasses.is_dataclass(tree):
        return {f.name: _saveable(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if type(tree) is tuple:
        return [_saveable(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, torch.Generator):
        return {_GEN: tree.get_state()}
    if tree is None or isinstance(tree, (int, float)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _restore(template, saved, where: str = "state"):
    """``saved`` shaped and placed like ``template``; a generator in the
    template is set to the saved state and returned."""
    if dataclasses.is_dataclass(template) or isinstance(template, dict):
        names = ([f.name for f in dataclasses.fields(template)]
                 if dataclasses.is_dataclass(template) else list(template))
        if not isinstance(saved, dict) or set(saved) != set(names):
            got = sorted(saved) if isinstance(saved, dict) else type(saved)
            raise KeyError(f"{where}: expected keys {sorted(names)}, got {got}")
        get = ((lambda n: getattr(template, n))
               if dataclasses.is_dataclass(template) else template.__getitem__)
        vals = {n: _restore(get(n), saved[n], f"{where}.{n}") for n in names}
        return type(template)(**vals) if dataclasses.is_dataclass(
            template) else vals
    if type(template) is tuple:
        if not isinstance(saved, list) or len(saved) != len(template):
            raise ValueError(f"{where}: expected {len(template)} entries")
        return tuple(_restore(t, s, f"{where}[{i}]")
                     for i, (t, s) in enumerate(zip(template, saved)))
    if template is None or saved is None:
        if template is not saved:
            raise ValueError(f"{where}: expected {template!r}, got "
                             f"{type(saved).__name__}")
        return None
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"{where}: expected shape {tuple(template.shape)},"
                             f" got {tuple(saved.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, torch.Generator):
        template.set_state(saved[_GEN])
        return template
    return type(template)(saved)


def _atomic_save(obj, path: pathlib.Path) -> None:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: Any, gc_matrix=None) -> None:
    """Save a state tree to the file ``path`` and, when given, the GC
    matrix beside it as ``<path>.gc.npy``."""
    p = pathlib.Path(path).absolute()
    p.parent.mkdir(parents=True, exist_ok=True)
    _atomic_save(_saveable(state), p)
    if gc_matrix is not None:
        gc = (gc_matrix.detach().cpu().numpy()
              if isinstance(gc_matrix, torch.Tensor) else np.asarray(gc_matrix))
        np.save(p.parent / (p.name + ".gc.npy"), gc)


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restore a tree of the same structure and shapes as ``target``, each
    tensor on the device of ``target``'s."""
    saved = torch.load(pathlib.Path(path).absolute(), map_location="cpu",
                       weights_only=True)
    return _restore(target, saved)


def load_gc(path: str) -> np.ndarray:
    """The GC matrix saved beside the checkpoint ``path``."""
    p = pathlib.Path(path).absolute()
    return np.load(p.parent / (p.name + ".gc.npy"))


class TrainCheckpointer:
    """Mid-phase checkpoints for the chunked ``fit_*`` loops.

    Snapshots the whole phase state (params, best params and loss, the
    optimiser's state, the generator's state, the step) at chunk
    boundaries, so a killed and resumed fit runs the remaining chunks from
    the exact state the uninterrupted fit had there.

    ``every`` is in steps: a save fires at the first chunk boundary at or
    after each period (``every`` need not divide ``check_every``) and
    always at the final step.  ``every <= 0`` saves only the final state,
    which makes a resumed finished phase a pure restore.
    """

    def __init__(self, path: str, every: int = 0):
        self.dir = pathlib.Path(path).absolute()
        self.every = int(every)
        self._last_saved: Optional[int] = None

    def latest_step(self) -> Optional[int]:
        marker = self.dir / "LATEST"
        if not marker.exists():
            return None
        return int(marker.read_text().strip())

    def save(self, state: Any, metrics: dict) -> None:
        step = int(state.step)
        self.dir.mkdir(parents=True, exist_ok=True)
        save_checkpoint(str(self.dir / f"state_{step}"), state)
        (self.dir / f"metrics_{step}.json").write_text(json.dumps(metrics))
        tmp = self.dir / "LATEST.tmp"
        tmp.write_text(str(step))
        tmp.replace(self.dir / "LATEST")
        self._prune(keep=step)
        self._last_saved = step

    def maybe_save(self, state: Any, metrics: dict, final: bool) -> bool:
        step = int(state.step)
        due = (final or (self.every > 0
                         and step - (self._last_saved or 0) >= self.every))
        if due and step != self._last_saved:
            self.save(state, metrics)
        return due

    def restore(self, template: Any):
        """``(state, metrics)`` at the latest snapshot, or None.  Primes
        the period so the next save lands one ``every`` after the restored
        step."""
        step = self.latest_step()
        if step is None:
            return None
        state = restore_checkpoint(str(self.dir / f"state_{step}"), template)
        metrics = json.loads((self.dir / f"metrics_{step}.json").read_text())
        self._last_saved = step
        return state, metrics

    def _prune(self, keep: int) -> None:
        for p in self.dir.glob("state_*"):
            if p.name != f"state_{keep}":
                p.unlink(missing_ok=True)
        for p in self.dir.glob("metrics_*.json"):
            if p.name != f"metrics_{keep}.json":
                p.unlink(missing_ok=True)
