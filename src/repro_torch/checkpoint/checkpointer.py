"""Atomic, asynchronous checkpoints (port of
``repro.checkpoint.checkpointer``), in the JAX package's on-disk format.

  * A checkpoint is a directory ``step_<N>/`` holding one ``.npy`` file per
    leaf of a nested dict/list tree (leaves named by their ``/``-joined
    path, dict keys sorted, numbered in that order) and ``manifest.json``
    with the leaf files, the step, the caller's metadata (the data
    pipeline's state) and ``format: 1``. No orbax.
  * Writes go to ``step_<N>.tmp/`` and commit with one ``os.rename``: a
    crash mid-write never leaves a directory that restore would read.
  * :meth:`Checkpointer.save_async` copies every leaf to the host at call
    time and writes the files on a writer thread, so training goes on
    while the disk works.
  * ``keep_last`` older checkpoints are removed after each commit.

Leaves may be ``torch.Tensor``s (on any device) or numpy arrays. A port
train state is written through
:func:`repro_torch.interop.to_jax_train_state`, which lays it out as the
JAX package's train state (``params/...``, ``opt/...``, ``step``,
``err/...``, layers stacked), so each package reads the other's
checkpoints.

On a mesh every leaf is stored unsharded: ``to_jax_train_state`` of a
sharded model gathers each leaf to its whole tensor on every rank, and the
writer rank (rank 0 of the default process group) writes it while the
others wait at a barrier. :meth:`Checkpointer.restore` with
``shardings`` (a tree of :class:`repro_torch.parallel.shard.Placement`s
matching the template, None for a whole leaf) cuts each stored array to
the rank's shard of TODAY's mesh, so a checkpoint restores onto any mesh
(:func:`repro_torch.runtime.elastic.elastic_restore`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """``{path: leaf}`` in the JAX package's order (sorted dict keys)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, {kk[len(k) + 1:]: vv
                                       for kk, vv in flat.items()
                                       if kk == k or kk.startswith(k + "/")})
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, {kk[len(str(i)) + 1:]: vv
                                for kk, vv in flat.items()
                                if kk == str(i) or kk.startswith(f"{i}/")})
            for i, v in enumerate(template))
    return _leaf_like(flat[""], template)


def _leaf_like(arr: np.ndarray, template):
    """A loaded array on the template leaf's device and dtype (a tensor
    template), or as stored (anything else)."""
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(arr if arr.flags.c_contiguous
                             else np.array(arr, order="C"))
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf {tuple(t.shape)} does not "
                             f"match the template's {tuple(template.shape)}")
        return t.to(device=template.device, dtype=template.dtype)
    return arr


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def to_host(tree):
    """Every leaf of ``tree`` as a host numpy array: tensors (on either
    device) are copied, so later in-place updates do not reach the copy;
    numpy leaves are taken as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return _to_host(tree)


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def _barrier() -> None:
    if _distributed():
        import torch.distributed as dist
        dist.barrier()


class Checkpointer:
    """Rank 0 of the default process group writes, where one runs; with
    several ranks :meth:`save` and :meth:`wait` are collective (every rank
    calls them)."""

    def __init__(self, directory: str, keep_last: int = 3):
        import torch.distributed as dist

        self.dir = directory
        self.keep_last = keep_last
        self.writer = not _distributed() or dist.get_rank() == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def available_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def save(self, state, step: int, metadata: Optional[Dict] = None):
        """Synchronous atomic save of a tree of tensors or arrays."""
        self.wait()
        if self.writer:
            self._write(to_host(state), step, metadata or {})
        _barrier()

    def save_async(self, state, step: int, metadata: Optional[Dict] = None):
        """Device-to-host copy now; the disk write on a writer thread."""
        host_state = to_host(state) if self.writer else None
        self.wait()
        if not self.writer:
            return
        self._thread = threading.Thread(
            target=self._write_logged, args=(host_state, step,
                                             metadata or {}), daemon=True)
        self._thread.start()

    def wait(self):
        """Wait for the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed") \
                from err

    def _write_logged(self, host_state, step: int, metadata: Dict):
        try:
            self._write(host_state, step, metadata)
        except Exception as exc:   # re-raised by wait()
            self._error = exc

    def _write(self, host_state, step: int, metadata: Dict):
        with self._lock:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            names = {}
            for i, (path, arr) in enumerate(_flatten(host_state).items()):
                fname = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fname), np.asarray(arr))
                names[path] = fname
            manifest = {"step": step, "leaves": names, "metadata": metadata,
                        "format": 1}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic commit
            self._gc()

    def _gc(self):
        steps = self.available_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, template, step: Optional[int] = None,
                shardings=None) -> tuple[Any, Dict]:
        """Load checkpoint ``step`` (default: the latest) into the structure
        of ``template``. A tensor leaf of the template gets its leaf back
        on its own device and dtype; any other leaf (``None`` will do) gets
        the stored numpy array. ``shardings`` (a tree like ``template`` of
        :class:`repro_torch.parallel.shard.Placement`s, None for a whole
        leaf) cuts each stored array to the rank's shard first. Returns
        ``(state, metadata)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {path: np.load(os.path.join(d, fname))
                for path, fname in manifest["leaves"].items()}
        if shardings is not None:
            for path, pl in _flatten(shardings).items():
                if pl is not None:
                    flat[path] = pl.local(flat[path])
        return _unflatten_into(template, flat), manifest["metadata"]
