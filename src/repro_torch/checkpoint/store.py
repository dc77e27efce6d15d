"""Checkpoint store: tree save/restore with async snapshots (the port's
copy of ``repro/checkpoint/store.py``, in the same format).

This substrate backs three features:

* **fault tolerance** — train jobs snapshot every N steps; a KILLed or
  failed job restarts from the latest durable checkpoint;
* **EAGER preemption** — suspend = serialize (params, opt, step) to the
  host store ("the swap partition" of DESIGN.md §2); resume = restore —
  possibly on a different gang;
* **elastic rescale** — checkpoints are topology-free (plain host arrays),
  so a job saved on 16 chips resumes on 64.

Format: one ``.npz`` per snapshot holding flattened leaves + a JSON tree
spec.  Leaves are flattened in ``jax.tree.flatten``'s order (dict keys
sorted at every level), so ``leaf_i`` is the same leaf in both packages
and each restores the other's snapshots bitwise.  A tree holds nested
dicts (a :class:`~repro_torch.models.params.ParamTree` is saved as its
nested dict), lists, tensors on any device and numpy arrays.  Async mode
copies device tensors to the host now and serializes on a background
thread, so the train loop only blocks for the D2H copy.  ``restore``
returns numpy arrays, as the reference does; the caller moves them to the
device (:func:`repro_torch.train.train_state_to_device`).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.params import ParamTree


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            raise TypeError("a bf16 leaf has no numpy dtype to save it in")
        return x.cpu().numpy()
    return np.asarray(x)


def _plain(tree):
    """``tree`` with every ParamTree as its nested dict."""
    if isinstance(tree, ParamTree):
        return tree.to_dict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _leaves(tree) -> list:
    """Leaves in ``jax.tree.flatten``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for _, v in sorted(tree.items()) for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _flatten(tree) -> tuple[list[np.ndarray], str]:
    tree = _plain(tree)
    spec = json.dumps(_treedef_to_json(tree))
    return [_host(l) for l in _leaves(tree)], spec


def _treedef_to_json(tree):
    if isinstance(tree, dict):
        return {k: _treedef_to_json(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_treedef_to_json(v) for v in tree]
    return None  # leaf


def _unflatten_like(spec, leaves: list):
    return _build(spec, iter(leaves))


def _build(node, it):
    # Not a recursive closure: that is a reference cycle, which would hold
    # every restored leaf until the next garbage collection.
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in sorted(node.items())}
    if isinstance(node, list):
        return [_build(v, it) for v in node]
    return next(it)


@dataclass
class CheckpointStore:
    directory: str
    keep: int = 3
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _async_threads: list = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)

    # -- paths ---------------------------------------------------------
    def path(self, tag: str, step: int) -> str:
        return os.path.join(self.directory, f"{tag}-{step:08d}.npz")

    def latest(self, tag: str) -> tuple[int, str] | None:
        best = None
        for f in os.listdir(self.directory):
            if f.startswith(f"{tag}-") and f.endswith(".npz"):
                try:
                    step = int(f[len(tag) + 1 : -4])
                except ValueError:
                    continue
                if best is None or step > best[0]:
                    best = (step, os.path.join(self.directory, f))
        return best

    # -- save / restore ---------------------------------------------------
    def save(self, tag: str, step: int, tree) -> str:
        leaves, spec = _flatten(tree)
        path = self.path(tag, step)
        tmp = path + ".tmp"
        with self._lock:
            np.savez(
                tmp, __spec__=np.frombuffer(spec.encode(), dtype=np.uint8),
                **{f"leaf_{i}": l for i, l in enumerate(leaves)},
            )
            os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
        self._gc(tag)
        return path

    def save_async(self, tag: str, step: int, tree) -> threading.Thread:
        """Device->host copy happens now; serialization on a thread."""
        leaves, spec = _flatten(tree)
        host_tree = _unflatten_like(json.loads(spec), leaves)
        t = threading.Thread(
            target=self.save, args=(tag, step, host_tree), daemon=True
        )
        t.start()
        self._async_threads.append(t)
        return t

    def wait(self) -> None:
        for t in self._async_threads:
            t.join()
        self._async_threads.clear()

    def restore(self, tag: str, step: int | None = None):
        if step is None:
            found = self.latest(tag)
            if found is None:
                return None
            step, path = found
        else:
            path = self.path(tag, step)
            if not os.path.exists(path):
                return None
        with np.load(path) as z:
            spec = json.loads(bytes(z["__spec__"]).decode())
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
        return step, _unflatten_like(spec, leaves)

    def _gc(self, tag: str) -> None:
        snaps = sorted(
            f for f in os.listdir(self.directory)
            if f.startswith(f"{tag}-") and f.endswith(".npz")
        )
        for f in snaps[: -self.keep]:
            try:
                os.remove(os.path.join(self.directory, f))
            except OSError:
                pass
