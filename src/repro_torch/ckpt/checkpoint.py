"""Checkpoints: the JAX package's ``ckpt/checkpoint.py``.

* Every checkpoint is a directory ``step_<n>/`` holding one ``.npy`` a leaf
  of the saved tree (nested dicts, lists, tuples and named tuples of
  tensors; None is an empty subtree), named by its path with "/" → "__",
  and a ``manifest.json`` with the paths and a content digest.
* Writes are atomic: ``step_<n>.tmp`` → fsync → rename, so a killed writer
  never leaves a checkpoint that ``latest_step`` would pick up.
* ``CheckpointManager`` owns a writer thread (training never waits on the
  disk), keeps the newest K checkpoints, and validates digests on restore:
  a corrupt or partial checkpoint is skipped and deleted.

numpy has no bf16: a bf16 tensor is stored as its raw 2-byte words (the
``V2`` dtype the JAX package's bf16 leaves take in ``.npy``) and viewed
back on restore; the digest hashes shape, itemsize and raw bytes only, as
the JAX package's does. The optimizer updates its tensors in place, so
``save_async`` copies every tensor to host memory, blocking, before it
queues the tree.

Under a mesh the tree's leaves are each rank's blocks and the manager takes
``shardings`` (``parallel.sharding.Shardings``: a leaf whose path ends in a
parameter's name is cut as that parameter is). ``save_async`` gathers every
leaf to full on the calling thread — a collective, kept off the writer
thread so it cannot interleave with the step's own — and rank 0 writes the
one-device layout, so a checkpoint from either driver loads in the other.
``restore_latest`` has rank 0 pick the newest valid step and broadcast it;
every rank then reads the full leaves and cuts its blocks for its own mesh,
which may differ from the mesh that saved them: the elastic restore.

The npz helpers (``save_npz``, ``load_npz``, ``array_digest``) are the tile
store's (serve/store.py): the same bytes and the same digest as the JAX
package's, so a tile pyramid written by either package loads in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist


def _digest(arrays: dict[str, np.ndarray]) -> str:
    # dtype-NAME agnostic: hash shape + itemsize + raw bytes only
    h = hashlib.sha256()
    for name in sorted(arrays):
        h.update(name.encode())
        a = arrays[name]
        h.update(str(a.shape).encode())
        h.update(str(a.dtype.itemsize).encode())
        h.update(a.tobytes()[: 1 << 16])  # prefix digest: cheap + catches truncation
    return h.hexdigest()


def array_digest(arrays: dict[str, np.ndarray]) -> str:
    """Prefix digest over a named array dict (the tile store's manifest
    digest)."""
    return _digest(arrays)


def save_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Atomic uncompressed npz shard write: tmp → fsync → rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- trees ----------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix: str = "") -> tuple[list, list]:
    """(paths, leaves) of ``tree`` in order: dict keys as given, list and
    tuple entries by index, named-tuple fields by name; None holds no
    leaf."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for k, sub in items:
        p, l = _flatten_with_paths(sub, f"{prefix}/{k}" if prefix else str(k))
        paths += p
        leaves += l
    return paths, leaves


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(x) -> np.ndarray:
    """A host array of a leaf: a bf16 tensor as raw ``V2`` words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _snapshot(x) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot reach
    (``Tensor.cpu`` returns a CPU tensor itself)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
    return _to_numpy(x)


def save_checkpoint(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    paths, leaves = _flatten_with_paths(tree)
    arrays = {p: _to_numpy(l) for p, l in zip(paths, leaves)}
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name, arr in arrays.items():
        fn = os.path.join(tmp, name.replace("/", "__") + ".npy")
        np.save(fn, arr)
    manifest = {"step": step, "paths": paths, "digest": _digest(arrays)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    """Newest step with a manifest (partial .tmp dirs are ignored)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


def _to_leaf(arr: np.ndarray, ref):
    """``arr`` as a leaf like ``ref``: a tensor of ref's dtype on ref's
    device (bf16 viewed back from its raw words), else ``arr``."""
    if not isinstance(ref, torch.Tensor):
        return arr
    # ascontiguousarray makes a 0-d array 1-d: keep the stored shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if ref.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vi":
            raise IOError(f"a bf16 leaf stored as {arr.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(ref.dtype)
    return t.to(ref.device)


def restore_checkpoint(directory: str, step: int, tree_like, *,
                       validate: bool = True, shardings=None):
    """The checkpoint ``step`` in the structure of ``tree_like``, each
    tensor leaf on the device and in the dtype of ``tree_like``'s; with
    ``shardings``, each leaf cut to this rank's block (which must have the
    shape of ``tree_like``'s)."""
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, refs = _flatten_with_paths(tree_like)
    arrays = {}
    for p in paths:
        fn = os.path.join(d, p.replace("/", "__") + ".npy")
        arrays[p] = np.load(fn)
    if validate and _digest(arrays) != manifest["digest"]:
        raise IOError(f"checkpoint {d} failed digest validation")
    leaves = [_to_leaf(arrays[p], ref) for p, ref in zip(paths, refs)]
    if shardings is not None:
        leaves = [shardings.shard(p, x) if isinstance(ref, torch.Tensor)
                  else x for p, x, ref in zip(paths, leaves, refs)]
        for p, x, ref in zip(paths, leaves, refs):
            if isinstance(ref, torch.Tensor) and x.shape != ref.shape:
                raise IOError(f"checkpoint {d}: {p} cuts to {tuple(x.shape)}"
                              f", the tree holds {tuple(ref.shape)}")
    return _unflatten(tree_like, iter(leaves))


class CheckpointManager:
    """Async checkpointing with retention and corrupt-skip restore."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._error = None

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save_checkpoint(self.directory, step, tree)
                self._gc()
            except Exception as e:  # surfaced on next save/wait
                self._error = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def save_async(self, step: int, tree, shardings=None):
        """Queue ``tree`` for the writer; with ``shardings`` (every rank
        calls), gather each leaf to full first, and only rank 0 writes."""
        if self._error:
            raise self._error
        paths, leaves = _flatten_with_paths(tree)
        if shardings is not None:
            leaves = [shardings.gather(p, l) if isinstance(l, torch.Tensor)
                      else l for p, l in zip(paths, leaves)]
            if dist.get_rank() != 0:
                return
        # snapshot to host first so training can update tensors in place
        host = dict(zip(paths, (_snapshot(l) for l in leaves)))
        self._q.put((step, host))

    def wait(self):
        self._q.join()
        if self._error:
            raise self._error

    def restore_latest(self, tree_like, shardings=None):
        """Restore newest valid checkpoint, skipping (and deleting) corrupt
        ones → (step, tree), or (None, None). With ``shardings`` (every
        rank calls): rank 0 picks the step, and every rank restores it cut
        to its blocks."""
        if shardings is None:
            return self._newest(tree_like)
        found, tree = [None], None
        if dist.get_rank() == 0:
            found[0], tree = self._newest(tree_like, shardings)
        dist.broadcast_object_list(found, src=0)
        if found[0] is not None and tree is None:
            tree = restore_checkpoint(self.directory, found[0], tree_like,
                                      shardings=shardings)
        return found[0], tree

    def _newest(self, tree_like, shardings=None):
        while True:
            step = latest_step(self.directory)
            if step is None:
                return None, None
            try:
                tree = restore_checkpoint(self.directory, step, tree_like,
                                          shardings=shardings)
                return step, tree
            except Exception:
                shutil.rmtree(os.path.join(self.directory, f"step_{step}"),
                              ignore_errors=True)

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=30)
