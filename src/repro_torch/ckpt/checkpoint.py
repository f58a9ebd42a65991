"""Atomic npz shards and their content digest: the part of the JAX
package's ``ckpt/checkpoint.py`` that the serving tile store
(serve/store.py) writes and reads through. The same bytes and the same
digest as the JAX package's, so a tile pyramid written by either package
loads in the other. The rest of that module (sharded training checkpoints,
``CheckpointManager``) belongs to LM training and is not ported yet.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np


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
