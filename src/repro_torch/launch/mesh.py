"""Device meshes over the ranks of a ``torch.distributed`` group.

The JAX package names the devices of a mesh by axes (``"data"``,
``"model"``, and ``"pod"`` on multi-pod meshes) and lets ``shard_map``
run one program on every device. The port runs one process a rank instead:
a ``Mesh`` names the ranks of the default process group by the same axes,
rank = the row-major index of its coordinates, and holds the subgroups the
sharded superstep (``core/distributed.py``) reduces over: the vertex axes
(every axis but ``"model"``), ``"model"``, and each vertex axis alone.

``make_mesh(shape, axes)`` spans the initialized default group and raises
unless the mesh has as many ranks as the group. ``make_host_mesh`` is the
JAX package's "one mesh over all local devices": it spans the default
group, or, when none is initialized, initializes a one-rank group itself
(NCCL for the card beside gloo for the CPU, through a ``FileStore`` in a
temporary directory, never a TCP port). ``init_from_env`` initializes the
group that ``torchrun`` describes in the environment. A CUDA mesh needs
NCCL and one card a rank; a CPU mesh needs gloo.

``make_production_mesh`` builds the dry run's meshes, (16, 16) or (2, 16,
16), for rank 0 of a process group of that world size whose collectives do
nothing (PyTorch's ``fake`` backend): the dry run (``launch/dryrun.py``)
runs a cell's step on ``meta`` tensors over it, and nothing else reaches
it. The checks of ``make_mesh`` (``_check_backend``,
``_check_one_card_a_rank``) stay on every other path. Beside it, the
NVIDIA H100 80GB HBM3's data-sheet rates the dry run's roofline reads (the
JAX package's TPU v5e constants do not carry over).
"""
from __future__ import annotations

import math
import os
import shutil
import socket
import tempfile

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device

# NVIDIA H100 80GB HBM3 (SXM, 700 W), NVIDIA's data sheet, per card
PEAK_FLOPS_BF16 = 989e12         # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                 # B/s
NVLINK_BW = 450e9                # B/s a direction (900 GB/s both ways)
HBM_PER_CARD = 80e9              # bytes

_MESHES: dict = {}
_OWN_STORE: list = []        # the temporary directory of a group made here


class Mesh:
    """Named axes over the ranks of the default process group, on one
    device a rank. Build with ``make_mesh`` or ``make_host_mesh``: every
    rank must build the same meshes in the same order, since each build
    creates its subgroups collectively."""

    def __init__(self, shape: tuple, axes: tuple, device: torch.device):
        if len(shape) != len(axes) or "model" not in axes:
            raise ValueError(f"mesh axes {axes} for shape {shape}: one "
                             "size an axis, and a 'model' axis")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, (int(s) for s in shape)))
        self.device = device
        self.size = math.prod(self.shape.values())
        self.rank = dist.get_rank()
        self.coords = {}
        r = self.rank
        for a in reversed(axes):
            self.coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.vtx_axes = (("pod", "data") if "pod" in axes else ("data",))
        self.vtx_size = self.axis_size(self.vtx_axes)
        #: this rank's index over the flattened vertex axes
        self.vtx_index = 0
        for a in self.vtx_axes:
            self.vtx_index = self.vtx_index * self.shape[a] + self.coords[a]
        self.vtx_group = self._group(self.vtx_axes)
        self.model_group = self._group(("model",))
        self.axis_groups = {a: (self._group((a,)) if len(self.vtx_axes) > 1
                                else self.vtx_group)
                            for a in self.vtx_axes}
        self._extra_groups: dict = {}

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def axis_size(self, names) -> int:
        names = (names,) if isinstance(names, str) else tuple(names)
        return math.prod(self.shape[n] for n in names)

    def index(self, names) -> int:
        """This rank's row-major index over the axes ``names``."""
        names = (names,) if isinstance(names, str) else tuple(names)
        i = 0
        for a in names:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, names):
        """The group of the ranks that share this rank's coordinates off
        the axes ``names`` (a name or a tuple of names), its ranks in
        row-major order of those axes in mesh order. A group not built with
        the mesh is built at its first request, collectively: every rank
        must make the same requests in the same order."""
        names = (names,) if isinstance(names, str) else tuple(names)
        key = tuple(a for a in self.axis_names if a in names)
        if len(key) != len(names):
            raise ValueError(f"axes {names} on mesh {self.axis_names}")
        if key == ("model",):
            return self.model_group
        if key == self.vtx_axes:
            return self.vtx_group
        if len(key) == 1:
            return self.axis_groups[key[0]]
        if key not in self._extra_groups:
            self._extra_groups[key] = self._group(key)
        return self._extra_groups[key]

    def vtx_peer(self, v: int) -> int:
        """Global rank of the rank at vertex index ``v`` that shares this
        rank's other coordinates."""
        c = dict(self.coords)
        for a in reversed(self.vtx_axes):
            c[a] = v % self.shape[a]
            v //= self.shape[a]
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + c[a]
        return r

    @property
    def key(self) -> tuple:
        return (self.axis_names, tuple(self.shape.values()))

    def _group(self, varying: tuple):
        """The subgroup of the ranks that share this rank's coordinates on
        every axis outside ``varying``, its ranks in row-major order of the
        varying axes. Every rank creates every such subgroup, in one fixed
        order; the whole group is the default group itself."""
        fixed = [a for a in self.axis_names if a not in varying]
        if not fixed:
            return dist.group.WORLD
        groups: dict = {}
        for r in range(self.size):
            c, rest = {}, r
            for a in reversed(self.axis_names):
                c[a] = rest % self.shape[a]
                rest //= self.shape[a]
            groups.setdefault(tuple(c[a] for a in fixed), []).append(r)
        mine, _ = dist.new_subgroups_by_enumeration(list(groups.values()))
        return mine

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x`` split evenly along dim 0 over the
        vertex axes (the JAX package's ``P(VTX)``), a contiguous view."""
        b = x.shape[0] // self.vtx_size
        if b * self.vtx_size != x.shape[0]:
            raise ValueError(f"{x.shape[0]} rows over {self.vtx_size} ranks")
        return x[self.vtx_index * b:(self.vtx_index + 1) * b]


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init_one_rank(device: torch.device) -> None:
    """A one-rank default group through a FileStore in a new temporary
    directory: gloo for the CPU, and NCCL for the card beside it."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    _OWN_STORE.append(tmp)
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    backend = "gloo"
    if torch.cuda.is_available() and dist.is_nccl_available():
        backend = "cpu:gloo,cuda:nccl"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def init_from_env(device=None) -> None:
    """Initialize the default group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), with the
    backend of ``device``; on the card each rank takes card ``LOCAL_RANK``.
    Does nothing when the group is initialized or the environment names
    none."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(_backend(dev), init_method="env://")


def _check_backend(device: torch.device) -> None:
    backend = str(dist.get_backend())
    if _backend(device) not in backend:
        raise ValueError(f"a {device.type} mesh needs {_backend(device)}; "
                         f"the default group's backend is {backend}")


def _check_one_card_a_rank(device: torch.device) -> None:
    """Raise when two ranks of the group would share a card."""
    if dist.get_world_size() == 1:
        return
    props = torch.cuda.get_device_properties(device)
    mine = (socket.gethostname(), str(getattr(props, "uuid", device.index)))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine)
    if len(set(seen)) != len(seen):
        raise ValueError(f"two ranks on one card: {seen}")


def make_mesh(shape, axes=("data", "model"), *, device=None) -> Mesh:
    """A mesh of ``shape`` with named ``axes`` over the default group, on
    ``device`` (default: the card). A one-rank mesh initializes a one-rank
    group when none is; otherwise the mesh must have as many ranks as the
    group. Cached: every later call with the same arguments returns it."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(f"mesh {shape} has {size} ranks, but no "
                             "process group is initialized (world size 1)")
        _init_one_rank(dev)
    if size != dist.get_world_size():
        raise ValueError(f"mesh {shape} has {size} ranks, the process "
                         f"group {dist.get_world_size()}")
    key = (shape, tuple(axes), str(dev))
    mesh = _MESHES.get(key)
    if mesh is None:
        _check_backend(dev)
        if dev.type == "cuda":
            _check_one_card_a_rank(dev)
        mesh = _MESHES[key] = Mesh(shape, tuple(axes), dev)
    return mesh


def make_host_mesh(model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over every rank of the default group, or over a
    one-rank group made here when none is initialized."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _init_one_rank(dev)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model {model}")
    return make_mesh((n // model, model), ("data", "model"), device=dev)


def shutdown() -> None:
    """Forget every mesh and destroy the default group (and the temporary
    directory of a one-rank group made here)."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    while _OWN_STORE:
        shutil.rmtree(_OWN_STORE.pop(), ignore_errors=True)


def make_fake_mesh(shape, axes=("data", "model")) -> Mesh:
    """A mesh of ``shape`` for rank 0 of a process group of its size whose
    collectives do nothing and take ``meta`` tensors (the ``fake``
    backend of ``torch.testing._internal.distributed.fake_pg``). A group
    already initialized is taken down first when it is such a group of
    another size; any other group raises. For the dry run only: its
    tensors are shapes, never values."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    size = math.prod(int(s) for s in shape)
    if dist.is_initialized():
        if str(dist.get_backend()) != "fake":
            raise RuntimeError("make_fake_mesh: a real process group is "
                               "initialized")
        if dist.get_world_size() != size:
            shutdown()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    key = (tuple(shape), tuple(axes), "meta")
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = Mesh(tuple(shape), tuple(axes),
                                   torch.device("meta"))
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh as a fake mesh: (16, 16) over
    (data, model), or (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))
