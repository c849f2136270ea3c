"""Meshes over the training ranks and device slices for serving
replicas (``repro/launch/mesh.py``).

A training mesh (``make_mesh``) lays the process group's ranks out on
named axes, row-major (the last axis fastest), as ``jax.make_mesh`` lays
out devices: ``("pod", "data", "model")`` or a suffix of it.  ``pod`` is
LSGD's slow axis, ``data`` its fast one (data parallelism, FSDP shards,
expert parallelism) and ``model`` tensor parallelism.  Each rank holds
one process-group handle for each set of axes it communicates over (the
ranks that share its other coordinates), made when the mesh is built:
``dist.new_group`` is a collective call, so every rank builds the same
mesh.  Without a process group the mesh is the one rank.

The reference's TPU constants and production meshes have no
counterpart here.  An engine takes its slice as a tuple of devices (a
slice of several serves one tensor-parallel engine,
``serve.engine.Engine``), not as a sub-mesh.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")


class Mesh:
    """The ranks of the default process group on named axes (the
    reference's ``jax.sharding.Mesh`` for one process per rank)."""

    # the axis sets a trainer reduces over: each alone, the
    # data-parallel pair, and data x model (LARS's norms of a model
    # replica's leaves)
    GROUPS = (("pod",), ("data",), ("model",), ("pod", "data"),
              ("data", "model"))

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "pair up")
        if min(shape, default=1) < 1:
            raise ValueError(f"mesh shape {shape} has an empty axis")
        on = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        if math.prod(shape) != self.world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} holds "
                             f"{math.prod(shape)} ranks; the process group "
                             f"has {self.world}")
        self.shape, self.axis_names = shape, axes
        self.coords = dict(zip(axes, _unravel(self.rank, shape)))
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        self._blocks: Dict[Tuple[str, int], object] = {}
        for names in self.GROUPS:
            names = tuple(a for a in names if a in axes)
            if names and names not in self._groups \
                    and self.size(names) > 1:
                self._groups[names] = self._make(names)

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"

    def lines(self, names) -> List[List[int]]:
        """The ranks along ``names`` for each setting of the other axes
        (in rank order), each list ordered by the position along
        ``names`` (row-major over them)."""
        names = tuple(a for a in self.axis_names if a in names)
        others = [a for a in self.axis_names if a not in names]
        return [[self._rank_of({**dict(zip(others, fixed)),
                                **dict(zip(names, c))})
                 for c in itertools.product(*(range(self.sizes[a])
                                              for a in names))]
                for fixed in itertools.product(*(range(self.sizes[a])
                                                 for a in others))]

    def _make(self, names):
        """Every rank's group over ``names`` (one for each setting of the
        other axes, in rank order); returns this rank's (group, ranks)."""
        mine = None
        for ranks in self.lines(names):
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (g, ranks)
        return mine

    def block_group(self, name: str, block: int):
        """This rank's group over the ``block`` consecutive positions
        along axis ``name`` that hold its own (positions [b * block, (b +
        1) * block)), sharing its other coordinates; None for a block of
        one.  Made at the first call, which is a collective call: every
        rank makes the same calls in the same order."""
        if block == 1:
            return None
        if block == self.size(name):
            return self.group(name)
        if self.size(name) % block:
            raise ValueError(f"{block} does not divide axis {name} of "
                             f"{self.size(name)}")
        if (name, block) not in self._blocks:
            mine = None
            for line in self.lines((name,)):
                for b0 in range(0, len(line), block):
                    ranks = line[b0:b0 + block]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
            self._blocks[(name, block)] = mine
        return self._blocks[(name, block)]

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a, n in zip(self.axis_names, self.shape):
            r = r * n + coords[a]
        return r

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, names) -> int:
        """Ranks along the axes ``names`` (a name or a tuple; an axis the
        mesh lacks counts 1)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        return math.prod(self.sizes.get(a, 1) for a in names)

    def group(self, names):
        """This rank's process group over ``names`` (the ranks sharing
        its other coordinates); None when that is this rank alone."""
        names = (names,) if isinstance(names, str) else tuple(names)
        names = tuple(a for a in names if a in self.axis_names)
        if self.size(names) == 1:
            return None
        if names not in self._groups:
            raise KeyError(f"no group over {names}; the mesh makes groups "
                           f"over {list(self._groups)}")
        return self._groups[names][0]

    def index(self, names) -> int:
        """This rank's position along ``names`` (row-major over them)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        i = 0
        for a in names:
            i = i * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return i


def _unravel(rank: int, shape) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` on ``axes`` over the default process group's
    ranks; raises unless the shape holds exactly the world's ranks."""
    return Mesh(shape, axes)


def make_host_mesh(shape=(2, 2, 2), axes=AXES) -> Mesh:
    """The reference's small test mesh, over the process group's ranks
    (gloo ranks on the CPU)."""
    return make_mesh(shape, axes)


def mesh_axis_sizes(mesh) -> dict:
    return mesh.sizes


def mesh_from_dims(dims: Sequence[int]) -> Mesh:
    """The launcher's ``--mesh``: ``dims`` on the last ``len(dims)`` of
    ("pod", "data", "model"), as the reference names them."""
    dims = tuple(int(x) for x in dims)
    if not 1 <= len(dims) <= len(AXES):
        raise ValueError(f"--mesh takes 1 to {len(AXES)} dims, got {dims}")
    return make_mesh(dims, AXES[-len(dims):])


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device, ``cuda:0`` to ``cuda:{n-1}``.  Raises
    when there is none: the port serves on CUDA unless the caller names
    other devices, and never falls back to the CPU by itself."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device is visible; name the devices "
                           "(for example [torch.device('cpu')]) to serve "
                           "on others")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def replica_slices(topology, num_pods: int = 1,
                   devices: Optional[Sequence] = None
                   ) -> List[Tuple[torch.device, ...]]:
    """One device slice per serving replica.

    Partitions the devices along the LSGD axes — the slow axis (pods)
    first, then each pod's devices into fast-fabric groups
    (``topology.device_slices``) — and returns them pod-major, fast
    groups inner: index ``i`` is the device territory of the
    ``ReplicaRouter``'s replica ``i``.  ``devices`` defaults to every
    visible CUDA device (``cuda_devices``)."""
    devices = (cuda_devices() if devices is None
               else [torch.device(d) for d in devices])
    return [tuple(devices[i] for i in grp)
            for grp in topology.device_slices(len(devices), num_pods)]
