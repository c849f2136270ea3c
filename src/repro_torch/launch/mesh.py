"""Device slices for serving replicas (``repro/launch/mesh.py``'s
``replica_slices``, over ``torch.device``s).

The reference's TPU constants and mesh builders have no counterpart
here: the port's trainer runs one process per rank, and an engine takes
its slice as a tuple of devices (a slice of several serves one
tensor-parallel engine, ``serve.engine.Engine``), not as a sub-mesh.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


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
