"""LSGD topology (a copy of ``repro/core/topology.py``): which ranks form
the fast (intra-group) and slow (inter-group) communication layers.

Paper mapping:
  worker group ("node" in the paper) -> a pod, or a subgroup of the data
    ranks when running single-pod (the paper's 4-GPU nodes);
  communicator layer                 -> the slow axis ("pod"), or the
    across-subgroup replica groups of the data ranks.

The port's trainer runs one process per rank with no pod axis: phase 1
reduces within ``phase1_groups``, phase 2 across ``phase2_groups``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class Topology:
    fast_axis: str = "data"
    slow_axis: str = "pod"
    # If set, the fast axis is subdivided into groups of this size (the
    # paper's "node" of 4 workers); the across-group reduction joins the
    # slow phase.  None = the whole fast axis is one group per pod.
    intra_group_size: Optional[int] = None

    def group_count(self, data_size: int) -> int:
        g = self.intra_group_size or data_size
        if data_size % g:
            raise ValueError(f"data axis {data_size} not divisible by "
                             f"group size {g}")
        return data_size // g

    def phase1_groups(self, data_size: int) -> Optional[List[List[int]]]:
        """axis_index_groups for the intra-group reduce along the fast axis
        (None = whole axis)."""
        g = self.intra_group_size
        if g is None or g == data_size:
            return None
        return [list(range(s, s + g)) for s in range(0, data_size, g)]

    def phase2_groups(self, data_size: int) -> Optional[List[List[int]]]:
        """axis_index_groups for the inter-group all-reduce along the fast
        axis (one group per intra-group rank; standard 2-level all-reduce).
        None = no across-group phase needed on the fast axis."""
        g = self.intra_group_size
        if g is None or g == data_size:
            return None
        return [list(range(r, data_size, g)) for r in range(g)]

    def device_slices(self, num_devices: int,
                      num_pods: int = 1) -> List[List[int]]:
        """Partition ``num_devices`` flat device ranks into one slice per
        fast-fabric group: the slow axis (pods) splits first, then each
        pod's ranks split into intra-group-size fast groups.  Serving
        places one engine replica per slice (pod-major, groups inner —
        the replica_id order of ``serve.ReplicaRouter``); training maps
        the same groups to the phase-1 reduce."""
        if num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {num_pods}")
        if num_devices % num_pods:
            raise ValueError(f"{num_devices} devices not divisible into "
                             f"{num_pods} pods")
        per_pod = num_devices // num_pods
        self.group_count(per_pod)        # validates divisibility
        groups = self.phase1_groups(per_pod)
        if groups is None:
            groups = [list(range(per_pod))]
        return [[pod * per_pod + r for r in g]
                for pod in range(num_pods) for g in groups]
