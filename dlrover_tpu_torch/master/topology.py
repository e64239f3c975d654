"""Topology-aware rank order — the port's own copy of
``dlrover_tpu/master/topology.py`` (``NodeTopologyMeta``,
``TopologySorter``, ``DpTopologySorter``): the hosts of one slice (one
fast-interconnect domain) get contiguous node ranks, the largest slice
first, so that rank 0 lands in the biggest one."""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class NodeTopologyMeta:
    node_id: int
    node_rank: int
    process_unit_size: int
    slice_id: str = ""
    host_id: str = ""


class TopologySorter:
    """Identity order, by node rank."""

    def sort(self, nodes: Dict[int, NodeTopologyMeta]
             ) -> List[NodeTopologyMeta]:
        return sorted(nodes.values(), key=lambda n: n.node_rank)


class DpTopologySorter(TopologySorter):
    def sort(self, nodes: Dict[int, NodeTopologyMeta]
             ) -> List[NodeTopologyMeta]:
        groups: Dict[str, List[NodeTopologyMeta]] = {}
        for meta in nodes.values():
            groups.setdefault(meta.slice_id, []).append(meta)
        for members in groups.values():
            members.sort(key=lambda n: (n.host_id, n.node_rank))
        out: List[NodeTopologyMeta] = []
        for _, members in sorted(groups.items(),
                                 key=lambda kv: (-len(kv[1]), kv[0])):
            out.extend(members)
        return out
