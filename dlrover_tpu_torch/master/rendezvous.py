"""Master-side rendezvous — the port's own copy of
``dlrover_tpu/master/rendezvous.py`` (``RendezvousManager``,
``ElasticTrainingRendezvousManager``, ``NetworkCheckRendezvousManager``).

A round: agents ``join`` a waiting list; the round completes when at least
``min_nodes`` wait and either ``max_nodes`` do or nobody joined for the
lastcall window (3 s); the world is rounded down to a multiple of
``node_unit`` and ordered by ``DpTopologySorter``; agents poll
``get_comm_world`` until their round's world appears, with contiguous
``process_id_base`` s and the rank-0 node's coordinator.  A member of the
current world that joins again with a new attempt id was restarted: it is
evicted from the world, and its peers see ``num_nodes_waiting() > 0``.

With the HA journal bound (``master/state.py``) a join, a removal, a
checkpoint vote and a completed round are journaled before the ack.  The
round's completion is a wall-clock decision, so its result, the latched
world, is journaled as a state record (``rdzv.world``) that replay applies
as it is (``restore_world``, reference ``:328-349``); ``dump_state``,
``load_state`` and ``rearm_clocks`` (``:412-422``) are the snapshot and the
takeover's re-arm.  The reference's chaos sites (``rdzv.late_join``,
``rdzv.lost_node``) come with ``constants.CHAOS_LAYER``, and the
journaled ``ReshardManager`` and ``CellManager`` with their host layers
(``constants.HOST_LAYERS``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Tuple

from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.state import JournalBound
from dlrover_tpu_torch.master.topology import (
    DpTopologySorter,
    NodeTopologyMeta,
)


class RendezvousManager(JournalBound):
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._ctx = get_context()
        self._min_nodes = 1
        self._max_nodes = 1
        self._node_unit = 1
        self._waiting_timeout = 3.0
        self._waiting_nodes: Dict[int, NodeTopologyMeta] = {}
        self._node_extra: Dict[int, dict] = {}
        self._lastcall_time = 0.0
        self._rdzv_round = 0
        self._rdzv_nodes: Dict[int, NodeTopologyMeta] = {}
        self._latched_world: Dict[int, dict] = {}
        self._latched_round = -1
        self._start_waiting_time = 0.0
        self._alive_nodes: set = set()
        self._sorter = DpTopologySorter()
        self._ckpt_steps: Dict[int, int] = {}

    def update_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float = 3.0,
                           node_unit: int = 1) -> None:
        with self._lock:
            self._min_nodes = min_nodes
            self._max_nodes = max_nodes
            self._waiting_timeout = waiting_timeout
            self._node_unit = max(1, node_unit)

    # -- membership from the job manager --------------------------------------
    def add_alive_node(self, node_id: int) -> None:
        with self._lock:
            self._alive_nodes.add(node_id)

    def remove_alive_node(self, node_id: int) -> None:
        with self._lock:
            known = (node_id in self._alive_nodes
                     or node_id in self._waiting_nodes)
            self._alive_nodes.discard(node_id)
            self._waiting_nodes.pop(node_id, None)
            if known:
                self._jrec("rdzv.remove", name=self.name, node_id=node_id)

    def alive_nodes(self) -> list:
        with self._lock:
            return sorted(self._alive_nodes)

    # -- agent-facing
    def join(self, node_id: int, node_rank: int, local_world_size: int,
             host: str = "", coordinator_port: int = 0, slice_id: str = "",
             host_id: str = "", attempt_id: str = "") -> int:
        """Put a node on the waiting list; the round it will join."""
        with self._lock:
            meta = NodeTopologyMeta(node_id=node_id, node_rank=node_rank,
                                    process_unit_size=local_world_size,
                                    slice_id=slice_id,
                                    host_id=host_id or host)
            prev_attempt = self._node_extra.get(node_id, {}).get(
                "attempt_id", "")
            same = bool(attempt_id) and attempt_id == prev_attempt
            if node_id in self._waiting_nodes and same:
                # A periodic re-join of a waiting node: a no-op that must
                # not re-arm the lastcall window.
                return self._rdzv_round
            if node_id in self._rdzv_nodes:
                if same:
                    return self._rdzv_round  # an RPC-retried duplicate
                del self._rdzv_nodes[node_id]
                logger.info("rdzv[%s]: node %d re-joined; evicted from "
                            "round %d world (%d members remain)", self.name,
                            node_id, self._latched_round,
                            len(self._rdzv_nodes))
            self._waiting_nodes[node_id] = meta
            self._node_extra[node_id] = {
                "host": host, "coordinator_port": coordinator_port,
                "attempt_id": attempt_id}
            self._alive_nodes.add(node_id)
            self._jrec("rdzv.join", name=self.name, node_id=node_id,
                       node_rank=node_rank,
                       local_world_size=local_world_size, host=host,
                       coordinator_port=coordinator_port,
                       slice_id=slice_id, host_id=host_id,
                       attempt_id=attempt_id)
            self._lastcall_time = time.monotonic()
            if not self._start_waiting_time:
                self._start_waiting_time = self._lastcall_time
            logger.info("rdzv[%s]: node %d (rank %d) joined; waiting=%d "
                        "min=%d max=%d", self.name, node_id, node_rank,
                        len(self._waiting_nodes), self._min_nodes,
                        self._max_nodes)
            return self._rdzv_round

    def _check_completion_locked(self) -> None:
        n = len(self._waiting_nodes)
        if n < self._min_nodes:
            return
        if n < self._max_nodes and \
                time.monotonic() - self._lastcall_time < \
                self._waiting_timeout:
            return
        usable = (n // self._node_unit) * self._node_unit
        if usable < self._min_nodes:
            return
        ordered = self._sorter.sort(self._waiting_nodes)[:usable]
        self._rdzv_nodes = {m.node_id: m for m in ordered}
        for nid in self._rdzv_nodes:
            del self._waiting_nodes[nid]
        self._latched_round = self._rdzv_round
        self._rdzv_round += 1
        self._start_waiting_time = 0.0
        self._latched_world = self._build_world_locked(ordered)
        self._jrec("rdzv.world", name=self.name,
                   latched_round=self._latched_round,
                   rdzv_round=self._rdzv_round,
                   nodes={m.node_id: dataclasses.asdict(m)
                          for m in self._rdzv_nodes.values()},
                   world=dict(self._latched_world))
        logger.info("rdzv[%s]: round %d complete with %d nodes (left "
                    "waiting: %d)", self.name, self._latched_round, usable,
                    len(self._waiting_nodes))

    def _build_world_locked(self, ordered: List[NodeTopologyMeta]
                            ) -> Dict[int, dict]:
        """node_rank 0..N-1 -> meta; process ids contiguous in topology
        order, so a node's first process id is its ``process_id_base``."""
        world: Dict[int, dict] = {}
        proc_base = 0
        for new_rank, meta in enumerate(ordered):
            extra = self._node_extra.get(meta.node_id, {})
            world[new_rank] = {
                "node_id": meta.node_id,
                "local_world_size": meta.process_unit_size,
                "process_id_base": proc_base,
                "host": extra.get("host", ""),
                "coordinator_port": extra.get("coordinator_port", 0),
                "slice_id": meta.slice_id,
            }
            proc_base += meta.process_unit_size
        return world

    def get_comm_world(self, node_id: int
                       ) -> Tuple[int, int, Dict[int, dict], str]:
        """``(round, group, world, coordinator)``; the world is empty until
        the node's round completes."""
        with self._lock:
            self._check_completion_locked()
            if node_id in self._rdzv_nodes:
                return (self._latched_round, 0, dict(self._latched_world),
                        self._coordinator_locked())
            return self._rdzv_round, 0, {}, ""

    def _coordinator_locked(self) -> str:
        if not self._latched_world:
            return ""
        rank0 = self._latched_world[0]
        host = rank0.get("host") or "127.0.0.1"
        return f"{host}:{rank0.get('coordinator_port') or 0}"

    def num_nodes_waiting(self) -> int:
        """Nodes that could extend the current world: agents restart their
        workers when it is above 0."""
        with self._lock:
            if len(self._rdzv_nodes) >= self._max_nodes:
                return 0
            return len(self._waiting_nodes)

    def pending_timeout(self) -> bool:
        with self._lock:
            if not self._start_waiting_time:
                return False
            return (time.monotonic() - self._start_waiting_time
                    > self._ctx.rdzv_timeout)

    @property
    def current_round(self) -> int:
        with self._lock:
            return self._rdzv_round

    def current_world_nodes(self) -> List[int]:
        with self._lock:
            return list(self._rdzv_nodes.keys())

    def sync_ckpt_nodes(self, node_id: int, step: int) -> bool:
        """True once every node of the current world reported ``step``."""
        with self._lock:
            if self._ckpt_steps.get(node_id) != step:
                self._jrec("rdzv.ckpt_vote", name=self.name,
                           node_id=node_id, step=step)
            self._ckpt_steps[node_id] = step
            world = set(self._rdzv_nodes.keys())
            if not world:
                return False
            return all(self._ckpt_steps.get(nid) == step for nid in world)

    # -- the HA snapshot and replay --------------------------------------------
    def restore_world(self, rec: dict) -> None:
        """Apply an ``rdzv.world`` record: the latched world of a completed
        round, whose members leave the waiting list."""
        with self._lock:
            nodes = {int(nid): NodeTopologyMeta(**meta)
                     for nid, meta in (rec.get("nodes") or {}).items()}
            self._rdzv_nodes = nodes
            self._latched_world = {int(r): dict(info) for r, info
                                   in (rec.get("world") or {}).items()}
            self._latched_round = int(rec.get("latched_round", -1))
            self._rdzv_round = int(rec.get("rdzv_round", 0))
            for nid in nodes:
                self._waiting_nodes.pop(nid, None)
                self._alive_nodes.add(nid)
            self._start_waiting_time = 0.0

    def dump_state(self) -> dict:
        with self._lock:
            return {
                "waiting": {nid: dataclasses.asdict(meta) for nid, meta
                            in self._waiting_nodes.items()},
                "extra": {nid: dict(e)
                          for nid, e in self._node_extra.items()},
                "rdzv_nodes": {nid: dataclasses.asdict(meta) for nid, meta
                               in self._rdzv_nodes.items()},
                "world": dict(self._latched_world),
                "latched_round": self._latched_round,
                "rdzv_round": self._rdzv_round,
                "alive": sorted(self._alive_nodes),
                "ckpt_steps": dict(self._ckpt_steps),
            }

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._waiting_nodes = {int(nid): NodeTopologyMeta(**meta)
                                   for nid, meta
                                   in state.get("waiting", {}).items()}
            self._node_extra = {int(nid): dict(e) for nid, e
                                in state.get("extra", {}).items()}
            self._rdzv_nodes = {int(nid): NodeTopologyMeta(**meta)
                                for nid, meta
                                in state.get("rdzv_nodes", {}).items()}
            self._latched_world = {int(r): dict(info) for r, info
                                   in state.get("world", {}).items()}
            self._latched_round = int(state.get("latched_round", -1))
            self._rdzv_round = int(state.get("rdzv_round", 0))
            self._alive_nodes = set(state.get("alive", []))
            self._ckpt_steps = {int(nid): int(step) for nid, step
                                in state.get("ckpt_steps", {}).items()}

    def rearm_clocks(self) -> None:
        """Restart the lastcall and pending windows on this process's
        clock, so that a replayed waiting list neither completes at once
        nor reads as timed out."""
        with self._lock:
            now = time.monotonic()
            if self._waiting_nodes:
                self._lastcall_time = now
                self._start_waiting_time = now
            else:
                self._start_waiting_time = 0.0


class ElasticTrainingRendezvousManager(RendezvousManager):
    """The training rendezvous."""

    def __init__(self) -> None:
        super().__init__("elastic-training")


class NetworkCheckRendezvousManager(RendezvousManager):
    """The pre-flight check's rendezvous: it pairs nodes into sub-worlds
    (round 0 adjacent ranks, later rounds fastest with slowest), so that a
    node slow in both pairings is the straggler and a node failing beside a
    good partner is faulty.  The launcher drives it
    (``agent/node_check.py``).  Its results are not journaled, as the
    reference's are not: a failover mid-check loses at most one round,
    which the agents run again."""

    def __init__(self) -> None:
        super().__init__("network-check")
        self._results: Dict[int, Dict[int, Tuple[bool, float]]] = {}
        self._check_round = 0

    def dump_state(self) -> dict:
        state = super().dump_state()
        with self._lock:
            state["results"] = {r: {nid: list(v) for nid, v in by.items()}
                                for r, by in self._results.items()}
            state["check_round"] = self._check_round
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        with self._lock:
            self._results = {
                int(r): {int(nid): (bool(v[0]), float(v[1]))
                         for nid, v in by.items()}
                for r, by in state.get("results", {}).items()}
            self._check_round = int(state.get("check_round", 0))

    def get_comm_world(self, node_id: int
                       ) -> Tuple[int, int, Dict[int, dict], str]:
        """The node's pair as the world, the pair's index as ``group``."""
        with self._lock:
            self._check_completion_locked()
            if node_id not in self._rdzv_nodes:
                return self._rdzv_round, 0, {}, ""
            for gi, group in enumerate(self._group_nodes_locked()):
                if node_id not in group:
                    continue
                sub_world: Dict[int, dict] = {}
                for r, nid in enumerate(group):
                    meta = self._rdzv_nodes[nid]
                    extra = self._node_extra.get(nid, {})
                    sub_world[r] = {
                        "node_id": nid,
                        "local_world_size": meta.process_unit_size,
                        "process_id_base": sum(
                            self._rdzv_nodes[g].process_unit_size
                            for g in group[:r]),
                        "host": extra.get("host", ""),
                        "coordinator_port": extra.get("coordinator_port", 0),
                        "slice_id": meta.slice_id,
                    }
                rank0 = sub_world[0]
                coord = (f"{rank0['host'] or '127.0.0.1'}:"
                         f"{rank0['coordinator_port']}")
                return self._latched_round, gi, sub_world, coord
            return self._rdzv_round, 0, {}, ""

    def _group_nodes_locked(self) -> List[List[int]]:
        ids = list(self._rdzv_nodes.keys())
        prev = self._results.get(self._check_round - 1)
        if self._check_round > 0 and prev:
            by_time = sorted(ids, key=lambda n: prev.get(n, (True, 0.0))[1])
            groups = []
            i, j = 0, len(by_time) - 1
            while i < j:
                groups.append([by_time[i], by_time[j]])
                i, j = i + 1, j - 1
            if i == j:
                groups.append([by_time[i]])
            return groups
        ordered = sorted(ids, key=lambda n: self._rdzv_nodes[n].node_rank)
        return [ordered[i:i + 2] for i in range(0, len(ordered), 2)]

    def report_result(self, node_id: int, succeeded: bool, elapsed: float,
                      round_: int = -1) -> None:
        with self._lock:
            r = self._check_round if round_ < 0 else round_
            self._results.setdefault(r, {})[node_id] = (succeeded, elapsed)

    def next_check_round(self) -> int:
        with self._lock:
            self._check_round += 1
            return self._check_round

    def check_fault_node(self) -> Tuple[List[int], str]:
        """Nodes that failed the latest round; a round-0 failure alone is
        inconclusive (the partner may be at fault)."""
        with self._lock:
            if not self._results:
                return [], "no results"
            last = max(self._results.keys())
            faults = [nid for nid, (ok, _) in self._results[last].items()
                      if not ok]
            if last == 0 and faults:
                return [], "need another round"
            return sorted(faults), "checked"

    def get_stragglers(self) -> Tuple[Dict[int, float], List[int]]:
        """The latest round's times, and the nodes slower than
        ``straggler_threshold`` × the median."""
        with self._lock:
            if not self._results:
                return {}, []
            last = max(self._results.keys())
            times = {nid: t for nid, (ok, t) in self._results[last].items()
                     if ok}
            if len(times) < 2:
                return times, []
            values = sorted(times.values())
            mid = len(values) // 2
            median = (values[mid] if len(values) % 2
                      else 0.5 * (values[mid - 1] + values[mid]))
            if median <= 0:
                return times, []
            thr = self._ctx.straggler_threshold
            return times, sorted(nid for nid, t in times.items()
                                 if t > thr * median)

    def results_complete(self) -> bool:
        with self._lock:
            if not self._results:
                return False
            world = set(self._rdzv_nodes.keys())
            last = max(self._results.keys())
            return bool(world) and world.issubset(self._results[last].keys())

    def network_ready(self) -> bool:
        with self._lock:
            if not self._results:
                return False
            results = self._results[max(self._results.keys())]
            world = set(self._rdzv_nodes.keys())
            if not world or not world.issubset(results.keys()):
                return False
            return all(ok for ok, _ in results.values())
