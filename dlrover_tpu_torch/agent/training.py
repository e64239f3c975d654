"""The elastic training agent, one a node — the port's own copy of
``dlrover_tpu/agent/training.py`` (``ElasticLaunchConfig``,
``WorkerProcess``, ``RunResult``, ``ElasticTrainingAgent`` with
``_rendezvous``, ``_start_workers``, ``_stop_workers``, ``_monitor`` and
``run``, and ``launch_agent``).

Each round: join the master's rendezvous (the join re-sent with the same
attempt id every ``rdzv_rejoin_interval`` while no world has formed, so a
restarted master re-learns the node; a fresh coordinator port every
round), start ``nproc_per_node`` workers with the env contract
(``common/env.worker_env`` plus the local keys, each in a session of its
own, the launcher's directory and this package on ``PYTHONPATH``), then
watch them.  When a worker fails, the membership changes or the master
asks, the agent runs the breakpoint save (``on_workers_stopping``, the
saver's ``save_shm_to_storage``), stops the workers — SIGTERM (and
SIGCONT, for a stopped one) to each process group, SIGKILL after the
grace period, and ``wait()`` on every
one, so that a killed process's card context is gone before the next round
starts — and forms the world again.  Unlike the reference, the group of
a worker that already exited is signalled too, so that no child it left
behind outlives the round.  A failure is diagnosed
(``diagnosis/agent.py``): in-place restart, or node replacement once the
budget of ``max_restarts`` is spent.

The agent owns the node's ``AsyncCheckpointSaver``, with the master client
(its ``CkptPerf`` reports and the step barrier).  Not ported: the
``ResourceMonitor``, the ``ParalConfigTuner`` (``DLROVER_TPU_AUTO_TUNE``),
the metrics endpoint (``DLROVER_TPU_METRICS_PORT``), the chaos plan
(``DLROVER_TPU_FAULTS``) and service roles (``node_role`` other than a
worker's), each refused by name; the replica seeding of the saver comes
with ``constants.REPLICA_ITEM``.  The pre-flight node check
(``network_check``, ``comm_perf_test``) runs in the launcher before the
agent (``agent/node_check.py``).  The agent acts on the heartbeat actions
of the master's diagnosis manager (``RESTART_WORKER``,
``RELAUNCH_WORKER``, ``STOP_JOB``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import threading
import time
import uuid
from typing import List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import (
    CHAOS_LAYER,
    HOST_LAYERS,
    DiagnosisActionType,
    NodeStatus,
    RendezvousName,
)
from dlrover_tpu_torch.common.env import worker_env
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import find_free_port, local_ip


@dataclasses.dataclass
class ElasticLaunchConfig:
    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1
    node_id: int = 0
    node_rank: int = 0
    max_restarts: int = 3
    monitor_interval: float = 2.0
    rdzv_timeout: float = 600.0
    network_check: bool = False
    comm_perf_test: bool = False
    log_dir: str = ""
    job_name: str = "local-job"
    slice_id: str = ""
    node_role: str = "worker"


def refuse_later_options(config: ElasticLaunchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's agent does not
    have yet, each by name."""
    ctx = get_context()
    refused = [
        (config.node_role not in ("worker", "chief"),
         f"node_role={config.node_role!r} (a service role)", HOST_LAYERS),
        (ctx.auto_tune, "DLROVER_TPU_AUTO_TUNE (agent/config_tuner.py)",
         HOST_LAYERS),
        (os.environ.get("DLROVER_TPU_METRICS_PORT", "0") not in ("", "0"),
         "DLROVER_TPU_METRICS_PORT (agent/metrics.py)", HOST_LAYERS),
        (bool(os.environ.get("DLROVER_TPU_FAULTS")),
         "fault injection (DLROVER_TPU_FAULTS)", CHAOS_LAYER),
    ]
    for on, what, where in refused:
        if on:
            raise NotImplementedError(f"{what} comes with {where}")


def _signal_group(pgid: int, sig: int) -> None:
    try:
        os.killpg(pgid, sig)
    except (ProcessLookupError, PermissionError):
        pass


class WorkerProcess:
    def __init__(self, local_rank: int, proc: subprocess.Popen,
                 log_file=None):
        self.local_rank = local_rank
        self.proc = proc
        self.log_file = log_file

    def poll(self) -> Optional[int]:
        return self.proc.poll()


class RunResult:
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    MEMBERSHIP_CHANGED = "membership_changed"
    STOP_JOB = "stop_job"
    RESTART_REQUESTED = "restart_requested"
    RELAUNCH_REQUESTED = "relaunch_requested"


class ElasticTrainingAgent:
    def __init__(self, config: ElasticLaunchConfig, entrypoint: List[str],
                 master_addr: str, client: Optional[MasterClient] = None):
        refuse_later_options(config)
        self.config = config
        self.entrypoint = entrypoint
        self.master_addr = master_addr
        self.client = client or MasterClient(master_addr, config.node_id)
        self._ctx = get_context()
        self._workers: List[WorkerProcess] = []
        self._stop_evt = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._pending_action: Optional[str] = None
        self._restart_count = 0
        self._host = local_ip()
        self._rdzv_round = -1
        self.on_workers_stopping = None  # callable(reason), before a kill
        self.saver = None  # the AsyncCheckpointSaver
        self._last_failures: List[tuple] = []
        from dlrover_tpu_torch.diagnosis.agent import DiagnosisAgent

        self.diagnosis = DiagnosisAgent(
            self.client, log_dir=config.log_dir,
            max_in_place_restarts=config.max_restarts)

    def _report_status(self, status: str, exit_reason: str = "") -> None:
        """Best effort: a report that spends its retries must not take
        down the agent that is meant to outlive it."""
        try:
            self.client.report_node_status(
                status, node_type=self.config.node_role or "worker",
                exit_reason=exit_reason)
        except Exception as e:  # noqa: BLE001
            logger.warning("status report %r failed (continuing): %s",
                           status, e)

    def _report_failure_safe(self, error_data: str,
                             restart_count: int = 0) -> None:
        try:
            self.client.report_failure(error_data,
                                       restart_count=restart_count)
        except Exception as e:  # noqa: BLE001
            logger.warning("failure report failed (continuing): %s", e)

    # -- heartbeats -----------------------------------------------------------
    def _start_heartbeat(self) -> None:
        if self._hb_thread is not None:
            return

        def loop():
            while not self._stop_evt.wait(self._ctx.node_heartbeat_interval):
                try:
                    for a in self.client.report_heartbeat():
                        if a.action_type != DiagnosisActionType.NONE:
                            logger.info("heartbeat action: %s (%s)",
                                        a.action_type, a.reason)
                            self._pending_action = a.action_type
                except Exception as e:  # noqa: BLE001
                    logger.warning("heartbeat failed: %s", e)

        self._hb_thread = threading.Thread(target=loop,
                                           name="agent-heartbeat",
                                           daemon=True)
        self._hb_thread.start()

    # -- rendezvous -----------------------------------------------------------
    def _rendezvous(self) -> dict:
        """Join and poll until this node is in a completed world:
        ``{round, world, my_rank, coordinator, num_processes}``.  Failed
        RPCs are retried until the rendezvous deadline; while no world has
        formed, the registration and the join are re-sent every
        ``rdzv_rejoin_interval`` with the same attempt id."""
        cfg = self.config
        coord_port = find_free_port()  # fresh a round: no TIME_WAIT, no
        attempt_id = uuid.uuid4().hex  # stale store from the last one
        deadline = time.monotonic() + cfg.rdzv_timeout
        rejoin_interval = max(1.0, self._ctx.rdzv_rejoin_interval)
        joined = False
        last_join = 0.0
        join_failures = 0

        def _join() -> None:
            self.client.register_node(
                node_type=cfg.node_role, node_rank=cfg.node_rank,
                host=self._host, agent_port=coord_port,
                slice_id=cfg.slice_id, local_world_size=cfg.nproc_per_node)
            self.client.join_rendezvous(
                cfg.node_rank, cfg.nproc_per_node,
                rdzv_name=RendezvousName.TRAINING, slice_id=cfg.slice_id,
                attempt_id=attempt_id)

        while time.monotonic() < deadline:
            if not joined or time.monotonic() - last_join >= rejoin_interval:
                try:
                    _join()
                    if joined:
                        logger.info("rendezvous: re-sent join (no world "
                                    "after %.0fs; master may have "
                                    "restarted)",
                                    time.monotonic() - last_join)
                    joined = True
                    last_join = time.monotonic()
                    join_failures = 0
                except Exception as e:  # noqa: BLE001
                    join_failures += 1
                    logger.warning("rendezvous join failed (will retry): "
                                   "%s", e)
                    if join_failures % 3 == 0:
                        self.client.reconnect()
                    time.sleep(min(1.0, max(0.0,
                                            deadline - time.monotonic())))
                    continue
            try:
                round_, _, world, coordinator = self.client.get_comm_world(
                    RendezvousName.TRAINING)
            except Exception as e:  # noqa: BLE001
                logger.warning("rendezvous poll failed (will retry): %s", e)
                time.sleep(min(1.0, max(0.0, deadline - time.monotonic())))
                continue
            if world:
                my_rank = next((int(rank) for rank, meta in world.items()
                                if meta["node_id"] == cfg.node_id), None)
                if my_rank is None:
                    # The round completed without this node (the node-unit
                    # cut): wait for the next.
                    time.sleep(1.0)
                    continue
                num_processes = sum(w["local_world_size"]
                                    for w in world.values())
                self._rdzv_round = round_
                logger.info("rendezvous round %d: world=%d nodes, "
                            "my_rank=%d, coordinator=%s", round_,
                            len(world), my_rank, coordinator)
                return {"round": round_, "world": world, "my_rank": my_rank,
                        "coordinator": coordinator,
                        "num_processes": num_processes}
            time.sleep(0.5)
        raise TimeoutError(
            f"rendezvous did not complete within {cfg.rdzv_timeout}s")

    # -- workers --------------------------------------------------------------
    def _start_workers(self, world_info: dict) -> None:
        cfg = self.config
        world = world_info["world"]
        base = world[world_info["my_rank"]]["process_id_base"]
        self._workers = []
        if self.saver is not None:
            self.saver.update_world(world_info["my_rank"],
                                    len(world_info["world"]))
        # A worker runs ``python script.py`` (sys.path[0] is the script's
        # directory): the launcher's directory and this package go on
        # PYTHONPATH, as torchrun does.
        import dlrover_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
            dlrover_tpu_torch.__file__)))
        extra_path = [os.getcwd(), pkg_root]
        for lr in range(cfg.nproc_per_node):
            env = dict(os.environ)
            old_pp = env.get("PYTHONPATH", "")
            env["PYTHONPATH"] = os.pathsep.join(
                [p for p in extra_path if p] + ([old_pp] if old_pp else []))
            # The client's address: after a master failover, the leader's.
            env.update(worker_env(
                job_name=cfg.job_name, master_addr=self.client.master_addr,
                node_id=cfg.node_id, node_rank=world_info["my_rank"],
                node_num=len(world), process_id=base + lr,
                num_processes=world_info["num_processes"],
                coordinator=world_info["coordinator"],
                restart_count=self._restart_count))
            env["DLROVER_TPU_LOCAL_RANK"] = str(lr)
            env["DLROVER_TPU_LOCAL_WORLD_SIZE"] = str(cfg.nproc_per_node)
            env["DLROVER_TPU_RDZV_ROUND"] = str(world_info["round"])
            env["DLROVER_TPU_NODE_ROLE"] = cfg.node_role or "worker"
            log_file = None
            stdout = stderr = None
            if cfg.log_dir:
                os.makedirs(cfg.log_dir, exist_ok=True)
                path = os.path.join(
                    cfg.log_dir, f"worker_r{world_info['my_rank']}_l{lr}"
                    f"_round{world_info['round']}.log")
                log_file = open(path, "ab")
                stdout = stderr = log_file
            proc = subprocess.Popen(self.entrypoint, env=env, stdout=stdout,
                                    stderr=stderr, start_new_session=True)
            self._workers.append(WorkerProcess(lr, proc, log_file))
        logger.info("started %d worker(s): pids=%s", len(self._workers),
                    [w.proc.pid for w in self._workers])

    def _stop_workers(self, reason: str = "", grace: float = 10.0) -> None:
        if not self._workers:
            return
        if self.on_workers_stopping is not None:
            t0 = time.perf_counter()
            try:
                self.on_workers_stopping(reason)
            except Exception:  # noqa: BLE001
                logger.exception("on_workers_stopping hook failed")
            logger.info("on_workers_stopping (%s) took %.1f ms", reason,
                        (time.perf_counter() - t0) * 1e3)
        # Each worker leads a session of its own, so its process group id
        # is its pid: the group is signalled even when the worker itself
        # already died and left children behind.  A stopped (hung) worker
        # takes its SIGTERM only once continued.
        for w in self._workers:
            _signal_group(w.proc.pid, signal.SIGTERM)
            _signal_group(w.proc.pid, signal.SIGCONT)
        deadline = time.monotonic() + grace
        for w in self._workers:
            try:
                w.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _signal_group(w.proc.pid, signal.SIGKILL)
                w.proc.wait()
        for w in self._workers:  # what ignored SIGTERM in a group
            _signal_group(w.proc.pid, signal.SIGKILL)
        for w in self._workers:
            if w.log_file:
                w.log_file.close()
        logger.info("stopped workers (%s)", reason or "requested")
        self._workers = []

    def _monitor(self) -> str:
        cfg = self.config
        while True:
            time.sleep(cfg.monitor_interval)
            action = self._pending_action
            self._pending_action = None
            if action == DiagnosisActionType.STOP_JOB:
                return RunResult.STOP_JOB
            if action == DiagnosisActionType.RELAUNCH_WORKER:
                return RunResult.RELAUNCH_REQUESTED
            if action == DiagnosisActionType.RESTART_WORKER:
                return RunResult.RESTART_REQUESTED
            codes = [w.poll() for w in self._workers]
            if all(c == 0 for c in codes):
                return RunResult.SUCCEEDED
            if any(c is not None and c != 0 for c in codes):
                bad = [(w.local_rank, c) for w, c in zip(self._workers, codes)
                       if c not in (None, 0)]
                logger.warning("worker failure(s): %s", bad)
                self._last_failures = bad
                return RunResult.FAILED
            try:
                if self.client.num_nodes_waiting(
                        RendezvousName.TRAINING) > 0:
                    return RunResult.MEMBERSHIP_CHANGED
            except Exception as e:  # noqa: BLE001
                logger.warning("num_nodes_waiting failed: %s", e)

    # -- main entry -----------------------------------------------------------
    def run(self) -> int:
        cfg = self.config
        self._start_heartbeat()
        if self.saver is None:
            try:
                from dlrover_tpu_torch.agent.ckpt_saver import \
                    AsyncCheckpointSaver

                self.saver = AsyncCheckpointSaver(
                    cfg.job_name, cfg.nproc_per_node,
                    master_client=self.client)
                self.saver.start()
                self.on_workers_stopping = self.saver.save_shm_to_storage
            except Exception:  # noqa: BLE001
                logger.exception("could not start async checkpoint saver")
        try:
            while True:
                world_info = self._rendezvous()
                self._report_status(NodeStatus.RUNNING)
                self._start_workers(world_info)
                result = self._monitor()
                if result == RunResult.SUCCEEDED:
                    self._stop_workers("success", grace=5.0)
                    self._report_status(NodeStatus.SUCCEEDED)
                    logger.info("node %d training succeeded", cfg.node_id)
                    return 0
                if result == RunResult.STOP_JOB:
                    self._stop_workers("stop-job")
                    self._report_status(NodeStatus.FAILED,
                                        exit_reason="stopped_by_master")
                    return 1
                if result == RunResult.RELAUNCH_REQUESTED:
                    self._stop_workers("master requested node relaunch")
                    self._report_status(NodeStatus.FAILED,
                                        exit_reason="relaunch_requested")
                    return 1
                if result == RunResult.FAILED:
                    self._restart_count += 1
                    self._report_failure_safe(
                        f"worker failure (restart {self._restart_count}/"
                        f"{cfg.max_restarts}): {self._last_failures}",
                        restart_count=self._restart_count)
                    action = self.diagnosis.diagnose_training_failure(
                        self._last_failures, self._restart_count)
                    if (action == DiagnosisActionType.RELAUNCH_WORKER
                            or self._restart_count > cfg.max_restarts):
                        self._stop_workers("relaunch requested")
                        self._report_status(
                            NodeStatus.FAILED,
                            exit_reason="relaunch_requested"
                            if self._restart_count <= cfg.max_restarts
                            else "max_restarts")
                        return 1
                    self._stop_workers("worker failure; re-rendezvous")
                elif result in (RunResult.MEMBERSHIP_CHANGED,
                                RunResult.RESTART_REQUESTED):
                    logger.info("restarting workers: %s", result)
                    self._stop_workers(result)
        finally:
            self._stop_evt.set()
            self._stop_workers("agent exiting")
            if self.saver is not None:
                self.saver.stop()


def launch_agent(config: ElasticLaunchConfig, entrypoint: List[str],
                 master_addr: str) -> int:
    agent = ElasticTrainingAgent(config, entrypoint, master_addr)
    return agent.run()
