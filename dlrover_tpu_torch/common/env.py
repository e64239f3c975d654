"""Environment helpers — the port's own copy of the getters of
``dlrover_tpu/common/env.py`` that ``trainer/bootstrap.py``,
``common/dist_env.py``, the checkpoint and the master client read
(``get_coordinator``, ``worker_env``: ``env.py:77-105``;
``get_master_standby_addr`` ``:37``, ``get_master_state_dir`` ``:43``),
with the names of
``dlrover_tpu/common/constants.py`` ``NodeEnv`` (the agent/worker
environment contract)."""

from __future__ import annotations

import os
from typing import Optional


class NodeEnv:
    """Environment variables of the agent/worker contract."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    MASTER_STANDBY_ADDR = "DLROVER_TPU_MASTER_STANDBY_ADDR"
    MASTER_STATE_DIR = "DLROVER_TPU_MASTER_STATE_DIR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    LOCAL_RANK = "DLROVER_TPU_LOCAL_RANK"
    RUN_ID = "DLROVER_TPU_RUN_ID"


def get_env_int(name: str, default: int = 0) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def get_env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def get_node_id() -> int:
    return get_env_int(NodeEnv.NODE_ID, 0)


def get_node_rank() -> int:
    return get_env_int(NodeEnv.NODE_RANK, get_node_id())


def get_node_num() -> int:
    return get_env_int(NodeEnv.NODE_NUM, 1)


def get_master_addr() -> str:
    return get_env_str(NodeEnv.MASTER_ADDR)


def get_master_standby_addr() -> str:
    """The warm standby master's address, when one runs: clients move to
    it once the primary stops answering."""
    return get_env_str(NodeEnv.MASTER_STANDBY_ADDR)


def get_master_state_dir() -> str:
    """The master's HA state dir: clients read the serving master's
    address from its ``addr`` file, which every leader rewrites."""
    return get_env_str(NodeEnv.MASTER_STATE_DIR)


def get_job_name() -> str:
    return get_env_str(NodeEnv.JOB_NAME, "local-job")


def get_run_id() -> str:
    """Id of one launcher invocation: it namespaces host-local IPC objects
    (shm arenas), so a fresh launch never warm-restores a previous job's
    stale arena while restarts within a launch share it."""
    return get_env_str(NodeEnv.RUN_ID)


def run_scoped(name: str) -> str:
    """Append the run id (when set) to an IPC object name."""
    rid = get_run_id()
    return f"{name}-{rid}" if rid else name


def get_process_id() -> int:
    return get_env_int(NodeEnv.PROCESS_ID, 0)


def get_num_processes() -> int:
    return get_env_int(NodeEnv.NUM_PROCESSES, 1)


def get_local_rank() -> int:
    return get_env_int(NodeEnv.LOCAL_RANK, 0)


def get_coordinator() -> Optional[str]:
    v = get_env_str(NodeEnv.COORDINATOR_ADDR)
    return v or None


def worker_env(
    *,
    job_name: str,
    master_addr: str,
    node_id: int,
    node_rank: int,
    node_num: int,
    process_id: int,
    num_processes: int,
    coordinator: str,
    restart_count: int = 0,
) -> dict:
    """The env contract the agent passes to each spawned worker process."""
    return {
        NodeEnv.JOB_NAME: job_name,
        NodeEnv.MASTER_ADDR: master_addr,
        NodeEnv.NODE_ID: str(node_id),
        NodeEnv.NODE_RANK: str(node_rank),
        NodeEnv.NODE_NUM: str(node_num),
        NodeEnv.PROCESS_ID: str(process_id),
        NodeEnv.NUM_PROCESSES: str(num_processes),
        NodeEnv.COORDINATOR_ADDR: coordinator,
        NodeEnv.RESTART_COUNT: str(restart_count),
    }
