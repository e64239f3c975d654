"""Environment helpers — the port's own copy of the getters of
``dlrover_tpu/common/env.py`` that ``trainer/bootstrap.py`` and the
checkpoint read, with the names of ``dlrover_tpu/common/constants.py``
``NodeEnv`` (the agent/worker environment contract)."""

from __future__ import annotations

import os


class NodeEnv:
    """Environment variables of the agent/worker contract."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
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
