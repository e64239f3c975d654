"""The job launcher: ``python -m dlrover_tpu_torch.run`` — the port's own
copy of ``dlrover_tpu/run.py`` (``parse_nnodes``, ``parse_args``,
``_master_cmd``, ``_launch_local_master``, ``_launch_standby_master``
``:214-247``, ``_supervise_local_master``, ``_supervise_ha_masters``
``:309-410``, ``_gc_shm_arenas``, ``run``, ``main``)::

    python -m dlrover_tpu_torch.run --standalone --nproc_per_node=2 \\
        dlrover_tpu_torch/train.py -- --model tiny --device cpu \\
        --ckpt_dir /tmp/ck --ckpt_interval 2

With ``--standalone`` (and no ``--master_addr``) it starts the port's local
master (``python -m dlrover_tpu_torch.master.main``) as a child, and keeps
it alive: a master that exits with a nonzero code is started again on the
same port (agents ride the gap through the RPC retry and the rendezvous
re-join).  Every launch gets a ``DLROVER_TPU_RUN_ID`` that scopes the shm
arenas of its workers and its agent's saver; the arenas of earlier launches
of the job idle for an hour are collected at start, and this launch's at
exit.  The master's run config is merged into the agent's; with
``--network_check`` or ``--comm_perf_test`` (from the command line or the
run config) the pre-flight node check runs (``agent/node_check.py``), and
a node the master finds faulty exits with 3; then the agent runs
(``agent/training.py``).  Unlike the reference, a SIGTERM to the
launcher unwinds it as an error does: the agent stops its workers and the
master is terminated, where the reference's default handler would orphan
them.

With ``--standby`` the local master journals its control state in
``--master_state_dir`` (default: a run-scoped dir under the temp dir) and
a warm standby master tails it (``master/standby.py``).  When the primary
dies the standby takes over; the supervisor promotes it into the primary's
place and starts a fresh standby behind it, within the restart budget.
Agents and workers follow the leader through the state dir's ``addr``
file (``DLROVER_TPU_MASTER_STATE_DIR``), so repeated failovers need no
change of environment.  Each master of this mode runs in a session of its
own (the reference starts the standby in the launcher's group), so that no
signal aimed at a master reaches the launcher; the launcher logs every
master's pid and terminates the ones alive at its exit.

Refused by name: ``--cell`` and ``--job_file`` (``HOST_LAYERS``), and what
the agent refuses.
"""

from __future__ import annotations

import argparse
import atexit
import glob
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import List, Optional, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training import (
    ElasticLaunchConfig,
    launch_agent,
    refuse_later_options as refuse_agent_options,
)
from dlrover_tpu_torch.common.constants import HOST_LAYERS
from dlrover_tpu_torch.common.env import NodeEnv
from dlrover_tpu_torch.common.log import logger, set_role
from dlrover_tpu_torch.common.rpc import addr_connectable


def parse_nnodes(spec: str) -> Tuple[int, int]:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return int(lo), int(hi)
    n = int(spec)
    return n, n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dlrover_tpu_torch.run",
                                description="elastic training launcher")
    p.add_argument("--standalone", action="store_true",
                   help="one host: start a local master")
    p.add_argument("--standby", action="store_true",
                   help="master HA: journal the local master's control "
                        "state and keep a warm standby master")
    p.add_argument("--master_state_dir", default="",
                   help="the journal's dir for --standby (default: a "
                        "run-scoped dir under the temp dir)")
    p.add_argument("--cell", type=int, default=0)
    p.add_argument("--nnodes", default="1",
                   help="'N' or 'MIN:MAX' elastic node range")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("DLROVER_TPU_NODE_RANK", 0)))
    p.add_argument("--node_id", type=int, default=-1,
                   help="stable node id (defaults to node_rank)")
    p.add_argument("--master_addr",
                   default=os.environ.get("DLROVER_TPU_MASTER_ADDR", ""))
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--monitor_interval", type=float, default=2.0)
    p.add_argument("--rdzv_timeout", type=float, default=600.0)
    p.add_argument("--network_check", action="store_true")
    p.add_argument("--comm_perf_test", action="store_true")
    p.add_argument("--node_unit", type=int, default=1)
    p.add_argument("--log_dir", default="")
    p.add_argument("--job_name",
                   default=os.environ.get("DLROVER_TPU_JOB_NAME",
                                          "local-job"))
    p.add_argument("--node_role",
                   default=os.environ.get("DLROVER_TPU_NODE_ROLE",
                                          "worker"))
    p.add_argument("--no_python", action="store_true",
                   help="the entrypoint is a program, not a python script")
    p.add_argument("--job_file", default="")
    p.add_argument("entrypoint", nargs="?", default="")
    p.add_argument("args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    refuse_later_options(args)
    if not args.entrypoint:
        p.error("entrypoint is required")
    return args


def refuse_later_options(args: argparse.Namespace) -> None:
    refused = [
        (args.cell > 0, "--cell (the multi-cell control plane)",
         HOST_LAYERS),
        (args.job_file, "--job_file (ElasticJob YAML)", HOST_LAYERS),
    ]
    for on, what, where in refused:
        if on:
            raise NotImplementedError(f"{what} comes with {where}")


def _master_cmd(args, port: int, port_file: str = "",
                state_dir: str = "") -> List[str]:
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.master.main",
           "--port", str(port), "--job_name", args.job_name,
           "--platform", "local", "--min_nodes", str(min_nodes),
           "--max_nodes", str(max_nodes), "--node_unit", str(args.node_unit)]
    if port_file:
        cmd += ["--port_file", port_file]
    if state_dir:
        cmd += ["--state_dir", state_dir]
    return cmd


def _await_port(cmd: List[str], what: str, own_session: bool
                ) -> Tuple[subprocess.Popen, int]:
    """Start a master with ``--port_file`` appended and wait for the port
    it bound."""
    fd, port_file = tempfile.mkstemp(prefix="dlrtpu_master_port_")
    os.close(fd)
    os.unlink(port_file)  # the master writes it when it listens
    proc = subprocess.Popen(cmd + ["--port_file", port_file],
                            start_new_session=own_session)
    deadline = time.time() + 60
    while time.time() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                content = f.read().strip()
            if content:
                os.unlink(port_file)
                return proc, int(content)
        if proc.poll() is not None:
            raise RuntimeError(
                f"{what} exited early with code {proc.returncode}")
        time.sleep(0.1)
    proc.kill()
    proc.wait()
    raise TimeoutError(f"{what} did not report its port in 60s")


def _launch_local_master(args, state_dir: str = ""
                         ) -> Tuple[subprocess.Popen, str, int]:
    """Start the master (journaling in ``state_dir``, in a session of its
    own, when given one) and wait for the port it bound."""
    proc, port = _await_port(_master_cmd(args, 0, state_dir=state_dir),
                             "local master", own_session=bool(state_dir))
    addr = f"127.0.0.1:{port}"
    logger.info("local master pid=%d on %s%s", proc.pid, addr,
                f" journaling in {state_dir}" if state_dir else "")
    return proc, addr, port


def _launch_standby_master(args, state_dir: str, primary_addr: str
                           ) -> Tuple[subprocess.Popen, str]:
    """Start a warm standby of ``primary_addr`` in a session of its own
    and wait for the port it bound (it serves only after a takeover)."""
    cmd = _master_cmd(args, 0, state_dir=state_dir) + [
        "--standby", "--primary_addr", primary_addr]
    t0 = time.perf_counter()
    proc, port = _await_port(cmd, "standby master", own_session=True)
    addr = f"127.0.0.1:{port}"
    logger.info("standby master pid=%d bound on %s in %.3f s", proc.pid,
                addr, time.perf_counter() - t0)
    return proc, addr


def _supervise_local_master(args, holder: List[subprocess.Popen],
                            port: int, stop_evt: threading.Event,
                            max_restarts: int = 3) -> threading.Thread:
    """Start the master again on the same port when it exits nonzero while
    the job runs; an exit of 0 (the job ended) or by a signal (the
    launcher's own teardown) ends the supervision."""

    def loop() -> None:
        restarts = 0
        while not stop_evt.wait(1.0):
            rc = holder[0].poll()
            if rc is None:
                continue
            if rc == 0 or rc < 0:
                return
            if restarts >= max_restarts:
                logger.error("local master exited rc=%d and its restart "
                             "budget (%d) is spent; agents will time out",
                             rc, max_restarts)
                return
            restarts += 1
            logger.warning("local master exited rc=%d; relaunching on port "
                           "%d (restart %d/%d)", rc, port, restarts,
                           max_restarts)
            holder[0] = subprocess.Popen(_master_cmd(args, port))

    thread = threading.Thread(target=loop, name="master-supervisor",
                              daemon=True)
    thread.start()
    return thread


def _supervise_ha_masters(args, state_dir: str,
                          primary_holder: List[subprocess.Popen],
                          standby_holder: List[subprocess.Popen],
                          stop_evt: threading.Event,
                          max_restarts: int = 3) -> threading.Thread:
    """The ``--standby`` supervision: when the primary dies the standby
    takes the journaled state over, so the supervisor waits for the
    takeover (the state dir's ``addr`` changes), promotes the standby into
    the primary's place and starts a fresh standby behind the new leader.
    A standby that dies while the primary lives is started again.  Each
    new standby spends one of ``max_restarts``."""
    from dlrover_tpu_torch.master.state import read_addr

    def respawn(primary_addr: str) -> bool:
        try:
            standby_holder[0], _ = _launch_standby_master(args, state_dir,
                                                          primary_addr)
            return True
        except (RuntimeError, TimeoutError) as e:
            logger.error("could not start a standby: %s; the next master "
                         "crash will be cold", e)
            return False

    def loop() -> None:
        restarts = 0
        while not stop_evt.wait(1.0):
            primary, standby = primary_holder[0], standby_holder[0]
            prc = primary.poll()
            if prc is None:
                src = standby.poll()
                if src is None or src == 0 or stop_evt.is_set():
                    continue
                if restarts >= max_restarts:
                    logger.error("standby exited rc=%d and the restart "
                                 "budget (%d) is spent", src, max_restarts)
                    return
                restarts += 1
                logger.warning("standby exited rc=%d; starting another "
                               "(restart %d/%d)", src, restarts,
                               max_restarts)
                if not respawn(read_addr(state_dir)):
                    return
                continue
            if prc == 0 or (prc < 0 and stop_evt.is_set()):
                # The job ended, or the launcher's own teardown.  A signal
                # death alone is the failure this mode covers.
                return
            old_addr, new_addr = read_addr(state_dir), ""
            deadline = time.time() + 60
            while time.time() < deadline and not stop_evt.is_set():
                cur = read_addr(state_dir)
                if cur and cur != old_addr:
                    new_addr = cur
                    break
                if standby_holder[0].poll() is not None:
                    break  # the standby died too
                time.sleep(0.05)
            if not new_addr:
                logger.error("primary master (pid %d) exited rc=%d and no "
                             "takeover followed; agents will time out",
                             primary.pid, prc)
                return
            logger.warning("primary master (pid %d) exited rc=%d; standby "
                           "(pid %d) took over at %s", primary.pid, prc,
                           standby.pid, new_addr)
            primary_holder[0] = standby
            if restarts >= max_restarts:
                logger.error("standby restart budget (%d) spent; the next "
                             "master crash will be cold", max_restarts)
                return
            restarts += 1
            if not respawn(new_addr):
                return

    thread = threading.Thread(target=loop, name="master-ha-supervisor",
                              daemon=True)
    thread.start()
    return thread


def _gc_shm_arenas(job_name: str, run_id: str = "",
                   min_age_s: float = 3600.0) -> None:
    """Unlink the ``/dev/shm`` arenas of ``job_name``: those of one run id
    (at exit), or with no run id only those idle for ``min_age_s`` (at
    start: a sibling node on this host keeps its live arena fresh)."""
    safe = job_name.replace("/", "_")
    scope = f"{safe}-{run_id}" if run_id else f"{safe}-*"
    now = time.time()
    for path in glob.glob(f"/dev/shm/dlrtpu_{scope}_*"):
        try:
            if not run_id and now - os.stat(path).st_mtime < min_age_s:
                continue
            os.unlink(path)
        except OSError:
            pass


def _coerce(cur, val):
    if isinstance(cur, bool) and isinstance(val, str):
        return val.strip().lower() in ("1", "true", "yes", "on")
    return type(cur)(val)


def _exit_on_sigterm(signum, frame) -> None:
    raise SystemExit(128 + signum)


def run(args: argparse.Namespace) -> int:
    refuse_later_options(args)
    set_role(f"agent-{args.node_rank}")
    # SIGTERM unwinds like an error (the agent stops its workers, the
    # master is terminated at exit) instead of orphaning them.
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    os.environ["DLROVER_TPU_NODE_ROLE"] = args.node_role
    os.environ.setdefault("DLROVER_TPU_RUN_ID", uuid.uuid4().hex[:8])
    _gc_shm_arenas(args.job_name)
    atexit.register(_gc_shm_arenas, args.job_name,
                    os.environ["DLROVER_TPU_RUN_ID"])
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    node_id = args.node_id if args.node_id >= 0 else args.node_rank
    config = ElasticLaunchConfig(
        min_nodes=min_nodes, max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node, node_id=node_id,
        node_rank=args.node_rank, max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        rdzv_timeout=args.rdzv_timeout, network_check=args.network_check,
        comm_perf_test=args.comm_perf_test, log_dir=args.log_dir,
        job_name=args.job_name, node_role=args.node_role)
    refuse_agent_options(config)
    master_holder: List[subprocess.Popen] = []
    standby_holder: List[subprocess.Popen] = []
    master_stop = threading.Event()
    master_addr = args.master_addr
    ha_state_dir = ""
    if args.standalone and not master_addr:
        if args.standby:
            ha_state_dir = args.master_state_dir or os.path.join(
                tempfile.gettempdir(), f"dlrtpu_ha_{args.job_name}_"
                f"{os.environ['DLROVER_TPU_RUN_ID']}")
            os.makedirs(ha_state_dir, exist_ok=True)
        proc, master_addr, master_port = _launch_local_master(
            args, ha_state_dir)
        master_holder.append(proc)
        atexit.register(lambda: master_holder[0].poll() is None
                        and master_holder[0].terminate())
        if args.standby:
            sb_proc, standby_addr = _launch_standby_master(
                args, ha_state_dir, master_addr)
            standby_holder.append(sb_proc)
            atexit.register(lambda: standby_holder[0].poll() is None
                            and standby_holder[0].terminate())
            # The agent and its workers (by inheritance) follow the
            # leader through the state dir.
            os.environ[NodeEnv.MASTER_STATE_DIR] = ha_state_dir
            os.environ[NodeEnv.MASTER_STANDBY_ADDR] = standby_addr
            _supervise_ha_masters(args, ha_state_dir, master_holder,
                                  standby_holder, master_stop,
                                  args.max_restarts)
        else:
            _supervise_local_master(args, master_holder, master_port,
                                    master_stop)
    if not master_addr:
        raise SystemExit("either --standalone or --master_addr is required")
    if not addr_connectable(master_addr, timeout=30):
        raise SystemExit(f"master at {master_addr} is not reachable")

    client = MasterClient(master_addr, node_id, state_dir=ha_state_dir)
    try:
        for key, val in client.get_elastic_run_config().items():
            if hasattr(config, key):
                setattr(config, key, _coerce(getattr(config, key), val))
    except Exception as e:  # noqa: BLE001
        logger.warning("could not fetch master run config: %s", e)
    refuse_agent_options(config)  # the merged config, as the reference
    # Gated on the merged config: a master that turns the checks on or off
    # takes effect.
    if config.network_check or config.comm_perf_test:
        from dlrover_tpu_torch.agent.node_check import node_health_check

        if not node_health_check(config, master_addr, client):
            logger.error("node health check failed; exiting for relaunch")
            master_stop.set()
            client.close()
            return 3

    entry = ([args.entrypoint] if args.no_python
             else [sys.executable, "-u", args.entrypoint])
    script_args = args.args
    if script_args and script_args[0] == "--":
        script_args = script_args[1:]
    try:
        rc = launch_agent(config, entry + script_args, master_addr)
    finally:
        master_stop.set()
    if master_holder:
        try:
            client.report_job_exit(rc == 0, "launcher done")
        except Exception as e:  # noqa: BLE001
            logger.debug("job-exit report to master failed: %s", e)
        # A standby stands down on the leader's clean shutdown record.
        for what, holder in (("local master", master_holder),
                             ("standby master", standby_holder)):
            if not holder:
                continue
            try:
                holder[0].wait(timeout=30)
            except subprocess.TimeoutExpired:
                logger.warning("%s did not exit in 30s; terminating", what)
                holder[0].terminate()
                holder[0].wait()
    client.close()
    return rc


def main() -> None:
    sys.exit(run(parse_args()))


if __name__ == "__main__":
    main()
