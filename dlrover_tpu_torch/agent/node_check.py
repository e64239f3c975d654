"""The pre-flight node check — the port's own copy of
``dlrover_tpu/agent/node_check.py`` (``_PAYLOAD`` ``:27``,
``_run_check_payload`` ``:97``, ``node_health_check`` ``:133``).

Before the agent starts its workers, the launcher (``--network_check``,
``--comm_perf_test``) has the node join the master's network-check
rendezvous, which pairs the nodes into sub-worlds of two (round 0 by
rank, later rounds fastest with slowest), and runs a payload in a
subprocess (a wedged card cannot hang the agent):

- a bf16 ``[n, n]`` matmul repeated 8 times (``n`` 4096 on the card, 512
  on the CPU), after 0.2 s of untimed matmuls (the cuBLAS handle and
  workspace, and the card's clocks), with the card synchronised before
  each clock read (the card's own time of them, from CUDA events, goes
  beside it in the ``NODE_CHECK_DETAIL`` line); its input, ``ones / n``,
  is its own square, so a result that is not finite fails the check;
- when the pair has two processes, a sum ``all_reduce`` of 16 Mi fp32 (1
  Mi on the CPU) over a ``torch.distributed`` world of the pair (one
  warm-up outside the timed region, then 4 timed), on ``nccl`` when each
  process has its own card and ``gloo`` otherwise (``common/dist_env.py``'s
  rule); with ``--comm_perf_test`` the last round also sweeps the
  ``all_reduce`` over 4, 16 and 64 MB and prints ``COMM_PERF`` lines.

Its ``NODE_CHECK_RESULT <seconds>`` line is reported to the master, whose
verdict (``get_fault_nodes``, ``get_stragglers_full``) decides: a faulty
node's launcher exits 3, a straggler is logged.  The environment contract
is the reference's: ``DLROVER_TPU_CHECK_COORD``, ``_NPROC``, ``_PID``,
``_MATMUL_N``, ``_ALLREDUCE_M``, ``_DELAY_S`` (a delay inside the timed
region, for tests) and ``DLROVER_TPU_COMM_PERF``; the port adds
``DLROVER_TPU_CHECK_DEVICE`` (``cpu`` runs the payload on the CPU, as the
tests ask; unset, the card).  A payload that cannot reach its device,
fails or times out reports ``succeeded=False``: it never drops to the CPU
on its own.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import find_free_port, local_ip

#: Matmuls a check times, and the ``all_reduce`` s.
MATMUL_REPS = 8
ALLREDUCE_REPS = 4
#: Seconds of untimed matmuls before the timed ones.
WARMUP_S = 0.2

_PAYLOAD = r"""
import json, math, os, time
import torch
import torch.distributed as dist
from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common.device import process_device

nproc = int(os.environ.get("DLROVER_TPU_CHECK_NPROC", "1"))
dev = process_device(os.environ.get("DLROVER_TPU_CHECK_DEVICE") or None)
on_cpu = dev.type == "cpu"


def sync():
    if not on_cpu:
        torch.cuda.synchronize(dev)


if nproc > 1:
    dist_env.initialize_distributed_from_env(dev)
n = int(os.environ.get("DLROVER_TPU_CHECK_MATMUL_N",
                       "512" if on_cpu else "4096"))
reps = int(os.environ["DLROVER_TPU_CHECK_MATMUL_REPS"])
# ones / n is its own square, exactly for n a power of two: every
# product stays the input, so the result is checked as well as timed.
x0 = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)
# Warm-up outside the timed region: the cuBLAS handle and workspace, and
# the card's clocks, which an idle card ramps up only under load.
warmup_s = float(os.environ["DLROVER_TPU_CHECK_WARMUP_S"])
t0 = time.perf_counter()
while time.perf_counter() - t0 < warmup_s:
    x = x0 @ x0
    sync()
# The card's own time of the same matmuls, beside the host clock: a host
# that stalls the process shows in the one and not in the other.
events = None if on_cpu else [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
t0 = time.perf_counter()
if events:
    events[0].record()
for _ in range(reps):
    x = x @ x
if events:
    events[1].record()
sync()
# A "slow node" for tests: a fixed tax inside the timed region.
time.sleep(float(os.environ.get("DLROVER_TPU_CHECK_DELAY_S", "0")))
matmul_t = time.perf_counter() - t0
err = float(((x.float() - x0.float()).abs().max() * n).item())
flop = reps * 2 * n ** 3
detail = {"device": str(dev), "n": n, "reps": reps,
          "matmul_s": matmul_t, "tflops": flop / matmul_t / 1e12,
          "max_rel_err": err}
if events:
    device_s = events[0].elapsed_time(events[1]) / 1e3
    detail.update(matmul_device_s=device_s,
                  device_tflops=flop / device_s / 1e12)
if not math.isfinite(err):
    raise SystemExit(f"the matmul gave non-finite values: {detail}")
comm_t = 0.0
if nproc > 1:
    ar_reps = int(os.environ["DLROVER_TPU_CHECK_ALLREDUCE_REPS"])

    def all_reduce_s(m):
        buf = torch.ones(m, dtype=torch.float32, device=dev)
        dist.all_reduce(buf)  # waits for the partner, untimed
        sync()
        t = time.perf_counter()
        for _ in range(ar_reps):
            dist.all_reduce(buf)
        sync()
        return (time.perf_counter() - t) / ar_reps, buf

    m = int(os.environ.get("DLROVER_TPU_CHECK_ALLREDUCE_M",
                           "1048576" if on_cpu else "16777216"))
    per, buf = all_reduce_s(m)
    comm_t = per * ar_reps
    detail.update(backend=dist.get_backend(), allreduce_elems=m,
                  allreduce_s=comm_t,
                  allreduce_ok=bool(buf[0].item() == nproc ** (ar_reps + 1)))
    if os.environ.get("DLROVER_TPU_COMM_PERF", "") == "1":
        for m_sweep in (1 << 20, 1 << 22, 1 << 24):
            el, _ = all_reduce_s(m_sweep)
            busbw = 2.0 * (nproc - 1) / nproc * (m_sweep * 4) / el / 1e9
            print(f"COMM_PERF bytes={m_sweep * 4} time_s={el:.6f} "
                  f"busbw_gbps={busbw:.3f}", flush=True)
    dist_env.shutdown()
print("NODE_CHECK_DETAIL " + json.dumps(detail), flush=True)
print(f"NODE_CHECK_RESULT {matmul_t + comm_t:.6f}", flush=True)
"""


def _run_check_payload(coord: str, nproc: int, pid: int,
                       timeout: float = 300.0, comm_perf: bool = False,
                       local_rank: int = 0, hosts: int = 1
                       ) -> Optional[float]:
    """The payload's seconds, or ``None`` when it failed or timed out.
    ``local_rank`` and ``hosts`` place the pair's processes on this
    host's cards (``common/device.process_device``)."""
    import dlrover_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        dlrover_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(DLROVER_TPU_CHECK_COORD=coord,
               DLROVER_TPU_CHECK_NPROC=str(nproc),
               DLROVER_TPU_CHECK_PID=str(pid),
               DLROVER_TPU_CHECK_MATMUL_REPS=str(MATMUL_REPS),
               DLROVER_TPU_CHECK_WARMUP_S=str(WARMUP_S),
               DLROVER_TPU_CHECK_ALLREDUCE_REPS=str(ALLREDUCE_REPS),
               # dist_env's contract, for the pair's world.
               DLROVER_TPU_COORDINATOR=coord,
               DLROVER_TPU_NUM_PROCESSES=str(nproc),
               DLROVER_TPU_PROCESS_ID=str(pid),
               DLROVER_TPU_LOCAL_RANK=str(local_rank),
               DLROVER_TPU_NODE_NUM=str(hosts))
    if comm_perf:
        env["DLROVER_TPU_COMM_PERF"] = "1"
    try:
        out = subprocess.run([sys.executable, "-c", _PAYLOAD], env=env,
                             capture_output=True, timeout=timeout, text=True)
    except subprocess.TimeoutExpired:
        logger.error("node check payload timed out")
        return None
    result = None
    for line in out.stdout.splitlines():
        if line.startswith("COMM_PERF"):
            logger.info("comm perf: %s", line[len("COMM_PERF "):])
        if line.startswith("NODE_CHECK_DETAIL"):
            logger.info("node check payload: %s",
                        line[len("NODE_CHECK_DETAIL "):])
        if line.startswith("NODE_CHECK_RESULT"):
            result = float(line.split()[1])
    if result is not None and out.returncode == 0:
        return result
    logger.error("node check payload failed rc=%d stderr=%s",
                 out.returncode, out.stderr[-2000:])
    return None


def node_health_check(config, master_addr: str, client: MasterClient,
                      rounds: int = 2) -> bool:
    """Run ``rounds`` of the paired check; False when the master finds
    this node faulty.  With ``config.comm_perf_test`` the last round also
    sweeps the ``all_reduce`` sizes."""
    host = local_ip()
    comm_perf = bool(getattr(config, "comm_perf_test", False))
    for r in range(rounds):
        port = find_free_port()
        client.register_node(node_rank=config.node_rank, host=host,
                             agent_port=port, local_world_size=1,
                             slice_id=config.slice_id)
        client.join_rendezvous(config.node_rank, 1,
                               rdzv_name=RendezvousName.NETWORK_CHECK)
        world, coord, my_pid, nproc = {}, "", 0, 1
        deadline = time.time() + 120
        while time.time() < deadline:
            _, _, world, coord = client.get_comm_world(
                RendezvousName.NETWORK_CHECK)
            if world:
                break
            time.sleep(0.5)
        local_rank, hosts = 0, 1
        if world:
            nproc = len(world)
            me = next(meta for meta in world.values()
                      if meta["node_id"] == config.node_id)
            my_pid = next(int(rank) for rank, meta in world.items()
                          if meta["node_id"] == config.node_id)
            same_host = sorted(int(rank) for rank, meta in world.items()
                               if meta["host"] == me["host"])
            local_rank = same_host.index(my_pid)
            hosts = len({meta["host"] for meta in world.values()})
        elapsed = _run_check_payload(
            coord if nproc > 1 else "", nproc, my_pid,
            comm_perf=comm_perf and r == rounds - 1,
            local_rank=local_rank, hosts=hosts)
        succeeded = elapsed is not None
        client.report_network_check(succeeded, elapsed or 0.0, round_=r)
        logger.info("node check round %d: ok=%s elapsed=%s", r, succeeded,
                    elapsed)
        if r + 1 < rounds:
            time.sleep(1.0)  # standalone agents re-join for the next round
    # The verdict is final once the master holds every participant's
    # result of the last round.
    complete = False
    deadline = time.time() + 30.0
    while time.time() < deadline:
        _, _, complete = client.get_stragglers_full()
        if complete:
            break
        time.sleep(0.75)
    faults, reason = client.get_fault_nodes()
    stragglers, times = client.get_stragglers()
    logger.info("node check verdict: faults=%s (%s) stragglers=%s "
                "complete=%s times=%s", faults, reason, stragglers, complete,
                times)
    if config.node_id in faults:
        return False
    if config.node_id in stragglers:
        logger.warning("node %d flagged as straggler (times=%s)",
                       config.node_id, times)
    return True
