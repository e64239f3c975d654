"""The port's sharded gateway tier as one process a role on this host: a
``RegistryServer`` in the test process, two gateway processes (``python -m
dlrover_tpu_torch.serve_fleet --role gateway --registry ...``, g0 with
``--metrics_port 0``) and two tiny fp32 replica processes (``--device
cpu``) with journals.  The test submits 12 requests through a
``TierClient`` and SIGKILLs g1 by its pid once g1 has completed a request
and owns one that streams.  Then:

- every request ends ``done`` exactly once (one terminal answer each, a
  resubmit round answered from g0's dedupe cache), with ``resubmitted`` at
  least 1;
- the tokens are byte-equal to one port ``DecodeServer`` serving the same
  requests;
- g0's ``/metrics`` scrape parses, holds the ``serve_*`` and ``tier_*``
  gauges and shows one gateway once g1's lease has lapsed;
- ``TierActuator`` drains both replicas (each prints ``REPLICA_DONE`` and
  exits 0) and g0 ends with ``GATEWAY_DONE`` having imported no torch.

Every child runs in its own session with ``OMP_NUM_THREADS=1`` and is
killed by pid and reaped in a ``finally``; ports are bound as 0; nothing
waits on a fixed sleep.
"""

import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dlrover_tpu_torch import serve_fleet
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.serving import (
    RegistryServer,
    RpcKv,
    ServeRegistry,
    TierActuator,
    TierClient,
)

REPO = Path(__file__).resolve().parents[1]
JOB = "tierproc"
MNT = 16
LEASE = "2"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wait_log(path, pattern, procs, timeout=60.0):
    """The first match of ``pattern`` in the log ``path``; fails when a
    process of ``procs`` died or the time is up."""
    deadline = time.monotonic() + timeout
    while True:
        m = re.search(pattern, path.read_text())
        if m:
            return m
        dead = {n: p.returncode for n, p in procs.items()
                if p.poll() is not None}
        assert not dead and time.monotonic() < deadline, (
            f"waiting for {pattern!r} in {path.name}: dead {dead}; "
            f"{path.read_text()[-2000:]}")
        time.sleep(0.05)


def poll_until(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def scrape(port):
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=10).read().decode()
    out = {}
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            assert line.endswith(" gauge"), line
            continue
        name, val = line.split(" ")
        out[name] = float(val)
    return out


@pytest.fixture(scope="module")
def tier_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tierproc")
    args = serve_fleet.parse_args(["--device", "cpu"])
    prompts = serve_fleet.driver_prompts(args)
    reg = RegistryServer(0)
    addr = f"127.0.0.1:{reg.addr.rsplit(':', 1)[1]}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("DLROVER_TPU_FAULTS", None)
    procs, logs = {}, {}

    def spawn(name, *argv):
        logs[name] = tmp / f"{name}.log"
        with open(logs[name], "w") as out:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.serve_fleet",
                 "--registry", addr, "--job", JOB, "--lease_timeout", LEASE,
                 *argv], cwd=REPO, env=env, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True)
        assert os.getpgid(procs[name].pid) != os.getpgrp()

    res = {"prompts": prompts}
    client = actuator = None
    try:
        spawn("g0", "--role", "gateway", "--gateway_id", "g0",
              "--metrics_port", "0")
        spawn("g1", "--role", "gateway", "--gateway_id", "g1")
        for rid in ("r0", "r1"):
            spawn(rid, "--role", "replica", "--replica_id", rid, "--device",
                  "cpu", "--slots", "2", "--journal_dir", str(tmp / "j"),
                  "--round_floor_ms", "40")
        m = wait_log(logs["g0"], r"GATEWAY_READY port=\d+ id=g0 "
                     r"metrics=(\d+)", procs)
        res["metrics_port"] = int(m[1])
        wait_log(logs["g1"], r"GATEWAY_READY port=\d+ id=g1", procs)
        for rid in ("r0", "r1"):
            wait_log(logs[rid], "REPLICA_READY", procs, timeout=120)
        client = TierClient(ServeRegistry(RpcKv(addr), job=JOB,
                                          lease_s=float(LEASE)),
                            refresh_s=0.2)
        poll_until(lambda: len(client._set.refresh(force=True)) == 2,
                   "both gateways in the client's ring")
        owner = {f"req-{i}": client._set.owner(f"req-{i}")
                 for i in range(len(prompts))}
        res["owner"] = owner
        res["acks"] = {
            rid: client.submit(rid, prompts[i], MNT).status
            for i, rid in enumerate(owner)}
        done, first_seen = {}, {}
        killed = False
        deadline = time.monotonic() + 120
        while len(done) < len(prompts):
            g1_done = g1_streaming = False
            for rid in owner:
                if rid in done:
                    continue
                st = client.status(rid)
                if st.state in ("done", "failed", "timeout"):
                    done[rid] = st
                    first_seen[rid] = st.state
                    client._forget(rid)
                elif not killed and owner[rid] == "g1" and st.tokens:
                    g1_streaming = True
            g1_done = any(owner[r] == "g1" for r in done)
            if not killed and g1_done and g1_streaming:
                os.kill(procs["g1"].pid, signal.SIGKILL)
                procs["g1"].wait(timeout=30)
                res["done_at_kill"] = len(done)
                killed = True
            assert time.monotonic() < deadline, (
                f"{len(done)} of {len(prompts)} done; killed {killed}")
            time.sleep(0.01)
        res["killed"] = killed
        res["done"] = {r: (s.state, list(s.tokens)) for r, s in done.items()}
        res["resubmitted"] = client.resubmitted
        poll_until(lambda: "g1" not in client._set.refresh(force=True),
                   "g1 out of the client's ring")
        # Resubmit rounds: the ids whose terminal died with g1 are admitted
        # again at g0 and answered by the replicas' journals; after that
        # every id is answered from g0's dedupe cache.
        res["round1"] = {}
        for i, rid in enumerate(owner):
            ack = client.submit(rid, prompts[i], MNT)
            res["round1"][rid] = ack.status
            if ack.status != "done":
                reply = client.result(rid, timeout=60)
                assert reply.state == "done", (rid, reply)
        res["round2"] = {
            rid: client.submit(rid, prompts[i], MNT)
            for i, rid in enumerate(owner)}
        res["tier_gateways"] = poll_until(
            lambda: scrape(res["metrics_port"])[
                "dlrover_tpu_tier_gateways"] == 1.0 and
            scrape(res["metrics_port"]), "one gateway in g0's tier view")
        actuator = TierActuator(registry=ServeRegistry(
            RpcKv(addr), job=JOB, lease_s=float(LEASE)))
        res["stats"] = actuator.stats_snapshot()
        res["drained"] = [actuator.drain(r) for r in ("r0", "r1")]
        res["replica_done"] = {
            r: wait_log(logs[r], r"REPLICA_DONE id=\w+ served=(\d+) "
                        r"replayed=(\d+) rmsnorm_launches=(\d+)", {},
                        timeout=60)[0] for r in ("r0", "r1")}
        res["replica_rc"] = {r: procs[r].wait(timeout=60)
                             for r in ("r0", "r1")}
        procs["g0"].send_signal(signal.SIGTERM)
        res["gateway_done"] = wait_log(logs["g0"], r"GATEWAY_DONE (.*)",
                                       {}, timeout=30)[1]
        res["g0_rc"] = procs["g0"].wait(timeout=30)
        yield res
    finally:
        if client is not None:
            client.close()
        if actuator is not None:
            actuator.close()
        for p in procs.values():
            if p.poll() is None:
                os.kill(p.pid, signal.SIGKILL)
            p.wait(timeout=30)
        reg.stop()


def test_every_request_done_exactly_once_across_the_kill(tier_run):
    r = tier_run
    assert r["killed"] and r["resubmitted"] >= 1
    assert set(r["acks"].values()) == {"accepted"}
    assert len(r["done"]) == 12
    assert all(state == "done" for state, _ in r["done"].values())
    assert set(r["owner"].values()) == {"g0", "g1"}
    # The second round: every id answered done from g0's dedupe cache,
    # the same tokens.
    for rid, ack in r["round2"].items():
        assert ack.status == "done", (rid, ack)
        assert list(ack.tokens) == r["done"][rid][1]
    c = r["stats"]["counters"]
    assert c["failed"] == 0 and c["timeout"] == 0
    assert c["dedupe_hits"] >= 12


def test_tokens_equal_one_decode_server(tier_run):
    args = serve_fleet.parse_args(["--device", "cpu"])
    params, cfg = serve_fleet.build_model(args, args.seed)
    srv = tinfer.DecodeServer(params, cfg, slots=2, max_len=args.max_len,
                              prompt_buckets=(16, 32), seed=args.seed)
    outs = srv.serve(tier_run["prompts"], max_new_tokens=MNT)
    for i, (p, o) in enumerate(zip(tier_run["prompts"], outs)):
        want = np.asarray(o)[len(p):].tolist()
        assert tier_run["done"][f"req-{i}"][1] == want, i


def test_metrics_scrape_holds_serve_and_tier_gauges(tier_run):
    g = tier_run["tier_gateways"]
    for name in ("serve_completed", "serve_submitted", "serve_dedupe_hits",
                 "serve_queue_depth", "serve_ttft_p95_ms",
                 "serve_pool_unified_alive", "serve_spill_forwarded",
                 "tier_queue_depth", "tier_in_flight", "tier_replicas_alive",
                 "tier_gateways", "tier_occupancy", "tier_ttft_p95_ms"):
        assert f"dlrover_tpu_{name}" in g, name
    assert g["dlrover_tpu_tier_gateways"] == 1.0
    assert g["dlrover_tpu_tier_replicas_alive"] == 2.0


def test_drains_end_replicas_and_gateway_has_no_torch(tier_run):
    assert tier_run["drained"] == [True, True]
    assert tier_run["replica_rc"] == {"r0": 0, "r1": 0}
    served = sum(int(re.search(r"served=(\d+)", line)[1])
                 for line in tier_run["replica_done"].values())
    assert served >= 12
    done = tier_run["gateway_done"]
    assert '"torch_imported": false' in done and tier_run["g0_rc"] == 0
