"""One rank of a sharded job of the port, and the helper that starts a
world of them (``spawn_world``).  Used by ``tests/test_torch_fsdp.py``,
``tests/test_torch_ckpt_mesh.py`` (``gloo`` on the CPU) and the four-card
test of ``tests/test_torch_cuda.py`` (``nccl``).

A child reads a plan (JSON) and runs its jobs in order, each on a fresh
``accelerate`` job over the job's mesh, and writes, per job,
``<out>/<job>.rank<r>.json`` (losses, gradient norms, collective stats,
times, memory, CRCs) and, where asked, ``<out>/<job>.rank<r>.pt`` (this
rank's box of each parameter, with the box).  The plan::

    {"device": "cpu" | "cuda", "model": {LlamaConfig fields} | "800m",
     "params": path of an .npz of the flattened reference tree (or null:
     llama.init_params from seed 0), "batches": path of an .npz with
     "tokens" [steps, B, S + 1] (the global batches), "jobs": [...]}

A job: ``{"name", "kind": "train" | "restore", "mesh": {axis: size},
"param_specs": null | "planner", "remat", "grad_accum", "steps",
"boxes": bool, "save_dir": save after the last step, "load_dir":
restore from it first, "arena": the job whose shm arena the restore
may read (default: its own, so a restore reads storage), "target":
"state" | "params"}``; ``"time_device":
true`` in the plan records each step's collective time on the card.

Run as ``python tests/torch_mesh_child.py <plan.json> <out dir>`` under
the env contract (``DLROVER_TPU_COORDINATOR``, ...).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _unflatten(flat: dict) -> dict:
    """"a/b/0/c" keys -> the nested tree (digit keys become lists)."""
    root: dict = {}
    for key, v in flat.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def flatten(tree, prefix: str = "") -> dict:
    """The inverse of :func:`_unflatten` (numpy leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def crc(t) -> int:
    import torch

    return zlib.crc32(t.detach().cpu().contiguous().reshape(-1)
                      .view(torch.uint8).numpy().tobytes())


def _run(plan_path: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from dlrover_tpu_torch.checkpoint import tree_utils
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.common.device import process_device
    from dlrover_tpu_torch.common.shm import unlink_arena
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.models.convert import params_from_numpy
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.parallel import accelerate as acc
    from dlrover_tpu_torch.parallel import collectives
    from dlrover_tpu_torch.parallel.mesh import MeshSpec
    from dlrover_tpu_torch.parallel.sharding import placement_of
    from dlrover_tpu_torch.trainer import bootstrap

    plan = json.loads(Path(plan_path).read_text())
    collectives.TIME_DEVICE = bool(plan.get("time_device"))
    ctx = bootstrap.init(device=plan["device"])
    dev = process_device(plan["device"])
    rank = ctx.process_id
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if plan["model"] == "800m":
        cfg = llama.LlamaConfig.medium_800m()
    else:
        cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **plan["model"])
    tree = (_unflatten(dict(np.load(plan["params"])))
            if plan.get("params") else None)
    batches = np.load(plan["batches"])["tokens"]

    def init_fn(gen):
        if tree is None:
            return llama.init_params(cfg, gen, dev,
                                     param_dtype=torch.float32)
        return params_from_numpy(tree, cfg, device=dev,
                                 param_dtype=torch.float32)

    arenas = set()

    def engine(ckpt_dir, job):
        eng = CheckpointEngine(ckpt_dir, job_name=f"{job}-{os.getpid()}")
        arenas.add(eng.arena.name)
        return eng

    for job_plan in plan["jobs"]:
        name = job_plan["name"]
        A = int(job_plan.get("grad_accum", 1))
        remat = job_plan.get("remat", "none")
        lfn_cfg = cfg
        mesh = job_plan["mesh"]
        strategy = acc.Strategy(
            mesh=MeshSpec(**mesh) if job_plan.get("meshspec") else mesh,
            remat=remat, grad_accum=A)
        job = acc.accelerate(
            loss_fn=lambda p, b, c=lfn_cfg: llama.loss_fn(p, b, c),
            init_fn=init_fn, optimizer=adamw(float(plan.get("lr", 3e-4))),
            sample_batch={"tokens": batches[0]}, strategy=strategy,
            param_specs=job_plan.get("param_specs"), device=dev)
        share, shares = job.batch_rank
        per = batches.shape[1] // shares
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
        state = job.create_state(torch.Generator(device=dev).manual_seed(0))
        rec = {"rank": rank, "mesh": job.mesh.describe(),
               "batch_rank": [share, shares], "losses": [], "grad_norms": [],
               "step_ms": [], "comm": [], "device_comm_ms": [],
               "backend": None}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            rec["create_state_bytes"] = torch.cuda.memory_allocated() - m0
        leaves = acc.tree_leaves(state["params"])
        rec["param_box_bytes"] = sum(t.numel() * t.element_size()
                                     for t in leaves)
        rec["sharded_leaves"] = sum(1 for t in leaves
                                    if placement_of(t).sharded)
        rec["tp_leaves"] = sum(1 for t in leaves
                               if "tp" in placement_of(t).axes)
        target = state if job_plan.get("target", "state") == "state" else {
            "params": state["params"]}
        if job_plan.get("load_dir"):
            eng = engine(job_plan["load_dir"], job_plan.get("arena", name))
            got = eng.load(target, target_mesh=job.mesh)
            eng.close()
            rec["loaded_step"] = None if got is None else got[1]["step"]
            rec["restore_source"] = eng.last_restore_source
        for step in range(int(job_plan.get("steps", 0))):
            rows = batches[step][share * per:(share + 1) * per]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = job.train_step(state, {"tokens": rows})
            loss = float(m["loss"])
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(loss)
            rec["grad_norms"].append(float(m["grad_norm"]))
            rec["comm"].append(m.get("comm"))
            if collectives.TIME_DEVICE:
                rec["device_comm_ms"].append(collectives.take_device_ms())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        if job_plan.get("save_dir"):
            eng = engine(job_plan["save_dir"], name)
            eng.save_to_storage(int(state["step"]), state,
                                {"step": int(state["step"])})
            ok = eng.wait(120)
            rec["saved"] = bool(ok)
            rec["shard_bytes"] = eng.last_shard_bytes
            eng.close()
        whole = job.gather_state(state)
        if rank == 0:
            rec["crcs"] = {k: crc(v) for k, v in whole.items()}
        del whole
        if job_plan.get("boxes"):
            boxes = {}
            for leaf in tree_utils.state_leaves(state["params"]):
                pl = leaf.placement
                boxes[leaf.path] = (leaf.tensor.detach().cpu().clone(),
                                    [list(b) for b in pl.box()])
            torch.save(boxes, os.path.join(out_dir,
                                           f"{name}.rank{rank}.pt"))
        from dlrover_tpu_torch.common import dist_env

        rec["backend"] = dist_env.group_backend()
        rec["collectives_total"] = collectives.snapshot()
        Path(out_dir, f"{name}.rank{rank}.json").write_text(json.dumps(rec))
        del state, job
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for a in arenas:
        unlink_arena(a)
    sys.stdout.flush()
    os._exit(0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(world: int, plan: dict, work: Path, *,
                timeout: float = 120.0, script: Path = None) -> dict:
    """Run ``plan`` on ``world`` children (each in its own session,
    ``OMP_NUM_THREADS=1``, a deadline, reaped in a ``finally``); returns
    ``{job name: [rank records]}``.  A child drives card ``cuda:<rank>``
    (or card 0 when the ranks outnumber the cards).  A port taken between
    the probe and the rendezvous is retried once.  ``script`` is the
    child's file (default: this one); it takes ``<plan> <out dir>`` and
    writes ``<out dir>/<job>.rank<r>.json`` for each of the plan's
    jobs."""
    script = Path(script or __file__).resolve()
    work.mkdir(parents=True, exist_ok=True)
    plan_path = work / "plan.json"
    plan_path.write_text(json.dumps(plan))
    for attempt in (0, 1):
        port = free_port()
        procs, logs = [], []
        try:
            for r in range(world):
                env = dict(os.environ, OMP_NUM_THREADS="1",
                           DLROVER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                           DLROVER_TPU_NUM_PROCESSES=str(world),
                           DLROVER_TPU_PROCESS_ID=str(r),
                           DLROVER_TPU_LOCAL_RANK=str(r),
                           DLROVER_TPU_DIST_TIMEOUT_S=str(int(timeout)),
                           DLROVER_TPU_LOG_LEVEL="WARNING",
                           PYTHONPATH=str(REPO))
                for var in ("DLROVER_TPU_MASTER_ADDR", "DLROVER_TPU_FAULTS",
                            "DLROVER_TPU_RUN_ID", "XLA_FLAGS"):
                    env.pop(var, None)
                log = open(work / f"child{r}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, str(script),
                     str(plan_path), str(work)], cwd=REPO, env=env,
                    stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        if attempt == 0 and any("ddress already in use" in t
                                for t in texts):
            continue
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r} rc {p.returncode}:\n" \
                                      f"{texts[r][-4000:]}"
        return {j["name"]: [json.loads((work / f"{j['name']}.rank{r}.json")
                                       .read_text()) for r in range(world)]
                for j in plan["jobs"]}
    raise AssertionError("no free port")


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2])
