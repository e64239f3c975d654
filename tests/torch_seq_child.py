"""One rank of the port's sequence-parallel and strategy-search jobs, run by
``torch_mesh_child.spawn_world(..., script=<this file>)``.  Used by
``tests/test_torch_seq.py``, ``tests/test_torch_seq_train.py``,
``tests/test_torch_strategy_search.py`` (``gloo`` on the CPU) and the
four-card sequence test of ``tests/test_torch_cuda.py`` (``nccl``).

The plan (JSON)::

    {"device": "cpu" | "cuda", "model": {LlamaConfig.tiny fields} |
     "800m", "params": .npz of the flattened reference tree or null,
     "jobs": [...]}

Jobs, each writing ``<out>/<name>.rank<r>.json`` (and, for ``attn`` and
``loss``, ``<out>/<name>.rank<r>.npz``):

- ``attn``: ``{"mesh", "impl": "ring" | "ulysses", "causal", "dtype",
  "inputs": .npz of q, k, v, ct [B, S, H, D]}``; this rank's blocks
  (its batch share over ``dp``, its block of ``S`` over ``tp``) through
  the attention, then ``sum(out * ct)`` backward: ``out``, ``dq``, ``dk``,
  ``dv`` of the blocks (fp32) and the collectives' record;
- ``loss``: ``{"mesh", "impl", "batches": .npz tokens [1, B, S + 1]}``:
  ``llama.loss_fn(attn_impl=impl, mesh=...)`` on this rank's batch share
  and its gradient of every parameter;
- ``train``: ``{"mesh", "impl", "steps", "lr", "batches", "remat_block",
  "batch_axes": [[batch axes], seq axis]}``: ``accelerate`` with that
  ``batch_axes`` for ``steps`` steps on ``batches`` (a batch a step);
  losses, gradient norms, step ms, collectives and peak memory;
- ``search``: ``{"batches", "cache_dir", "master": addr or null}``:
  ``accelerate(strategy="auto", cache=<json>)`` twice (the second a hit),
  ``accelerate(strategy="bo", profile_steps=1, search_evals=3)``, and,
  with a master, ``"auto"`` over ``MasterStrategyCache``;
- ``cost``: ``{"batches", "candidates": [{"mesh", "remat", "grad_accum",
  "param_specs"}]}``: each candidate's ``step_cost`` bytes and the
  collectives' record of one real step;
- ``refusals``: ``{"mesh", "batches"}``: a ring loss and its job set up
  to agree and to disagree on whether ``tp`` cuts the sequence (see
  :func:`_refusals`); each case's first step's loss, or its error.

Run under the env contract (``DLROVER_TPU_COORDINATOR``, ...).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_child as mesh_child  # noqa: E402


def _tree_np(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return tree.detach().float().cpu().numpy() if torch.is_tensor(tree) \
        else tree


def _run(plan_path: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from dlrover_tpu_torch.common import dist_env
    from dlrover_tpu_torch.common.device import process_device
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.models.convert import params_from_numpy
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.parallel import accelerate as acc
    from dlrover_tpu_torch.parallel import collectives
    from dlrover_tpu_torch.parallel.mesh import MeshSpec
    from dlrover_tpu_torch.parallel.ring_attention import ring_attention
    from dlrover_tpu_torch.parallel.sequence import ulysses_attention
    from dlrover_tpu_torch.parallel.sharding import PartitionSpec, tree_map
    from dlrover_tpu_torch.trainer import bootstrap

    plan = json.loads(Path(plan_path).read_text())
    ctx = bootstrap.init(device=plan["device"])
    dev = process_device(plan["device"])
    rank = ctx.process_id
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    if plan.get("model") == "800m":
        cfg = llama.LlamaConfig.medium_800m()
    elif plan.get("model") is not None:
        cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **plan["model"])
    tree = (mesh_child._unflatten(dict(np.load(plan["params"])))
            if plan.get("params") else None)

    def init_fn(gen, c=None):
        c = c or cfg
        if tree is None:
            return llama.init_params(c, gen, dev, param_dtype=torch.float32)
        return params_from_numpy(tree, c, device=dev,
                                 param_dtype=torch.float32)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def write(name, rec, arrays=None):
        rec = dict(rec, rank=rank, backend=dist_env.group_backend())
        if arrays is not None:
            np.savez(Path(out_dir, f"{name}.rank{rank}.npz"), **arrays)
        Path(out_dir, f"{name}.rank{rank}.json").write_text(json.dumps(rec))

    for job in plan["jobs"]:
        name, kind = job["name"], job["kind"]
        # A loss that cuts the sequence takes its job's mesh, whose
        # sequence axis is tp; the attention blocks take any mesh.
        seq = {"loss": "tp", "train": (job.get("batch_axes") or
                                       [None, None])[1]}.get(kind)
        mesh = acc.mesh_for(MeshSpec(**job["mesh"]), seq_axis=seq) \
            if "mesh" in job else None
        if kind == "attn":
            data = np.load(job["inputs"])
            dt = getattr(torch, job.get("dtype", "float32"))
            dp, idp = mesh.axis_size("dp"), mesh.coords["dp"]
            n, i = mesh.axis_size("tp"), mesh.coords["tp"]
            B, S = data["q"].shape[:2]
            rows = slice(idp * B // dp, (idp + 1) * B // dp)
            cols = slice(i * S // n, (i + 1) * S // n)
            q, k, v, ct = (torch.from_numpy(np.ascontiguousarray(
                data[x][rows, cols])).to(dev).to(dt)
                for x in ("q", "k", "v", "ct"))
            for t in (q, k, v):
                t.requires_grad_(True)
            before = collectives.snapshot()
            fn = ring_attention if job["impl"] == "ring" \
                else ulysses_attention
            out = fn(q, k, v, mesh, causal=job["causal"])
            (out.float() * ct.float()).sum().backward()
            write(name, {"comm": collectives.stats_delta(before)},
                  {"out": out.detach().float().cpu().numpy(),
                   "dq": q.grad.float().cpu().numpy(),
                   "dk": k.grad.float().cpu().numpy(),
                   "dv": v.grad.float().cpu().numpy()})
        elif kind == "loss":
            tokens = np.load(job["batches"])["tokens"][0]
            share, shares = mesh.coords["dp"], mesh.axis_size("dp")
            per = tokens.shape[0] // shares
            batch = {"tokens": torch.from_numpy(
                tokens[share * per:(share + 1) * per]).to(dev)}
            params = init_fn(None)
            for t in acc.tree_leaves(params):
                t.requires_grad_(True)
            loss = llama.loss_fn(params, batch, cfg, attn_impl=job["impl"],
                                 mesh=mesh)
            loss.backward()
            grads = mesh_child.flatten(_tree_np(
                tree_map(lambda t: t.grad, params)))
            write(name, {"loss": float(loss)}, grads)
        elif kind == "train":
            tokens = np.load(job["batches"])["tokens"]
            c = cfg
            if job.get("remat_block"):
                import dataclasses

                c = dataclasses.replace(cfg, remat_block=True)
            ba = job.get("batch_axes")
            batch_axes = None if ba is None else PartitionSpec(
                tuple(ba[0]) or None, ba[1])
            impl = job.get("impl", "auto")
            job_ = acc.accelerate(
                loss_fn=lambda p, b, c=c, m=mesh, a=impl: llama.loss_fn(
                    p, b, c, attn_impl=a, mesh=m),
                init_fn=lambda g, c=c: init_fn(g, c),
                optimizer=adamw(float(job.get("lr", 3e-4))),
                sample_batch={"tokens": tokens[0]},
                strategy=acc.Strategy(mesh=MeshSpec(**job["mesh"])),
                batch_axes=batch_axes, device=dev)
            share, shares = job_.batch_rank
            per = tokens.shape[1] // shares
            if cuda:
                sync()
                torch.cuda.reset_peak_memory_stats()
            state = job_.create_state(
                torch.Generator(device=dev).manual_seed(0))
            rec = {"mesh": job_.mesh.describe(), "seq_axis": job_.seq_axis,
                   "batch_rank": [share, shares], "losses": [],
                   "grad_norms": [], "step_ms": [], "comm": []}
            collectives.TIME_DEVICE = cuda
            for step in range(int(job["steps"])):
                rows = tokens[step % len(tokens)][share * per:
                                                  (share + 1) * per]
                sync()
                t0 = time.perf_counter()
                state, m = job_.train_step(state, {"tokens": rows})
                loss = float(m["loss"])
                sync()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["losses"].append(loss)
                rec["grad_norms"].append(float(m["grad_norm"]))
                rec["comm"].append(m.get("comm"))
                if cuda:
                    rec.setdefault("device_comm_ms", []).append(
                        collectives.take_device_ms())
            if cuda:
                rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            write(name, rec)
            del state, job_
            if cuda:
                torch.cuda.empty_cache()
        elif kind == "search":
            write(name, _search(job, cfg, init_fn, dev, rank))
        elif kind == "cost":
            write(name, _cost(job, cfg, init_fn, dev))
        elif kind == "refusals":
            write(name, _refusals(job, cfg, init_fn, dev))
    sys.stdout.flush()
    os._exit(0)


def _search(job, cfg, init_fn, dev, rank) -> dict:
    import torch

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.parallel import accelerate as acc
    from dlrover_tpu_torch.parallel.strategy_search import \
        MasterStrategyCache

    tokens = np.load(job["batches"])["tokens"][0]
    kw = dict(loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
              init_fn=init_fn, optimizer=adamw(3e-4),
              sample_batch={"tokens": tokens}, device=dev)
    cache = os.path.join(job["cache_dir"], "strategies.json")
    out = {}
    for run, extra in (("auto", dict(strategy="auto", cache=cache)),
                       ("auto_hit", dict(strategy="auto", cache=cache)),
                       ("bo", dict(strategy="bo", profile_steps=1,
                                   search_evals=3, grad_accum=1))):
        b0 = acc.COUNTS["builds"]
        j = acc.accelerate(**kw, **extra)
        st = j.create_state(torch.Generator(device=dev).manual_seed(0))
        share, shares = j.batch_rank
        per = tokens.shape[0] // shares
        _, m = j.train_step(st, {"tokens": tokens[share * per:
                                                  (share + 1) * per]})
        out[run] = {"builds": acc.COUNTS["builds"] - b0,
                    "winner": j.strategy.describe(),
                    "mesh": j.mesh.describe(), "search": j.search,
                    "loss": float(m["loss"])}
    if job.get("master"):
        client = MasterClient(job["master"], rank)
        try:
            b0 = acc.COUNTS["builds"]
            j = acc.accelerate(**kw, strategy="auto",
                               cache=MasterStrategyCache(client))
            out["master"] = {"builds": acc.COUNTS["builds"] - b0,
                             "winner": j.strategy.describe(),
                             "search": j.search}
            b0 = acc.COUNTS["builds"]
            j = acc.accelerate(**kw, strategy="auto",
                               cache=MasterStrategyCache(client))
            out["master_hit"] = {"builds": acc.COUNTS["builds"] - b0,
                                 "winner": j.strategy.describe(),
                                 "search": j.search}
        finally:
            client.close()
    return out


def _cost(job, cfg, init_fn, dev) -> dict:
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.parallel import accelerate as acc
    from dlrover_tpu_torch.parallel import collectives
    from dlrover_tpu_torch.parallel.mesh import MeshSpec

    tokens = np.load(job["batches"])["tokens"][0]
    out = []
    for c in job["candidates"]:
        j = acc.aot_analyze(
            loss_fn=lambda p, b: llama.loss_fn(p, b, cfg), init_fn=init_fn,
            optimizer=adamw(3e-4), sample_batch={"tokens": tokens},
            strategy=acc.Strategy(mesh=MeshSpec(**c["mesh"]),
                                  remat=c.get("remat", "none"),
                                  grad_accum=c.get("grad_accum", 1)),
            param_specs=c.get("param_specs"), device=dev)
        st = j.create_state(torch.Generator(device=dev).manual_seed(0))
        share, shares = j.batch_rank
        per = tokens.shape[0] // shares
        before = collectives.snapshot()
        j.train_step(st, {"tokens": tokens[share * per:(share + 1) * per]})
        got = collectives.stats_delta(before)
        out.append({"strategy": j.strategy.describe(),
                    "cost": j.cost["comm"],
                    "recorded": {k: got[k]["bytes"] for k in j.cost["comm"]},
                    "calls": {k: got[k]["calls"] for k in got}})
    return {"candidates": out}


def _refusals(job, cfg, init_fn, dev) -> dict:
    """``{case: {"loss", "mesh", "seq_axis"} | {"error", "msg"}}``: one
    ``accelerate`` build and step a case.  The loss's mesh is ``job``'s
    mesh without a sequence axis (``plain``) or with ``tp`` as one
    (``seq``); the job is built without the sequence axis, with it, or by
    the search (``"auto"``, timed or by the cost model, whose candidates
    are not sequence-parallel unless ``batch_axes`` says so)."""
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.parallel import accelerate as acc
    from dlrover_tpu_torch.parallel.mesh import MeshSpec
    from dlrover_tpu_torch.parallel.sharding import PartitionSpec

    tokens = np.load(job["batches"])["tokens"][0]
    spec = MeshSpec(**job["mesh"])
    plain, seq = acc.mesh_for(spec), acc.mesh_for(spec, seq_axis="tp")

    def ring(mesh):
        return lambda p, b: llama.loss_fn(p, b, cfg, attn_impl="ring",
                                          mesh=mesh)

    cases = {
        "no_seq_rule": dict(loss_fn=ring(plain),
                            strategy=acc.Strategy(mesh=spec)),
        "seq_mesh_on_plain_job": dict(loss_fn=ring(seq),
                                      strategy=acc.Strategy(mesh=spec)),
        "whole_sequence_on_seq_job": dict(
            loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
            strategy=acc.Strategy(mesh=spec, rules={"seq": "tp"})),
        "auto_timed": dict(loss_fn=ring(seq), strategy="auto",
                           profile_steps=1),
        "auto_cost": dict(loss_fn=ring(seq), strategy="auto"),
        "seq_job": dict(loss_fn=ring(seq), strategy=acc.Strategy(
            mesh=spec, rules={"seq": "tp"})),
        "auto_builder": dict(
            loss_fn=ring(seq), strategy="auto",
            loss_fn_builder=lambda s: ring(acc.mesh_for(s.mesh,
                                                        seq_axis="tp")),
            batch_axes=PartitionSpec(("dp", "fsdp"), "tp")),
    }
    out = {}
    for case, kw in cases.items():
        try:
            j = acc.accelerate(init_fn=init_fn, optimizer=adamw(3e-4),
                               sample_batch={"tokens": tokens}, device=dev,
                               **kw)
            st = j.create_state(torch.Generator(device=dev).manual_seed(0))
            share, shares = j.batch_rank
            per = tokens.shape[0] // shares
            _, m = j.train_step(st, {"tokens": tokens[share * per:
                                                      (share + 1) * per]})
            out[case] = {"loss": float(m["loss"]),
                         "mesh": j.mesh.describe(), "seq_axis": j.seq_axis}
        except ValueError as e:
            out[case] = {"error": type(e).__name__, "msg": str(e)}
    return out


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2])
