"""Training entry point: Llama pretraining, one card a process.

The port's counterpart of ``examples/llama_train.py`` with its own copy of
``synth_tokens``, its flags and defaults (the LoRA settings only as far as
the refusals below need them) and ``--device``:

    python -m dlrover_tpu_torch.train --model 800m --seq_len 2048 --steps 5
    python -m dlrover_tpu_torch.train --model tiny --steps 20 --device cpu
    python -m dlrover_tpu_torch.train --model tiny --device cpu \
        --ckpt_dir /tmp/ckpt --ckpt_interval 5

It builds ``llama.loss_fn`` over fp32 master parameters (random, seed 0;
``--n_layer N`` keeps the width and cuts the depth to N blocks),
trains with ``adamw(lr)`` through ``accelerate()`` on the example's
synthetic tokens drawn by an ``ElasticSampler`` (seed 17), prints the loss
and the gradient norm (both in full) every ``--log_every`` steps and a
final ``TRAIN_DONE`` line with the loss, the median step time, tokens/s
and each kernel's launch count (0 on the CPU, where the plain versions
run).

With ``--ckpt_dir`` it checkpoints as the example does
(``examples/llama_train.py:210-259``): at start it restores the newest
state, from the shm arena left by an earlier run on this host, else from
storage, and prints ``[worker 0] restored step=N``; every
``--ckpt_interval`` steps it stages the state (and the sampler's position)
into the arena; at the end it saves to storage and waits for the commit.
Run alone, the arena is namespaced by the checkpoint directory (as
``dlrover_tpu/trainer/trainer.py:314-321`` does), so two jobs on one host
never share one; under the launcher (``python -m dlrover_tpu_torch.run``),
by the job's name and the launch's run id, as the agent's saver names
it.  ``TRAIN_DONE`` then also gives ``restored_step`` and the last save's
stall, and a ``CKPT_STATS`` line the last save's, persist's and
restore's costs as JSON.

Several processes on one host run it unchanged, each started with the
agent's env contract (``DLROVER_TPU_COORDINATOR=host:port``,
``DLROVER_TPU_NUM_PROCESSES=N``, ``DLROVER_TPU_PROCESS_ID=i``,
``DLROVER_TPU_LOCAL_RANK=i``): ``trainer/bootstrap.init`` brings up
``torch.distributed``, each process draws its ``--batch_per_proc`` rows of
the global batch and trains data-parallel (``Strategy(mesh={"dp": N})``,
the example's ``MeshSpec(dp=len(jax.devices()))`` with one device a
process), every process prints its ``[worker i]`` lines (after the last
step, before the final save: ``[worker i] trained step=N loss=...``, with
the restore's source and time and its kernel launches) and, as the
example does, its ``TRAIN_DONE`` line, with the global loss, ``dp`` and the
backend (with ``reduce_ms``, the median host time of the gradient
reduction, when it goes through the host).  The checkpoint is sliced
across the ranks.

``--strategy auto`` lets ``accelerate(strategy="auto")`` choose the mesh
by its cost model, as the example does (``examples/llama_train.py:103-108,
170-176``); each process then reads the rows of its share over the
winner's batch axes (``global batch / shares`` of them).

Refused, each with the slice that brings it: ``--fp8``, ``--quant_grads``,
``--lora_rank > 0``, ``--init_from`` and a ``--ckpt_dir`` on an object
store (``gs://``, ``s3://``).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common.constants import (
    MODEL_ITEM,
    OBJECT_STORE_ITEM,
    QUANT_OFFLOAD_ITEM,
)
from dlrover_tpu_torch.common.device import process_device
from dlrover_tpu_torch.common.env import NodeEnv
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.cross_entropy import xent_fwd
from dlrover_tpu_torch.ops.flash_attention import flash_dkv, flash_dq, \
    flash_fwd
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate
from dlrover_tpu_torch.trainer import bootstrap
from dlrover_tpu_torch.trainer.sampler import ElasticSampler

#: The kernel wrappers whose launches the run reports, by name.
KERNELS = {
    "flash_fwd": flash_fwd,
    "flash_dq": flash_dq,
    "flash_dkv": flash_dkv,
    "xent_fwd": xent_fwd,
    "rmsnorm": rmsnorm,
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--model", default="tiny",
                   choices=["tiny", "300m", "800m"])
    p.add_argument("--batch_per_proc", type=int, default=4)
    p.add_argument("--seq_len", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--strategy", default="dp", choices=["dp", "auto"])
    p.add_argument("--n_layer", type=int, default=0,
                   help="cut the model to N blocks of the same width "
                        "(0: its own depth)")
    p.add_argument("--remat_block", action="store_true")
    p.add_argument("--fp8", action="store_true")
    p.add_argument("--quant_grads", action="store_true")
    p.add_argument("--lora_rank", type=int, default=0)
    p.add_argument("--init_from", default="")
    p.add_argument("--dataset_size", type=int, default=4096)
    p.add_argument("--ckpt_dir", default="")
    p.add_argument("--ckpt_interval", type=int, default=5)
    p.add_argument("--log_every", type=int, default=10,
                   help="print the loss and gradient norm every N steps "
                        "(and after the last)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the kernels) or cpu (plain versions)")
    return p.parse_args(argv)


def refuse_later_options(args: argparse.Namespace) -> None:
    refused = [
        (args.fp8, "--fp8", MODEL_ITEM),
        (args.quant_grads, "--quant_grads", QUANT_OFFLOAD_ITEM),
        (args.lora_rank > 0, "--lora_rank > 0 (LoRA)", MODEL_ITEM),
        (bool(args.init_from), "--init_from (checkpoint import)",
         MODEL_ITEM),
        ("://" in args.ckpt_dir, "--ckpt_dir on an object store",
         OBJECT_STORE_ITEM),
    ]
    for on, what, where in refused:
        if on:
            raise NotImplementedError(f"{what} comes with {where}")


def build_config(args: argparse.Namespace) -> llama.LlamaConfig:
    if args.model == "300m":
        cfg = llama.LlamaConfig.small_300m()
    elif args.model == "800m":
        cfg = llama.LlamaConfig.medium_800m()
    else:
        cfg = llama.LlamaConfig.tiny(max_seq_len=args.seq_len)
    if args.n_layer < 0:
        raise ValueError(f"--n_layer must be >= 0, got {args.n_layer}")
    return dataclasses.replace(cfg, remat_block=args.remat_block,
                               n_layer=args.n_layer or cfg.n_layer)


def synth_tokens(indices, seq_len: int, vocab: int) -> np.ndarray:
    """The example's synthetic rows: one fixed random row shifted by each
    index, ``[len(indices), seq_len + 1]`` int32."""
    base = np.random.RandomState(0).randint(0, vocab, size=(seq_len + 1,))
    return np.stack(
        [(base + i) % vocab for i in indices], axis=0
    ).astype("int32")


def build(args: argparse.Namespace, num_processes: int = 1):
    """``(cfg, job, state)`` for the run ``args`` describe: data-parallel
    over ``num_processes`` (the group's world), or on the mesh
    ``--strategy auto`` chose."""
    dev = process_device(args.device)
    cfg = build_config(args)
    global_batch = args.batch_per_proc * num_processes
    sample = synth_tokens(range(global_batch), args.seq_len, cfg.vocab_size)
    job = accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        init_fn=lambda g: llama.init_params(cfg, g, dev,
                                            param_dtype=torch.float32),
        optimizer=adamw(args.lr),
        sample_batch={"tokens": sample},
        strategy=("auto" if args.strategy == "auto"
                  else Strategy(mesh={"dp": num_processes})),
        param_specs="planner",
        device=dev,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, job, job.create_state(gen)


def emit(line: str) -> None:
    """Print ``line`` in one write: the workers of an agent share its
    stdout, and under ``python -u`` a ``print`` writes its text and its
    newline apart, so another process's line could land between them."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def ckpt_job_name(ckpt_dir: str) -> str:
    """The job name that namespaces the shm arena of ``ckpt_dir`` for a
    trainer that runs alone."""
    return "t" + hashlib.sha1(
        os.path.abspath(ckpt_dir).encode()).hexdigest()[:10]


def checkpoint_job_name(ctx, ckpt_dir: str) -> str:
    """The checkpoint's job name: the job's own under a launcher
    (``DLROVER_TPU_JOB_NAME`` set), as ``examples/llama_train.py:214``
    names it, so that the engine finds the agent's saver and its arenas;
    :func:`ckpt_job_name` of the directory when the trainer runs alone."""
    if os.environ.get(NodeEnv.JOB_NAME):
        return ctx.job_name
    return ckpt_job_name(ckpt_dir)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    refuse_later_options(args)
    if args.ckpt_interval < 1:
        raise ValueError(f"--ckpt_interval must be >= 1, got "
                         f"{args.ckpt_interval}")
    ctx = bootstrap.init(device=args.device)
    t_build = time.perf_counter()
    cfg, job, state = build(args, ctx.num_processes)
    logger.info("built the model and optimizer in %.3fs",
                time.perf_counter() - t_build)
    # This rank's share of each global batch: its index over the job's
    # batch axes (its process id under the default dp mesh).
    share, shares = job.batch_rank
    sampler = ElasticSampler(
        args.dataset_size,
        batch_size_per_process=args.batch_per_proc * ctx.num_processes
        // shares,
        num_processes=shares,
        process_id=share,
        seed=17,
    )
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        from dlrover_tpu_torch.checkpoint.checkpointer import \
            FlashCheckpointer

        ckpt = FlashCheckpointer(args.ckpt_dir,
                                 job_name=checkpoint_job_name(ctx,
                                                              args.ckpt_dir))
        restored = ckpt.load(target=state)
        if restored is not None:
            state, meta = restored
            start_step = int(meta.get("step", 0))
            emit(f"[worker {ctx.process_id}] restored step={start_step}")
            sampler.load_state_dict(
                meta.get("sampler", {"completed_steps": start_step}))

    def save(storage: bool) -> None:
        ckpt.save(state, meta={"step": step,
                               "sampler": sampler.state_dict()},
                  storage=storage)

    on_card = job.device.type == "cuda"
    launches0 = {n: fn.launches for n, fn in KERNELS.items()}
    step, loss, first_loss = start_step, float("nan"), float("nan")
    step_s, reduce_ms = [], []
    it = iter(sampler)
    while step < args.steps:
        try:
            indices = next(it)
        except StopIteration:
            it = iter(sampler)
            continue
        toks = synth_tokens(indices, args.seq_len, cfg.vocab_size)
        t0 = time.perf_counter()
        state, metrics = job.train_step(state, {"tokens": toks})
        loss = float(metrics["loss"])
        if "reduce_ms" in metrics:
            reduce_ms.append(metrics["reduce_ms"])
        if on_card:
            torch.cuda.synchronize(job.device)
        step_s.append(time.perf_counter() - t0)
        step += 1
        if len(step_s) == 1:
            first_loss = loss
        ctx.report_step(step)
        if ckpt is not None and step % args.ckpt_interval == 0:
            save(storage=False)
            emit(f"[worker {ctx.process_id}] saved step={step} to memory "
                 f"(stall {ckpt.engine.last_stall_ms:.1f} ms)")
        if step % args.log_every == 0 or step == args.steps:
            emit(f"[worker {ctx.process_id}] step {step} loss={loss!r} "
                 f"grad_norm={float(metrics['grad_norm'])!r}")
    launches = " ".join(f"{n}_launches={fn.launches - launches0[n]}"
                        for n, fn in KERNELS.items())
    restored = "" if ckpt is None else (
        f" restored_from={ckpt.engine.last_restore_source} "
        f"restore_ms={ckpt.engine.last_restore_ms:.1f}")
    emit(f"[worker {ctx.process_id}] trained step={step} loss={loss!r}"
         f"{restored} {launches}")
    ckpt_done = ""
    if ckpt is not None:
        save(storage=True)
        committed = ckpt.wait()
        stats = ckpt.engine.stats()
        ckpt.close()
        if not committed:
            raise RuntimeError(f"checkpoint of step {step} to "
                               f"{args.ckpt_dir} was not committed")
        emit("CKPT_STATS " + json.dumps(stats))
        ckpt_done = (f" restored_step={start_step} "
                     f"ckpt_stall_ms={stats['stall_ms']:.3f}")
    # The first step carries one-time set-up (allocator, library handles).
    steady = step_s[1:] or step_s
    step_ms = 1e3 * statistics.median(steady) if steady else float("nan")
    tokens = args.batch_per_proc * ctx.num_processes * args.seq_len
    dp = f" dp={job.dp} backend={dist_env.group_backend()}"
    if reduce_ms:
        dp += f" reduce_ms={statistics.median(reduce_ms):.3f}"
    dp += f" mesh={job.mesh.describe()}"
    # Losses in full (repr): a restored run is held to bit-equality.
    emit(f"TRAIN_DONE step={step} loss={loss!r} "
         f"first_loss={first_loss!r} step_ms={step_ms:.3f} "
         f"tokens_per_s={1e3 * tokens / step_ms:.1f} device={job.device} "
         f"{launches}{ckpt_done}{dp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
