"""Training entry point: Llama pretraining on one card.

The port's counterpart of ``examples/llama_train.py`` with its own copy of
``synth_tokens``, its flags and defaults (the LoRA settings only as far as
the refusals below need them) and ``--device``:

    python -m dlrover_tpu_torch.train --model 800m --seq_len 2048 --steps 5
    python -m dlrover_tpu_torch.train --model tiny --steps 20 --device cpu
    python -m dlrover_tpu_torch.train --model tiny --device cpu \
        --ckpt_dir /tmp/ckpt --ckpt_interval 5

It builds ``llama.loss_fn`` over fp32 master parameters (random, seed 0),
trains with ``adamw(lr)`` through ``accelerate()`` on the example's
synthetic tokens drawn by an ``ElasticSampler`` (seed 17), prints the loss
every 10 steps and a final ``TRAIN_DONE`` line with the loss, the median
step time, tokens/s and each kernel's launch count (0 on the CPU, where
the plain versions run).

With ``--ckpt_dir`` it checkpoints as the example does
(``examples/llama_train.py:210-259``): at start it restores the newest
state, from the shm arena left by an earlier run on this host, else from
storage, and prints ``[worker 0] restored step=N``; every
``--ckpt_interval`` steps it stages the state (and the sampler's position)
into the arena; at the end it saves to storage and waits for the commit.
The arena is namespaced by the checkpoint directory (as
``dlrover_tpu/trainer/trainer.py:314-321`` does), so two jobs on one host
never share one.  ``TRAIN_DONE`` then also gives ``restored_step`` and the
last save's stall, and a ``CKPT_STATS`` line the last save's, persist's and
restore's costs as JSON.

Refused, each with the slice that brings it: ``--strategy auto``,
``--fp8``, ``--quant_grads``, ``--lora_rank > 0``, ``--init_from`` and a
``--ckpt_dir`` on an object store (``gs://``, ``s3://``).
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

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.storage import OBJECT_STORE_SLICE
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.cross_entropy import xent_fwd
from dlrover_tpu_torch.ops.flash_attention import flash_dkv, flash_dq, \
    flash_fwd
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.parallel.accelerate import (
    LATER_SLICE,
    MULTICARD_SLICE,
    Strategy,
    accelerate,
)
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
    p.add_argument("--remat_block", action="store_true")
    p.add_argument("--fp8", action="store_true")
    p.add_argument("--quant_grads", action="store_true")
    p.add_argument("--lora_rank", type=int, default=0)
    p.add_argument("--init_from", default="")
    p.add_argument("--dataset_size", type=int, default=4096)
    p.add_argument("--ckpt_dir", default="")
    p.add_argument("--ckpt_interval", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the kernels) or cpu (plain versions)")
    return p.parse_args(argv)


def refuse_later_options(args: argparse.Namespace) -> None:
    refused = [
        (args.strategy == "auto", "--strategy auto (the strategy search)",
         MULTICARD_SLICE),
        (args.fp8, "--fp8", LATER_SLICE),
        (args.quant_grads, "--quant_grads", MULTICARD_SLICE),
        (args.lora_rank > 0, "--lora_rank > 0 (LoRA)", LATER_SLICE),
        (bool(args.init_from), "--init_from (checkpoint import)",
         LATER_SLICE),
        ("://" in args.ckpt_dir, "--ckpt_dir on an object store",
         OBJECT_STORE_SLICE),
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
    return dataclasses.replace(cfg, remat_block=args.remat_block)


def synth_tokens(indices, seq_len: int, vocab: int) -> np.ndarray:
    """The example's synthetic rows: one fixed random row shifted by each
    index, ``[len(indices), seq_len + 1]`` int32."""
    base = np.random.RandomState(0).randint(0, vocab, size=(seq_len + 1,))
    return np.stack(
        [(base + i) % vocab for i in indices], axis=0
    ).astype("int32")


def build(args: argparse.Namespace, num_processes: int = 1):
    """``(cfg, job, state)`` for the run ``args`` describe."""
    dev = resolve_device(args.device)
    cfg = build_config(args)
    global_batch = args.batch_per_proc * num_processes
    sample = synth_tokens(range(global_batch), args.seq_len, cfg.vocab_size)
    job = accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        init_fn=lambda g: llama.init_params(cfg, g, dev,
                                            param_dtype=torch.float32),
        optimizer=adamw(args.lr),
        sample_batch={"tokens": sample},
        strategy=Strategy(),
        param_specs="planner",
        device=dev,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, job, job.create_state(gen)


def ckpt_job_name(ckpt_dir: str) -> str:
    """The job name that namespaces the shm arena of ``ckpt_dir``."""
    return "t" + hashlib.sha1(
        os.path.abspath(ckpt_dir).encode()).hexdigest()[:10]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    refuse_later_options(args)
    if args.ckpt_interval < 1:
        raise ValueError(f"--ckpt_interval must be >= 1, got "
                         f"{args.ckpt_interval}")
    ctx = bootstrap.init()
    cfg, job, state = build(args, ctx.num_processes)
    sampler = ElasticSampler(
        args.dataset_size,
        batch_size_per_process=args.batch_per_proc,
        num_processes=ctx.num_processes,
        process_id=ctx.process_id,
        seed=17,
    )
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        from dlrover_tpu_torch.checkpoint.checkpointer import \
            FlashCheckpointer

        ckpt = FlashCheckpointer(args.ckpt_dir,
                                 job_name=ckpt_job_name(args.ckpt_dir))
        restored = ckpt.load(target=state)
        if restored is not None:
            state, meta = restored
            start_step = int(meta.get("step", 0))
            print(f"[worker {ctx.process_id}] restored step={start_step}",
                  flush=True)
            sampler.load_state_dict(
                meta.get("sampler", {"completed_steps": start_step}))

    def save(storage: bool) -> None:
        ckpt.save(state, meta={"step": step,
                               "sampler": sampler.state_dict()},
                  storage=storage)

    on_card = job.device.type == "cuda"
    launches0 = {n: fn.launches for n, fn in KERNELS.items()}
    step, loss, first_loss = start_step, float("nan"), float("nan")
    step_s = []
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
        if on_card:
            torch.cuda.synchronize(job.device)
        step_s.append(time.perf_counter() - t0)
        step += 1
        if len(step_s) == 1:
            first_loss = loss
        ctx.report_step(step)
        if ckpt is not None and step % args.ckpt_interval == 0:
            save(storage=False)
            print(f"[worker {ctx.process_id}] saved step={step} to memory "
                  f"(stall {ckpt.engine.last_stall_ms:.1f} ms)", flush=True)
        if step % 10 == 0 or step == args.steps:
            print(f"[worker {ctx.process_id}] step {step} loss "
                  f"{loss:.4f}", flush=True)
    ckpt_done = ""
    if ckpt is not None:
        save(storage=True)
        committed = ckpt.wait()
        stats = ckpt.engine.stats()
        ckpt.close()
        if not committed:
            raise RuntimeError(f"checkpoint of step {step} to "
                               f"{args.ckpt_dir} was not committed")
        print("CKPT_STATS " + json.dumps(stats), flush=True)
        ckpt_done = (f" restored_step={start_step} "
                     f"ckpt_stall_ms={stats['stall_ms']:.3f}")
    # The first step carries one-time set-up (allocator, library handles).
    steady = step_s[1:] or step_s
    step_ms = 1e3 * statistics.median(steady) if steady else float("nan")
    tokens = args.batch_per_proc * ctx.num_processes * args.seq_len
    launches = " ".join(f"{n}_launches={fn.launches - launches0[n]}"
                        for n, fn in KERNELS.items())
    # Losses in full (repr): a restored run is held to bit-equality.
    print(f"TRAIN_DONE step={step} loss={loss!r} "
          f"first_loss={first_loss!r} step_ms={step_ms:.3f} "
          f"tokens_per_s={1e3 * tokens / step_ms:.1f} device={job.device} "
          f"{launches}{ckpt_done}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
