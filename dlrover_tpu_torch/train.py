"""Training entry point: Llama pretraining on one card.

The port's counterpart of ``examples/llama_train.py`` with its own copy of
``synth_tokens``, its flags and defaults (the LoRA and checkpoint
settings only as far as the refusals below need them) and ``--device``:

    python -m dlrover_tpu_torch.train --model 800m --seq_len 2048 --steps 5
    python -m dlrover_tpu_torch.train --model tiny --steps 20 --device cpu

It builds ``llama.loss_fn`` over fp32 master parameters (random, seed 0),
trains with ``adamw(lr)`` through ``accelerate()`` on the example's
synthetic tokens drawn by an ``ElasticSampler`` (seed 17), prints the loss
every 10 steps and a final ``TRAIN_DONE`` line with the loss, the median
step time, tokens/s and each kernel's launch count (0 on the CPU, where
the plain versions run).

Refused, each with the slice that brings it: ``--strategy auto``,
``--fp8``, ``--quant_grads``, ``--lora_rank > 0``, ``--init_from`` and
``--ckpt_dir`` (flash checkpointing).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
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
        (bool(args.ckpt_dir), "--ckpt_dir (flash checkpointing)",
         "the checkpoint slice of the port (see ROADMAP.md)"),
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    refuse_later_options(args)
    ctx = bootstrap.init()
    cfg, job, state = build(args, ctx.num_processes)
    sampler = ElasticSampler(
        args.dataset_size,
        batch_size_per_process=args.batch_per_proc,
        num_processes=ctx.num_processes,
        process_id=ctx.process_id,
        seed=17,
    )
    on_card = job.device.type == "cuda"
    launches0 = {n: fn.launches for n, fn in KERNELS.items()}
    step, loss, first_loss = 0, float("nan"), float("nan")
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
        if step == 1:
            first_loss = loss
        ctx.report_step(step)
        if step % 10 == 0 or step == args.steps:
            print(f"[worker {ctx.process_id}] step {step} loss "
                  f"{loss:.4f}", flush=True)
    # The first step carries one-time set-up (allocator, library handles).
    steady = step_s[1:] or step_s
    step_ms = 1e3 * statistics.median(steady) if steady else float("nan")
    tokens = args.batch_per_proc * ctx.num_processes * args.seq_len
    launches = " ".join(f"{n}_launches={fn.launches - launches0[n]}"
                        for n, fn in KERNELS.items())
    print(f"TRAIN_DONE step={step} loss={loss:.4f} "
          f"first_loss={first_loss:.4f} step_ms={step_ms:.3f} "
          f"tokens_per_s={1e3 * tokens / step_ms:.1f} device={job.device} "
          f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
