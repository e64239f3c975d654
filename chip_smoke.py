#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``dlrover_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

It builds every CUDA kernel of the port's serving path from the sources in
this checkout (one ``nvcc`` per source, all started together), then runs
three phases and exits non-zero if any fails:

1. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes, with times (CUDA events), the byte and
   operation bound, and one PyTorch library call as a yardstick.
2. Full-width forward: one ``forward_step`` prefill of Llama-2-7B (bf16,
   full width and depth, random weights from a seed) with the kernel
   against the same with the plain RMSNorm; and a tiny fp32 model on the
   card against the same model on the CPU.
3. Serving: ``DecodeServer(slots=8, max_len=512)`` serves seeded requests
   of mixed lengths through the Llama-2-7B model.  Every kernel's launch
   count is reset just before and read just after; RMSNorm must have run
   65 times (2 per block + the final norm) per forward call.

The lines before the last give the kernels' record as JSON and the card's
name and power limit; the last line is the device record the driver reads.
On a host without CUDA, or without the repository beside it, it fails and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
D_MODEL = 4096
NORM_SHAPES = (8, 16, 256)  # decode rows (slots), smallest/largest bucket
SEED = 0
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(ref):
    import torch

    a = ref.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def build_kernels(kernel_modules) -> float:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_modules)) as ex:
        for fut in [ex.submit(m.build) for m in kernel_modules]:
            fut.result()
    return time.perf_counter() - t0


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


@contextlib.contextmanager
def plain_rmsnorm():
    """Route the model's norms through the plain version (comparison
    runs only)."""
    from dlrover_tpu_torch.models import llama, llama_infer
    from dlrover_tpu_torch.ops import rmsnorm as rms

    def plain(x, w, *, eps=1e-6):
        return rms._reference(x, w, eps)

    saved = (llama.rmsnorm, llama_infer.rmsnorm)
    llama.rmsnorm = llama_infer.rmsnorm = plain
    try:
        yield
    finally:
        llama.rmsnorm, llama_infer.rmsnorm = saved


def phase_kernels(rms) -> dict:
    """RMSNorm kernel vs plain at the path's shapes; returns the record of
    the decode shape (the launch the path makes most often)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        for rows in NORM_SHAPES:
            x = (torch.randn(rows, D_MODEL, generator=gen, device=DEV)
                 * 2.0).to(dtype)
            w = 1.0 + 0.1 * torch.randn(D_MODEL, generator=gen,
                                        device=DEV)
            eps = 1e-5
            out = rms.rmsnorm(x, w, eps=eps)
            ref = rms._reference(x, w, eps)
            torch.cuda.synchronize()
            err = (out.double() - ref.double()).abs()
            if dtype == torch.float32:
                tol = "atol 1e-5"
                ok = bool(err.max() <= 1e-5)
            else:
                tol = "1 bf16 ulp of the plain value"
                ok = bool((err <= bf16_ulp(ref)).all())
            if not ok:
                raise SystemExit(
                    f"rmsnorm kernel disagrees with plain at {rows}x"
                    f"{D_MODEL} {dtype}: max err {float(err.max())} "
                    f"({tol})"
                )
            w_lib = w.to(dtype)
            ms = time_ms(lambda: rms.rmsnorm(x, w, eps=eps))
            plain_ms = time_ms(lambda: rms._reference(x, w, eps))
            lib_ms = time_ms(
                lambda: F.rms_norm(x, (D_MODEL,), w_lib, eps)
            )
            esize = x.element_size()
            nbytes = 2 * rows * D_MODEL * esize + 4 * D_MODEL
            flops = 4 * rows * D_MODEL
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FP32_FLOPS_PER_S * 1e3
            row = {
                "rows": rows, "d": D_MODEL, "dtype": str(dtype),
                "max_abs_err": float(err.max()), "tolerance": tol,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes,
            }
            log("phase1 rmsnorm " + json.dumps(row))
            if dtype == torch.bfloat16 and rows == NORM_SHAPES[0]:
                rec = row
    return rec


def phase_forward(llama, infer, params, cfg) -> None:
    """Full-width prefill logits, kernel vs plain norm, on the card; and a
    tiny fp32 model on the card vs the same on the CPU."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    toks = torch.randint(1, cfg.vocab_size, (1, 64), generator=gen,
                         device=DEV)

    def prefill():
        cache = infer.init_cache(cfg, 1, 64, device=DEV)
        return infer.forward_step(params, toks, cfg, cache)[0]

    with torch.inference_mode():
        lk = prefill()
        with plain_rmsnorm():
            lp = prefill()
    torch.cuda.synchronize()
    if lk.shape != (1, 64, cfg.vocab_size) or not bool(
            torch.isfinite(lk).all()):
        raise SystemExit(f"7B prefill logits bad: {tuple(lk.shape)}")
    rel = float((lk - lp).norm() / lp.norm())
    # A norm output may differ from the plain one by 1 bf16 ulp (2**-8
    # relative); through 32 bf16 blocks such flips stay at the bf16
    # rounding scale of the logits, far below 1e-2 in relative L2.
    log(f"phase2 llama2_7b prefill rel_l2(kernel, plain) = {rel:.3e} "
        f"(bound 1e-2), max_abs = {float((lk - lp).abs().max()):.3e}, "
        f"argmax agreement = "
        f"{float((lk.argmax(-1) == lp.argmax(-1)).float().mean()):.4f}")
    if not rel <= 1e-2:
        raise SystemExit(f"7B prefill: kernel vs plain rel L2 {rel}")

    tcfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    cpu_params = llama.init_params(tcfg, torch.Generator().manual_seed(3),
                                   "cpu")
    dev_params = to_device(cpu_params, DEV)
    small = torch.randint(1, tcfg.vocab_size, (2, 12),
                          generator=torch.Generator().manual_seed(4))
    outs = []
    for p, dev in ((cpu_params, "cpu"), (dev_params, DEV)):
        with torch.inference_mode():
            cache = infer.init_cache(tcfg, 2, 16, device=dev)
            outs.append(infer.forward_step(p, small.to(dev), tcfg,
                                           cache)[0].cpu())
    err = float((outs[0] - outs[1]).abs().max())
    log(f"phase2 tiny fp32 logits card vs cpu max_abs = {err:.3e} "
        "(atol 1e-4: fp32 throughout, sums in another order)")
    if not err <= 1e-4:
        raise SystemExit(f"tiny model: card vs cpu max abs err {err}")


def profile_step(step, iters: int = 5) -> dict:
    """Device busy share of the decode step and its costliest kernels,
    from ``torch.profiler`` over ``iters`` steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    norm = [e for e in kernels if "rmsnorm_fwd_kernel" in e.key]
    norm_n = sum(e.count for e in norm)
    return {
        "rmsnorm_device_us_per_launch": (
            sum(e.self_device_time_total for e in norm) / norm_n
            if norm_n else None),
        "rmsnorm_launches_per_step": norm_n / iters,
        "steps": iters,
        "wall_ms_per_step": wall_us / 1e3 / iters,
        "device_ms_per_step": device_us / 1e3 / iters,
        "device_busy_share": device_us / wall_us,
        "kernels_per_step": sum(e.count for e in kernels) / iters,
        "top": [[e.key[:60], e.self_device_time_total / 1e3 / iters,
                 e.count // iters] for e in top],
    }


def phase_serve(infer, rms, params, cfg) -> dict:
    """DecodeServer over the 7B model; returns the measured numbers."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, 201, size=12)
    prompts = [rng.randint(1, cfg.vocab_size, size=(int(n),))
               .astype(np.int32) for n in lens]
    mnt = 32
    srv = infer.DecodeServer(params, cfg, slots=8, max_len=512, seed=SEED)
    srv.serve(prompts[:2], 4)  # warm-up: cuBLAS handles and plans

    first: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms.rmsnorm.launches = 0
    t0 = time.perf_counter()
    outs = srv.serve(prompts, mnt, on_token=lambda rid, _t: first.setdefault(
        rid, time.perf_counter() - t0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rms.rmsnorm.launches
    st = dict(srv.last_stats)
    peak = torch.cuda.max_memory_allocated()

    if len(outs) != len(prompts):
        raise SystemExit(f"served {len(outs)} of {len(prompts)} requests")
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + mnt or not np.array_equal(o[:len(p)], p) \
                or o.min() < 0 or o.max() >= cfg.vocab_size:
            raise SystemExit(f"bad output for a {len(p)}-token prompt")
    per_fwd = 2 * cfg.n_layer + 1
    if launches != per_fwd * st["forwards"] or launches == 0:
        raise SystemExit(
            f"rmsnorm launches {launches} != {per_fwd} x "
            f"{st['forwards']} forward calls"
        )
    new_tokens = sum(len(o) - len(p) for o, p in zip(outs, prompts))

    # One decode step (all 8 slots) with the kernel and with the plain
    # norm, in turns: plain, kernel, kernel, plain.
    cache = infer.init_cache(cfg, 8, 512, device=DEV)
    cache["offset"] = torch.full((8,), 200, dtype=torch.long, device=DEV)
    tok = torch.ones((8, 1), dtype=torch.long, device=DEV)

    def step():
        with torch.inference_mode():
            infer.forward_step(params, tok, cfg, dict(cache))

    step_ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        with plain_rmsnorm() if which == "plain" else \
                contextlib.nullcontext():
            step_ms[which].append(time_ms(step, iters=30, warmup=3))
    busy = profile_step(step)
    res = {
        "requests": len(prompts), "slots": 8, "max_len": 512,
        "max_new_tokens": mnt, "prompt_lens": [int(n) for n in lens],
        "new_tokens": new_tokens, "serve_s": wall,
        "tokens_per_s": new_tokens / wall,
        "ttft_p50_ms": 1e3 * statistics.median(first.values()),
        "ttft_max_ms": 1e3 * max(first.values()),
        "rounds": st["rounds"], "prefills": st["prefills"],
        "forwards": st["forwards"], "rmsnorm_launches": launches,
        "peak_mem_gib": peak / 2 ** 30,
        "decode_step_ms_kernel": step_ms["kernel"],
        "decode_step_ms_plain": step_ms["plain"],
        "decode_step_profile": busy,
    }
    log("phase3 serve " + json.dumps(res))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; run it on the GPU machine",
              file=sys.stderr)
        return 2
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.models import llama_infer as infer
    from dlrover_tpu_torch.ops import rmsnorm as rms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"build: {build_kernels([rms]):.1f}s")

    rec = phase_kernels(rms)

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    log(f"llama2_7b params on card: {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    phase_forward(llama, infer, params, cfg)
    served = phase_serve(infer, rms, params, cfg)

    kernels = [{
        "name": "rmsnorm", "route": "cuda",
        "source": "dlrover_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "dlrover_tpu/ops/rmsnorm.py:25",
        "launches": served["rmsnorm_launches"],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
    }]
    if not all(math.isfinite(k[f]) for k in kernels
               for f in ("ms", "plain_ms", "bound_ms", "library_ms")):
        raise SystemExit("a kernel time is not finite")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
