#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``dlrover_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

It builds every CUDA kernel of the port's serving and training paths from
the sources in this checkout (one ``nvcc`` per source, all started
together), then runs eight phases and exits non-zero if any fails:

1. RMSNorm kernel vs plain: the kernel against its plain PyTorch version on
   the card, at the serving path's shapes, with times (CUDA events; the
   call and one PyTorch library call as its yardstick in turns), the byte
   and operation bound, and at the decode shape the call's host time
   broken down into its parts.
2. Full-width forward: one ``forward_step`` prefill of Llama-2-7B (bf16,
   full width and depth, random weights from a seed) with the kernel
   against the same with the plain RMSNorm; and a tiny fp32 model on the
   card against the same model on the CPU.
3. Serving: ``DecodeServer(slots=8, max_len=512)`` serves seeded requests
   of mixed lengths through the Llama-2-7B model.  Every kernel's launch
   count is reset just before and read just after; RMSNorm must have run
   65 times (2 per block + the final norm) per forward call.
4. Flash attention kernels (forward, dq, dk/dv) vs plain at the
   Llama-800M training shape, phase 8's shape, a GQA shape with a ragged
   length, and an fp32 case with a window and packed segments.  bf16 runs
   the tensor-core kernels (``design`` "wgmma"), fp32 the CUDA-core ones;
   each row gives ``bound_share`` (bound / time); two dq and two dk/dv
   launches at phase 8's shape must each agree bit for bit; beside SDPA's
   backward, ``bwd_total_ms`` is the time of dq and dk/dv together.
5. Cross-entropy kernel vs plain at [8192, 32000] (fp32, bf16), a ragged
   V, a V too wide for the single-read cluster kernel (the two-pass route)
   and the tiny model's training shapes: each shape on the route it names
   (counted), labels outside [0, V) picking no target, a repeat
   bit-identical, and at the large shapes the route's kernel by name in a
   profile, with its device time and ``device_bound_share``.
6. Training: (a) Llama-800M widths at 2 layers, one step's loss and
   gradients through the kernels against the plain versions on the card,
   and with per-block remat; (b) ``dlrover_tpu_torch.train.main`` trains
   Llama-800M at full width and depth (B 4, S 2048) for a few steps: the
   loss falls and every attention forward and backward went through the
   flash kernels; step time, tokens/s, MFU, peak memory and a profiled
   step's device busy share, whose kernels must include 24
   ``flash_fwd_wgmma``, 24 ``flash_dq_wgmma`` and 24 ``flash_dkv_wgmma``
   launches and no bf16 instance of a CUDA-core flash kernel; (c) the tiny
   model's
   training through the cross-entropy kernel, one launch per step.
7. Blockwise int8 quantize: the op ``quantize_blockwise`` at the JAX
   kernel smoke's shape (4 Mi fp32 values, seed 4) with the kernel counts
   reset just before and read just after, its round trip within
   ``max|x| / 254``; then the kernel against its plain version on that
   and four more inputs (a ragged tail, bf16, an all-zero block, .5
   ties): codes equal and scales bit-equal.
8. 8-bit Adam training: ``accelerate(..., optimizer=adam8bit(3e-4))``
   trains Llama-800M-h128 (12 heads of 128, full width and depth, per-
   block remat, bf16 compute, fp32 masters, int8 moments) at B 16 x S
   2048 for 4 steps on one seeded batch: the loss falls; step time,
   tokens/s, MFU, peak memory, the moments' bytes, each kernel's launches
   a step (the blockwise quantize: 0, the moments use the dynamic codes)
   and a profiled step with the optimizer's device time, whose kernels
   must include 48 ``flash_fwd_wgmma``, 24 ``flash_dq_wgmma`` and 24
   ``flash_dkv_wgmma`` launches and no bf16 instance of a CUDA-core flash
   kernel.

The lines before the last give the kernels' record as JSON and the card's
name and power limit; the last line is the device record the driver reads.
On a host without CUDA, or without the repository beside it, it fails and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, tensor cores, dense
TRAIN_STEPS = 6  # phase 6b; the first step carries set-up
TRAIN_BATCH, TRAIN_SEQ = 4, 2048  # phases 6a and 6b
D_MODEL = 4096
NORM_SHAPES = (8, 16, 256)  # decode rows (slots), smallest/largest bucket
SEED = 0
DEV = "cuda"
A8_STEPS = 4  # phase 8; the first step carries set-up
A8_BATCH, A8_SEQ = 16, 2048  # phase 8
QUANT_OPS_PER_ELEMENT = 6  # |x|, max, divide, round, clip (2)


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
def plain_kernels():
    """Route the models' norms, attention and cross-entropy through the
    plain versions, with the same autograd functions and the same
    no-gradient shortcut as the wrappers (comparison runs only)."""
    import torch

    from dlrover_tpu_torch.models import llama, llama_infer
    from dlrover_tpu_torch.ops import cross_entropy as xent
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import rmsnorm as rms

    def norm(x, w, *, eps=1e-6):
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return rms._RMSNorm.apply(x, w, eps, rms._reference)
        return rms._reference(x, w, eps)

    def attn(q, k, v, *, causal=True, segment_ids=None, window=0):
        return fa.FlashAttention.apply(q, k, v, segment_ids, causal, window,
                                       fa.PLAIN)

    def ce(logits, labels):
        return xent.SoftmaxCrossEntropy.apply(logits, labels,
                                              xent._reference)

    saved = (llama.rmsnorm, llama_infer.rmsnorm, llama.flash_attention,
             llama.softmax_cross_entropy)
    (llama.rmsnorm, llama_infer.rmsnorm, llama.flash_attention,
     llama.softmax_cross_entropy) = norm, norm, attn, ce
    try:
        yield
    finally:
        (llama.rmsnorm, llama_infer.rmsnorm, llama.flash_attention,
         llama.softmax_cross_entropy) = saved


def time_turns(fns: dict, pairs: int = 4, iters: int = 500) -> dict:
    """``time_ms`` of each function in ``fns``, in turns (a b b a, ``pairs``
    times over): the median of its ``2 * pairs`` times, and the times."""
    names = list(fns)
    runs = {name: [] for name in names}
    for _ in range(pairs):
        for name in names + names[::-1]:
            runs[name].append(time_ms(fns[name], iters=iters))
    return {name: (statistics.median(t), t) for name, t in runs.items()}


def host_us(fn, n: int = 1000, reps: int = 5) -> float:
    """Host µs of one ``fn()``: the host clock over ``n`` back-to-back
    calls, median of ``reps`` such runs, the card synchronised between
    runs (and outside the clock)."""
    import torch

    for _ in range(50):
        fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def rmsnorm_host_breakdown(rms, x, w, eps) -> dict:
    """Host µs of the RMSNorm call at ``x``'s shape and of its parts, each
    timed alone: ``alloc`` the fresh output (``empty_like``), ``stream``
    the caller's stream read as an int, ``launch`` the entry point called
    with plain ints (it enqueues the kernel), and ``rest`` what is left of
    the call (dispatch, checks, pointers).  Beside them, what the call
    paid before the lean host call, timed the same way: a
    ``torch.cuda.Stream`` object for the stream, a ``torch.cuda.device``
    guard, and the entry point bound with ctypes ``argtypes``."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import _build, _launch

    lo, dev, D = _launch.LO, x.get_device(), x.shape[-1]
    out = torch.empty_like(x)
    st = _launch.stream(dev)
    args = [x.data_ptr(), w.data_ptr(), out.data_ptr()]
    args = [h for p in args for h in (p & lo, p >> 32)] + [
        x.numel() // D, D, ctypes.c_float(eps), 1, dev, st & lo, st >> 32]
    fn = rms._kernel_fn()
    typed = ctypes.CDLL(str(_build.build("rmsnorm", rms.SOURCES)))
    typed = typed.dlr_rmsnorm_fwd
    typed.argtypes = [ctypes.c_uint32] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_uint32] * 2
    typed.restype = ctypes.c_int
    w_lib = w.to(x.dtype)

    def guard():
        with torch.cuda.device(x.device):
            pass

    res = {
        "call": host_us(lambda: rms.rmsnorm(x, w, eps=eps)),
        "alloc": host_us(lambda: torch.empty_like(x)),
        "stream": host_us(lambda: _launch.stream(dev)),
        "launch": host_us(lambda: fn(*args)),
        "library_call": host_us(lambda: F.rms_norm(x, (D,), w_lib, eps)),
        "before_stream_object": host_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "before_device_guard": host_us(guard),
        "before_argtypes_launch": host_us(lambda: typed(*args)),
    }
    res["rest"] = res["call"] - res["alloc"] - res["stream"] - res["launch"]
    return res


def phase_kernels(rms) -> dict:
    """RMSNorm kernel vs plain at the path's shapes; returns the record of
    the decode shape (the launch the path makes most often).  The call and
    ``F.rms_norm`` are timed in turns; at the decode shape the call's host
    time is broken down into its parts."""
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
            turns = time_turns({
                "kernel": lambda: rms.rmsnorm(x, w, eps=eps),
                "library": lambda: F.rms_norm(x, (D_MODEL,), w_lib, eps),
            })
            plain_ms = time_ms(lambda: rms._reference(x, w, eps))
            esize = x.element_size()
            nbytes = 2 * rows * D_MODEL * esize + 4 * D_MODEL
            flops = 4 * rows * D_MODEL
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FP32_FLOPS_PER_S * 1e3
            row = {
                "rows": rows, "d": D_MODEL, "dtype": str(dtype),
                "max_abs_err": float(err.max()), "tolerance": tol,
                "ms": turns["kernel"][0], "plain_ms": plain_ms,
                "library_ms": turns["library"][0],
                "ms_turns": {k: v[1] for k, v in turns.items()},
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes,
            }
            row["bound_share"] = row["bound_ms"] / row["ms"]
            log("phase1 rmsnorm " + json.dumps(row))
            if dtype == torch.bfloat16 and rows == NORM_SHAPES[0]:
                rec = row
                log("phase1 rmsnorm host_us " + json.dumps(
                    rmsnorm_host_breakdown(rms, x, w, eps)))
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
        with plain_kernels():
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


def step_profile(run, iters: int = 1, top: int = 10) -> tuple:
    """``torch.profiler`` over one call of ``run``, which makes ``iters``
    steps and ends in a synchronise.  Returns ``(summary, kernel events,
    every averaged event)``: the summary gives, per step, wall and device
    ms, the device busy share, the kernel launches and the ``top``
    costliest kernels.  Kernel events leave out the device-side spans of
    user annotations (``record_function``, ``Optimizer.step#...``), which
    would count their kernels twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    cpu_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key not in cpu_keys]
    device_us = sum(e.self_device_time_total for e in kernels)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    summary = {
        "steps": iters, "wall_ms": wall_us / 1e3 / iters,
        "device_ms": device_us / 1e3 / iters,
        "device_busy_share": device_us / wall_us,
        "kernels": sum(e.count for e in kernels) / iters,
        "top": [[e.key[:60], e.self_device_time_total / 1e3 / iters,
                 e.count / iters] for e in ranked[:top]],
    }
    return summary, kernels, events


def kernel_device_us(kernels, name_part: str) -> tuple:
    """``(mean device µs a launch, launches)`` of the kernel events whose
    name holds ``name_part``."""
    hits = [e for e in kernels if name_part in e.key]
    n = sum(e.count for e in hits)
    return (sum(e.self_device_time_total for e in hits) / n if n else None,
            n)


# The CUDA-core flash kernels' bf16 instances (the build has none; a
# profile that shows one ran the wrong kernel).  The word boundary keeps
# ``rmsnorm_fwd_kernel`` out.
OLD_BF16_FLASH = re.compile(r"\b(fwd|dq|dkv)_kernel<__nv_bfloat16")
# The tensor-core flash kernels, by the unique part of their names.
TC_FLASH = ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")


def tensor_core_launches(kernels, steps: int, want: dict, what: str) -> dict:
    """Launches a step of the tensor-core flash kernels in a profile's
    kernel events; fails unless they equal ``want`` or if a bf16 instance
    of a CUDA-core flash kernel ran."""
    old = sorted({e.key[:90] for e in kernels if OLD_BF16_FLASH.search(e.key)})
    got = {name: kernel_device_us(kernels, name)[1] / steps for name in want}
    if old or got != want:
        raise SystemExit(f"{what}: tensor-core flash launches a step {got} "
                         f"!= {want}, old bf16 kernels {old}")
    return got


def phase_serve(infer, rms, params, cfg, counted) -> dict:
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
    reset_launches(*counted)
    t0 = time.perf_counter()
    outs = srv.serve(prompts, mnt, on_token=lambda rid, _t: first.setdefault(
        rid, time.perf_counter() - t0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rms.rmsnorm.launches
    others = {w.__name__: w.launches for w in counted if w is not rms.rmsnorm}
    if any(others.values()):
        raise SystemExit(f"serving launched training kernels: {others}")
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
        with plain_kernels() if which == "plain" else \
                contextlib.nullcontext():
            step_ms[which].append(time_ms(step, iters=30, warmup=3))
    step()
    torch.cuda.synchronize()

    def five_steps():
        for _ in range(5):
            step()
        torch.cuda.synchronize()

    busy, kernels, _ = step_profile(five_steps, iters=5, top=8)
    norm_us, norm_n = kernel_device_us(kernels, "rmsnorm_fwd_kernel")
    busy["rmsnorm_device_us_per_launch"] = norm_us
    busy["rmsnorm_launches_per_step"] = norm_n / 5
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


def reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def close_check(got, plain32, what: str) -> dict:
    """Tolerances of phase 4: fp32 outputs within 1e-4 of the largest
    plain value (fp32 sums of up to S products in another order); bf16
    outputs within 2 bf16 ulps of the plain fp32 value plus 1e-5 of the
    largest (one rounding each side; sums of cancelling terms keep the
    fp32 sum-order error)."""
    import torch

    err = (got.double() - plain32.double()).abs()
    scale = float(plain32.abs().max())
    if got.dtype == torch.float32:
        ok = float(err.max()) <= 1e-4 * scale + 1e-6
        tol = "1e-4 of max|plain|"
    else:
        ok = bool((err <= 2 * bf16_ulp(plain32) + 1e-5 * scale).all())
        tol = "2 bf16 ulp + 1e-5 of max|plain|"
    if not ok:
        raise SystemExit(f"{what}: kernel disagrees with plain, max err "
                         f"{float(err.max())} ({tol})")
    return {"max_abs_err": float(err.max()), "tolerance": tol}


FLASH_SHAPES = {
    # name: B, H, KV, S, D, dtype, causal, window, segments
    "llama800m": (4, 16, 16, 2048, 96, "bfloat16", True, 0, False),
    # phase 8's attention: Llama-800M-h128 at B 16
    "llama800m_h128": (16, 12, 12, 2048, 128, "bfloat16", True, 0, False),
    "gqa_ragged": (2, 32, 8, 1000, 128, "bfloat16", True, 0, False),
    "fp32_window_segments": (2, 8, 8, 1024, 64, "float32", True, 256, True),
}


def flash_inputs(B, H, KV, S, D, dtype, segs, seed):
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, S, D, generator=gen, device=DEV).to(dt)
    k = torch.randn(B, KV, S, D, generator=gen, device=DEV).to(dt)
    v = torch.randn(B, KV, S, D, generator=gen, device=DEV).to(dt)
    g = torch.randn(B, H, S, D, generator=gen, device=DEV).to(dt)
    seg = None
    if segs:
        cuts = torch.sort(torch.randint(1, S - 16, (B, 5), generator=gen,
                                        device=DEV)).values
        seg = (torch.arange(S, device=DEV)[None, :, None]
               >= cuts[:, None, :]).sum(-1).to(torch.int32)
        seg[:, -16:] = -1
    return q, k, v, g, seg


def flash_bound(q, k, seg, causal, window, which: str) -> dict:
    """Least time for the work of one kernel on these inputs: its
    products over the visible (query, key) pairs at the peak for the
    inputs' type, or its bytes (each input read once, each output written
    once) at the memory rate, whichever is larger."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    B, H, S, D = q.shape
    mask = fa._visible(S, causal, seg, window, q.device)
    per_head = B * S * S if mask is None else \
        float(mask.expand(B, 1, S, S).sum())
    pairs = per_head * H
    products = {"fwd": 2, "dq": 3, "dkv": 4}[which]
    flops = 2.0 * D * pairs * products
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else \
        FP32_FLOPS_PER_S
    e = q.element_size()
    nq, nk = q.numel(), k.numel()
    stats = 4 * B * H * S
    seg_bytes = 0 if seg is None else 4 * B * S
    nbytes = {
        "fwd": e * (2 * nq + 2 * nk) + stats,
        "dq": e * (3 * nq + 2 * nk) + 2 * stats,
        "dkv": e * (2 * nq + 4 * nk) + 2 * stats,
    }[which] + seg_bytes
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes, "visible_pairs": pairs}


def sdpa_times(q, k, v, g) -> dict:
    """``F.scaled_dot_product_attention`` on the flash backend, causal:
    one forward, and one backward giving dq, dk and dv together."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=20, warmup=3)
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), g, retain_graph=True), iters=20, warmup=3)
    return {"fwd": fwd_ms, "bwd": bwd_ms}


def phase_flash() -> dict:
    """Flash kernels vs plain; returns the records at the 800M shape."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    recs = {}
    for i, (name, shape) in enumerate(FLASH_SHAPES.items()):
        B, H, KV, S, D, dtype, causal, window, segs = shape
        q, k, v, g, seg = flash_inputs(B, H, KV, S, D, dtype, segs, SEED + i)
        kw = dict(causal=causal, segment_ids=seg, window=window)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = fa._delta(out, g)
        dq = fa.flash_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, g)]
        p_out, p_lse = fa._flash_fwd_plain(*f32[:3], causal, seg, window)
        lse_err = float((lse - p_lse).abs().max())
        if not lse_err <= 1e-4:
            raise SystemExit(f"flash {name}: lse err {lse_err} (atol 1e-4)")
        checks = {"fwd": close_check(out, p_out, f"flash fwd {name}")}
        del p_out, p_lse
        p_dq, p_dk, p_dv = fa._bwd_parts(*f32, lse, delta, causal, seg,
                                         window, True, True)
        checks["dq"] = close_check(dq, p_dq, f"flash dq {name}")
        e_dk = close_check(dk, p_dk, f"flash dk {name}")
        e_dv = close_check(dv, p_dv, f"flash dv {name}")
        checks["dkv"] = max(e_dk, e_dv, key=lambda c: c["max_abs_err"])
        del f32, p_dq, p_dk, p_dv
        iters = 10 if S >= 2048 else 20
        times = {
            "fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                    lambda: fa._flash_fwd_plain(q, k, v, causal, seg,
                                                window)),
            "dq": (lambda: fa.flash_dq(q, k, v, g, lse, delta, **kw),
                   lambda: fa._bwd_parts(q, k, v, g, lse, delta, causal,
                                         seg, window, True, False)),
            "dkv": (lambda: fa.flash_dkv(q, k, v, g, lse, delta, **kw),
                    lambda: fa._bwd_parts(q, k, v, g, lse, delta, causal,
                                          seg, window, False, True)),
        }
        lib = sdpa_times(q, k, v, g) if name.startswith("llama800m") \
            else None
        if name == "llama800m_h128":
            # dq and dk/dv sum in registers in a fixed order, with no
            # atomics: block remat (phase 6a) relies on a repeat being
            # bit-equal.
            again_dq = fa.flash_dq(q, k, v, g, lse, delta, **kw)
            again = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
            torch.cuda.synchronize()
            if not torch.equal(again_dq, dq):
                raise SystemExit(f"flash dq {name}: a repeat differs")
            if not (torch.equal(again[0], dk) and torch.equal(again[1], dv)):
                raise SystemExit(f"flash dk/dv {name}: a repeat differs")
            log(f"phase4 flash {name}: dq and dk/dv repeats bit-identical")
            del again, again_dq
        design = "wgmma" if dtype == "bfloat16" else "cuda-core"
        rows = {}
        for which, (kern, plain) in times.items():
            row = {"shape": name, "kernel": which, "lse_err": lse_err,
                   "design": design,
                   **checks[which],
                   "ms": time_ms(kern, iters=iters, warmup=2),
                   "plain_ms": time_ms(plain, iters=3, warmup=1),
                   "library_ms": None if lib is None else
                   lib["fwd" if which == "fwd" else "bwd"],
                   **flash_bound(q, k, seg, causal, window, which)}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            log("phase4 flash " + json.dumps(row))
            rows[which] = row
        if lib is not None:
            # SDPA's backward gives dq, dk and dv in one call: its
            # yardstick is the port's two backward kernels together.
            total = rows["dq"]["ms"] + rows["dkv"]["ms"]
            log(f"phase4 flash {name} backward " + json.dumps({
                "bwd_total_ms": total, "sdpa_bwd_ms": lib["bwd"],
                "bwd_total_over_sdpa": total / lib["bwd"]}))
        if name == "llama800m":
            recs = rows
        del q, k, v, g, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    return recs


XENT_SHAPES = (
    # rows, V, dtype, label dtype
    (8192, 32000, "float32", "int64"),
    (8192, 32000, "bfloat16", "int32"),
    (8192, 32001, "float32", "int64"),  # ragged: single-element loads
    (1024, 128256, "float32", "int64"),  # Llama 3's vocab: the two-pass route
    (64, 256, "float32", "int32"),
    (128, 256, "float32", "int32"),  # tiny training: 4 x 32 tokens
)
XENT_KERNELS = {"cluster": "xent_cluster_kernel",
                "two_pass": "xent_fwd_kernel"}


def phase_xent() -> dict:
    """Cross-entropy kernel vs plain (atol 1e-4 on losses of ~log V: fp32
    sums of V exponentials in another order), each shape on the route its
    shape names (counted), a repeat bit-identical; at the large shapes a
    profile of five calls must show that route's kernel by name, and gives
    its device time.  Returns the record at the tiny training shape, the
    path phase 6c drives."""
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import cross_entropy as xent

    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    rec = None
    for rows, V, dtype, ldtype in XENT_SHAPES:
        logits = (3.0 * torch.randn(rows, V, generator=gen, device=DEV)
                  ).to(getattr(torch, dtype))
        labels = torch.randint(0, V, (rows,), generator=gen, device=DEV
                               ).to(getattr(torch, ldtype))
        # Labels outside [0, V) pick no target (F.cross_entropy refuses
        # them, so the timed inputs keep every label inside).
        outside = labels.clone()
        outside[:2] = torch.tensor([-1, V])
        which = xent.route(rows, V, logits.element_size())
        before = dict(xent.xent_fwd.route_launches)
        out = xent.xent_fwd(logits, labels)
        again = xent.xent_fwd(logits, labels)
        out_outside = xent.xent_fwd(logits, outside)
        ref = xent._reference(logits, labels)
        ref_outside = xent._reference(logits, outside)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in xent.xent_fwd.route_launches
               .items()}
        if ran != {k: 3 if k == which else 0 for k in ran}:
            raise SystemExit(f"xent [{rows},{V}] {dtype}: routes {ran}, "
                             f"want 3 on {which}")
        err = max(float((out - ref).abs().max()),
                  float((out_outside - ref_outside).abs().max()))
        if not err <= 1e-4:
            raise SystemExit(f"xent [{rows},{V}] {dtype}: max err {err} "
                             "(atol 1e-4)")
        if not torch.equal(out, again):
            raise SystemExit(f"xent [{rows},{V}] {dtype}: a repeat differs")
        nbytes = rows * V * logits.element_size() + \
            rows * labels.element_size() + 4 * rows
        ops = 4.0 * rows * V
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOPS_PER_S * 1e3
        row = {"rows": rows, "v": V, "dtype": dtype, "labels": ldtype,
               "route": which, "kernel": XENT_KERNELS[which],
               "max_abs_err": err, "tolerance": "atol 1e-4",
               "repeat_bit_identical": True,
               "ms": time_ms(lambda: xent.xent_fwd(logits, labels)),
               "plain_ms": time_ms(lambda: xent._reference(logits, labels),
                                   iters=50),
               "library_ms": time_ms(lambda: F.cross_entropy(
                   logits, labels.long(), reduction="none")),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": nbytes}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if rows >= 1024:
            def five_calls():
                for _ in range(5):
                    xent.xent_fwd(logits, labels)
                torch.cuda.synchronize()

            # The route counters above count every launch; the profile
            # shows by name which kernel ran (it may miss the first launch
            # of its window) and gives its device time a launch.
            _, kernels, _ = step_profile(five_calls, iters=5)
            us, n = kernel_device_us(kernels, row["kernel"])
            others = [e.key[:60] for e in kernels if "xent_" in e.key
                      and row["kernel"] not in e.key]
            if not n or others:
                raise SystemExit(
                    f"xent [{rows},{V}] {dtype}: the profile shows {n} "
                    f"{row['kernel']} launches, and {others}")
            row["profiled_launches"] = n
            row["device_us"] = us
            row["device_bound_share"] = row["bound_ms"] * 1e3 / us
        log("phase5 xent " + json.dumps(row))
        if (rows, V) == (128, 256):
            rec = row
        del logits, labels, outside, out, again, out_outside, ref, \
            ref_outside
    return rec


def loss_and_grads(llama, params, batch, cfg):
    from dlrover_tpu_torch.parallel.accelerate import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    loss = llama.loss_fn(params, batch, cfg)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in leaves]


def phase_train_parity(llama, train, counted) -> dict:
    """Llama-800M widths at 2 layers, B 4, S 2048: one step's loss and
    gradients through the kernels against the plain versions on the card
    (relative L2 of each gradient tensor <= 5e-2 and relative loss
    difference <= 1e-3: bf16 activations, where a rounding flip is 2**-8
    of a value, through two blocks and back); and the same step with
    per-block remat, which recomputes the same kernels (relative L2 <=
    1e-6)."""
    import torch

    from dlrover_tpu_torch.parallel.accelerate import tree_leaves

    cfg = dataclasses.replace(llama.LlamaConfig.medium_800m(), n_layer=2)
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(SEED + 11), DEV,
        param_dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.from_numpy(train.synth_tokens(
        range(TRAIN_BATCH), TRAIN_SEQ, cfg.vocab_size)).to(DEV)
    batch = {"tokens": toks}
    reset_launches(*counted)
    loss_k, grads_k = loss_and_grads(llama, params, batch, cfg)
    launches = {w.__name__: w.launches for w in counted}
    want = {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "rmsnorm": 5,
            "xent_fwd": 0, "quantize_blockwise": 0}
    if launches != want:
        raise SystemExit(f"2-layer step launches {launches} != {want}")
    with plain_kernels():
        loss_p, grads_p = loss_and_grads(llama, params, batch, cfg)
    reset_launches(*counted)
    loss_r, grads_r = loss_and_grads(
        llama, params, batch, dataclasses.replace(cfg, remat_block=True))
    remat_launches = {w.__name__: w.launches for w in counted}
    if remat_launches["flash_fwd"] != 4 or remat_launches["rmsnorm"] != 9:
        raise SystemExit(f"remat step launches {remat_launches}")

    def rel(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp(min=1e-30))

    rel_plain = [rel(a, b) for a, b in zip(grads_k, grads_p)]
    rel_remat = [rel(a, b) for a, b in zip(grads_r, grads_k)]
    res = {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_remat": loss_r,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_l2_max": max(rel_plain),
           "grad_rel_l2_median": statistics.median(rel_plain),
           "remat_grad_rel_l2_max": max(rel_remat),
           "launches": launches, "remat_launches": remat_launches}
    log("phase6a train parity " + json.dumps(res))
    if not (math.isfinite(loss_k) and res["loss_rel_diff"] <= 1e-3
            and res["grad_rel_l2_max"] <= 5e-2
            and res["remat_grad_rel_l2_max"] <= 1e-6
            and loss_r == loss_k):
        raise SystemExit(f"2-layer training step: kernel vs plain {res}")
    return res


def run_train_cli(train, argv, counted) -> dict:
    """``train.main(argv)`` with every kernel count reset just before and
    read just after; returns its TRAIN_DONE fields and the counts."""
    import torch

    reset_launches(*counted)
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    torch.cuda.synchronize()
    out = buf.getvalue()
    log("\n".join("  " + ln for ln in out.strip().splitlines()[-3:]))
    done = [ln for ln in out.splitlines() if ln.startswith("TRAIN_DONE")]
    if rc != 0 or not done:
        raise SystemExit(f"train.main({argv}) failed: rc {rc}\n{out}")
    stats = dict(kv.split("=", 1) for kv in done[-1].split()[1:])
    stats["counts"] = {w.__name__: w.launches for w in counted}
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return stats


def profile_train_step(train, args) -> dict:
    """Device busy share and costliest kernels of one 800M training step
    (``torch.profiler``), after one warm-up step."""
    import torch

    cfg, job, state = train.build(args)
    toks = train.synth_tokens(range(args.batch_per_proc), args.seq_len,
                              cfg.vocab_size)
    state, m = job.train_step(state, {"tokens": toks})
    float(m["loss"])
    torch.cuda.synchronize()

    def run():
        _, m2 = job.train_step(state, {"tokens": toks})
        float(m2["loss"])
        torch.cuda.synchronize()

    res, kernels, _ = step_profile(run)
    del state, job
    return res, kernels


def phase_train(llama, train, counted) -> dict:
    """6b: Llama-800M full width and depth through ``train.main``; 6c: the
    tiny model through the cross-entropy kernel.

    6b trains on ``--dataset_size`` = one global batch, so every step
    sees the same rows and the loss must fall within a few steps.  On the
    example's default 4096-row set each step draws fresh rows of a
    shifted random sequence, which a few steps cannot learn: the loss
    then moves by batch-to-batch noise only.  The work per step is the
    same either way."""
    import torch

    argv = ["--model", "800m", "--seq_len", str(TRAIN_SEQ),
            "--batch_per_proc", str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS),
            "--dataset_size", str(TRAIN_BATCH), "--device", DEV]
    st = run_train_cli(train, argv, counted)
    args = train.parse_args(argv)
    cfg = train.build_config(args)
    n, counts = TRAIN_STEPS, st["counts"]
    first, last = float(st["first_loss"]), float(st["loss"])
    want = {"flash_fwd": cfg.n_layer * n, "flash_dq": cfg.n_layer * n,
            "flash_dkv": cfg.n_layer * n,
            "rmsnorm": (2 * cfg.n_layer + 1) * n, "xent_fwd": 0,
            "quantize_blockwise": 0}
    if counts != want:
        raise SystemExit(f"800m training launches {counts} != {want}")
    if not (math.isfinite(first) and math.isfinite(last) and last < first):
        raise SystemExit(f"800m training loss did not fall: {first} -> "
                         f"{last}")
    tok_s = float(st["tokens_per_s"])
    res = {"model": "medium_800m", "n_layer": cfg.n_layer,
           "d_model": cfg.d_model, "batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ,
           "steps": n, "first_loss": first, "loss": last,
           "step_ms": float(st["step_ms"]), "tokens_per_s": tok_s,
           "flops_per_token": llama.flops_per_token(cfg),
           "mfu": llama.flops_per_token(cfg) * tok_s / BF16_FLOPS_PER_S,
           "peak_mem_gib": st["peak_mem_gib"], "launches": counts}
    torch.cuda.empty_cache()
    res["profile"], kernels = profile_train_step(train, args)
    res["profile"]["tensor_core_launches_per_step"] = tensor_core_launches(
        kernels, 1, dict.fromkeys(TC_FLASH, cfg.n_layer),
        "800m training profile")
    res["profile"]["flash_device_us_per_launch"] = {
        name: kernel_device_us(kernels, name)[0] for name in TC_FLASH}
    del kernels
    torch.cuda.empty_cache()
    log("phase6b train 800m " + json.dumps(res))

    tiny = run_train_cli(train, ["--model", "tiny", "--steps", "5",
                                 "--device", DEV], counted)
    tc = tiny["counts"]
    tiny_want = {"flash_fwd": 2 * 5, "flash_dq": 2 * 5, "flash_dkv": 2 * 5,
                 "rmsnorm": 5 * 5, "xent_fwd": 5, "quantize_blockwise": 0}
    if tc != tiny_want or not math.isfinite(float(tiny["loss"])):
        raise SystemExit(f"tiny training: {tiny}")
    res["tiny"] = {"loss": float(tiny["loss"]),
                   "first_loss": float(tiny["first_loss"]), "launches": tc}
    log("phase6c train tiny " + json.dumps(res["tiny"]))
    return res


def quant_inputs() -> dict:
    """Phase 7's inputs on the card: the JAX kernel smoke's (``randn(4 <<
    20)`` fp32 from ``RandomState(4)``), a ragged tail, bf16, an all-zero
    block, and a block whose scale is exactly 1 with values on .5 ties."""
    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(SEED + 21)
    zero = torch.randn(3, 128, generator=gen)
    zero[1] = 0.0
    halves = torch.arange(63, dtype=torch.float32) + 0.5
    xs = {
        "smoke_4Mi_fp32": torch.from_numpy(
            np.random.RandomState(4).randn(4 << 20).astype(np.float32)),
        "ragged_1000_fp32": 3.0 * torch.randn(1000, generator=gen),
        "3x12345_bf16": (5.0 * torch.randn(3, 12345, generator=gen)).to(
            torch.bfloat16),
        "zero_block_fp32": zero,
        "ties_fp32": torch.cat([torch.tensor([127.0, -127.0]), halves,
                                -halves]),
    }
    return {k: v.to(DEV) for k, v in xs.items()}


def quant_bound(x) -> dict:
    """Least time for one blockwise quantize of ``x``: read x once, write
    one int8 code an element (padded to whole blocks) and one fp32 scale
    a block; ``QUANT_OPS_PER_ELEMENT`` fp32 operations an element."""
    rows = -(-x.numel() // 128)
    nbytes = x.numel() * x.element_size() + rows * 128 + 4 * rows
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = QUANT_OPS_PER_ELEMENT * x.numel() / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def phase_quant(quant, counted) -> dict:
    """Phase 7; returns the record at the smoke shape."""
    import torch

    xs = quant_inputs()
    x = xs["smoke_4Mi_fp32"]
    torch.cuda.synchronize()
    reset_launches(*counted)
    codes, scale = quant.quantize_blockwise(x)
    back = quant.dequantize_blockwise(codes, scale, x.shape)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in counted}
    want = {w.__name__: 0 for w in counted}
    want["quantize_blockwise"] = 1
    if launches != want:
        raise SystemExit(f"quantize_blockwise path launches {launches}")
    err = float((back - x).abs().max())
    bound = float(x.abs().max()) / 254.0
    log(f"phase7 quant path: quantize_blockwise + dequantize_blockwise on "
        f"{x.numel()} fp32, round-trip max err {err:.6g} (bound "
        f"max|x|/254 * 1.01 = {bound * 1.01:.6g}), launches {launches}")
    if not err <= bound * 1.01:
        raise SystemExit(f"quant round trip {err} > {bound} * 1.01")

    rec = None
    for name, xi in xs.items():
        kc, ks = quant.quantize_blockwise(xi)
        pc, ps = quant.quantize_blockwise(xi, backend="plain")
        torch.cuda.synchronize()
        code_err = int((kc.int() - pc.int()).abs().max())
        scale_same = torch.equal(ks.view(torch.int32), ps.view(torch.int32))
        kb = quant.dequantize_blockwise(kc, ks, xi.shape)
        rt_err = float((kb - xi.float()).abs().max())
        rt_bound = float(xi.float().abs().max()) / 254.0 * 1.01
        if code_err != 0 or not scale_same or not rt_err <= rt_bound:
            raise SystemExit(
                f"quant kernel vs plain at {name}: max code diff "
                f"{code_err}, scales bit-equal {scale_same}, round trip "
                f"{rt_err} (bound {rt_bound})")
        row = {"input": name, "n": xi.numel(), "dtype": str(xi.dtype),
               "max_abs_err": float(max(code_err, float(
                   (ks - ps).abs().max()))),
               "tolerance": "codes equal, scales bit-equal",
               "roundtrip_err": rt_err, "roundtrip_bound": rt_bound,
               "ms": time_ms(lambda: quant.quantize_blockwise(xi)),
               "plain_ms": time_ms(lambda: quant.quantize_blockwise(
                   xi, backend="plain"), iters=50),
               "library_ms": None,
               "no_library_call": "no single PyTorch call computes "
                                  "per-block absmax int8 codes",
               **quant_bound(xi)}
        if name == "smoke_4Mi_fp32":
            # 16.8 MB fits the 50 MB L2: back-to-back calls on one input
            # read it from L2.  Rotating over 4 copies (67 MB) reads from
            # device memory, as a caller with a fresh tensor would.
            copies = [xi.clone() for _ in range(4)]
            turn = iter(range(1 << 30))
            row["ms_l2_hot"] = row["ms"]
            row["ms"] = time_ms(lambda: quant.quantize_blockwise(
                copies[next(turn) % 4]))
            row["plain_ms"] = time_ms(lambda: quant.quantize_blockwise(
                copies[next(turn) % 4], backend="plain"), iters=50)
            # Back-to-back calls are bound by the host's enqueue rate; the
            # profile gives the kernel's own device time.
            def forty_calls():
                for _ in range(40):
                    quant.quantize_blockwise(copies[next(turn) % 4])
                torch.cuda.synchronize()

            _, kernels, _ = step_profile(forty_calls, iters=40)
            row["device_us_per_launch"], _ = kernel_device_us(
                kernels, "quant_kernel")
            rec = row
        log("phase7 quant " + json.dumps(row))
    rec["launches"] = launches["quantize_blockwise"]
    return rec


def phase_adam8bit(llama, counted) -> dict:
    """Phase 8: Llama-800M-h128 trained with 8-bit Adam through
    ``accelerate``, the way the JAX package's bench measures its
    ``llama_800m_h128`` adam8bit candidate."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from dlrover_tpu_torch.optim import adam8bit
    from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate

    cfg = dataclasses.replace(llama.LlamaConfig.medium_800m(), n_head=12,
                              n_kv_head=12, remat_block=True)
    tokens = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, size=(A8_BATCH, A8_SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens}
    job = accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        init_fn=lambda g: llama.init_params(cfg, g, DEV,
                                            param_dtype=torch.float32),
        optimizer=adam8bit(3e-4), sample_batch=batch, strategy=Strategy(),
        device=DEV)
    state = job.create_state(torch.Generator(device=DEV).manual_seed(SEED))
    opt = state["opt_state"]
    n_params = llama.num_params(state["params"])

    # Device time of each optimizer step, from CUDA events around it.
    opt_events = []
    opt_step = opt.step

    def timed_opt_step(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = opt_step(*a, **k)
        e1.record()
        opt_events.append((e0, e1))
        return out

    opt.step = timed_opt_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*counted)
    losses, step_ms = [], []
    for _ in range(A8_STEPS):
        t0 = time.perf_counter()
        state, m = job.train_step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = {w.__name__: w.launches for w in counted}
    peak = torch.cuda.max_memory_allocated()
    opt_ms = [e0.elapsed_time(e1) for e0, e1 in opt_events]
    L, n = cfg.n_layer, A8_STEPS
    # Block remat recomputes each block's forward (its attention and
    # both norms) in the backward; the final norm is not recomputed.
    want = {"flash_fwd": 2 * L * n, "flash_dq": L * n, "flash_dkv": L * n,
            "rmsnorm": (4 * L + 1) * n, "xent_fwd": 0,
            "quantize_blockwise": 0}
    if counts != want:
        raise SystemExit(f"adam8bit training launches {counts} != {want}")
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise SystemExit(f"adam8bit training loss did not fall: {losses}")
    steady = statistics.median(step_ms[1:])
    tok_s = A8_BATCH * A8_SEQ / (steady / 1e3)
    state_bytes = opt.state_bytes()
    res = {"model": f"medium_800m, n_head=n_kv_head={cfg.n_head} "
                    f"(head_dim {cfg.head_dim}), remat_block",
           "n_layer": L, "d_model": cfg.d_model,
           "head_dim": cfg.head_dim, "params": n_params, "batch": A8_BATCH,
           "seq_len": A8_SEQ, "steps": n, "losses": losses,
           "step_ms": step_ms, "step_ms_median_2_on": steady,
           "tokens_per_s": tok_s,
           "flops_per_token": llama.flops_per_token(cfg),
           "mfu": llama.flops_per_token(cfg) * tok_s / BF16_FLOPS_PER_S,
           "peak_mem_gib": peak / 2 ** 30,
           "opt_state_bytes": state_bytes,
           "adamw_state_bytes": 8 * n_params,
           "opt_step_device_ms": opt_ms,
           "launches": counts,
           "launches_per_step": {k: v / n for k, v in counts.items()}}

    def run():
        _, m2 = job.train_step(state, batch)
        float(m2["loss"])
        torch.cuda.synchronize()

    prof, kernels, events = step_profile(run)
    prof["tensor_core_launches_per_step"] = tensor_core_launches(
        kernels, 1, {"flash_fwd_wgmma": 2 * L, "flash_dq_wgmma": L,
                     "flash_dkv_wgmma": L}, "adam8bit training profile")
    prof["flash_device_us_per_launch"] = {
        name: kernel_device_us(kernels, name)[0] for name in TC_FLASH}
    e0, e1 = opt_events[-1]
    prof["adam8bit_step_device_ms"] = e0.elapsed_time(e1)
    # The kernels under the optimizer's own profiler annotation.
    prof["adam8bit_step_kernels_ms"] = sum(
        e.device_time_total for e in events
        if e.device_type == DeviceType.CPU and "Adam8bit.step" in e.key) / 1e3
    res["profile"] = prof
    log("phase8 adam8bit train " + json.dumps(res))
    del state, job, opt
    torch.cuda.empty_cache()
    return res


def kernel_record(name, source, replaces, launches, rec) -> dict:
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}
    if "design" in rec:
        out["design"] = rec["design"]
    if "no_library_call" in rec:
        out["no_library_call"] = rec["no_library_call"]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; run it on the GPU machine",
              file=sys.stderr)
        return 2
    from dlrover_tpu_torch import train
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.models import llama_infer as infer
    from dlrover_tpu_torch.ops import cross_entropy as xent
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quant
    from dlrover_tpu_torch.ops import rmsnorm as rms

    counted = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv, xent.xent_fwd,
               rms.rmsnorm, quant.quantize_blockwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"build: {build_kernels([rms, fa, xent, quant]):.1f}s")

    rec = phase_kernels(rms)

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    log(f"llama2_7b params on card: {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    phase_forward(llama, infer, params, cfg)
    served = phase_serve(infer, rms, params, cfg, counted)
    del params
    torch.cuda.empty_cache()

    flash = phase_flash()
    xrec = phase_xent()
    phase_train_parity(llama, train, counted)
    trained = phase_train(llama, train, counted)
    qrec = phase_quant(quant, counted)
    phase_adam8bit(llama, counted)

    fa_src = "dlrover_tpu_torch/ops/csrc/flash_attention.cu"
    fa_ref = "dlrover_tpu/ops/flash_attention.py"
    kernels = [
        kernel_record("rmsnorm", "dlrover_tpu_torch/ops/csrc/rmsnorm.cu",
                      "dlrover_tpu/ops/rmsnorm.py:25",
                      served["rmsnorm_launches"], rec),
        kernel_record("flash_fwd", fa_src, f"{fa_ref}:105",
                      trained["launches"]["flash_fwd"], flash["fwd"]),
        kernel_record("flash_dq", fa_src, f"{fa_ref}:296",
                      trained["launches"]["flash_dq"], flash["dq"]),
        kernel_record("flash_dkv", fa_src, f"{fa_ref}:367",
                      trained["launches"]["flash_dkv"], flash["dkv"]),
        kernel_record("xent_fwd", "dlrover_tpu_torch/ops/csrc/"
                      "cross_entropy.cu", "dlrover_tpu/ops/cross_entropy.py"
                      ":25", trained["tiny"]["launches"]["xent_fwd"], xrec),
        kernel_record("quant_blockwise", "dlrover_tpu_torch/ops/csrc/"
                      "quant.cu", "dlrover_tpu/ops/quant.py:41",
                      qrec["launches"], qrec),
    ]
    # library_ms may be null only in a record that says why no PyTorch
    # call computes the function.
    if not all(math.isfinite(k[f]) for k in kernels
               for f in ("ms", "plain_ms", "bound_ms")) or not all(
            math.isfinite(k["library_ms"]) if k["library_ms"] is not None
            else bool(k.get("no_library_call")) for k in kernels):
        raise SystemExit("a kernel time is not finite")
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the path was never launched")
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
