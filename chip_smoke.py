#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``dlrover_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

It builds every CUDA kernel of the port's serving and training paths from
the sources in this checkout (one ``nvcc`` per source, all started
together), then runs the phases below and exits non-zero if any fails:

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
   of mixed lengths through the Llama-2-7B model, its decode step one CUDA
   graph replay a round.  Every kernel's launch count is reset just before
   and read just after.  RMSNorm's launches are the wrapper's count (the
   eager prefills: 65 a forward, 2 per block + the final norm) plus the
   graph's recorded nodes (65 x K, counted during its capture) times its
   replays, one a round.
3b. Serving slice 2 (run after phase 9, on the same 7B weights made again
   from the seed) on the same requests (12 of 16-200 tokens,
   32 new tokens, 8 slots, max_len 512): seven servers, slotted and paged
   (blocks of 16), K = 1 and 8 tokens a dispatch, bf16 and int8 KV, and a
   paged pool too tight for every request (it must preempt).  Each captures
   its decode dispatch in a warm-up call, then serves; its RMSNorm
   launches are counted as in phase 3, and a profile of the replays (5 at
   K 1, 1 at K 8) must show 65 x K ``rmsnorm_fwd_kernel`` launches a
   replay, less at most 1 % that the profiler lost.  One replay of the K=1
   step against an eager ``forward_step`` on a copy of the same cache:
   logits within 1e-3 relative (bit-equal expected).  Greedy outputs equal
   across K 1 and 8, slotted and paged (tight pool included); int8 with
   K 8 and paging equals int8 K 1 slotted; the int8 cache's prefill logits
   within 0.05 of the dense cache's span through two 7B blocks in bf16 and
   fp32 (the reference test's bound and depth; all 32 blocks reported).  Per variant: tokens/s, TTFT p50
   and max, the dispatch eagerly and replayed (a step = a dispatch / K),
   the busy share of a replay, peak memory, the KV bytes and, paged, the
   peak blocks in use; its record is one line ``phase3b serve {...}``
   before the kernel line.
3c. Prefix caching and the KV-segment handoff (run after phase 9, just
   before 3b, on the same 7B weights made again from the seed): 3b's 12
   requests behind one shared 256-token prefix (combined 272-456 tokens,
   above the 256 bucket, so the template path engages), served three ways
   (``serve`` of the combined prompts, first and again last, between them
   ``serve(shared_prefix=)`` and ``submit(prefix_len=256)`` into
   ``serve_incremental``), slotted and paged (blocks of 16): greedy
   outputs equal token for token across all eight runs; each templated run admits all 12 from one template prefill (the
   store: 1 miss, 11 hits); RMSNorm launches counted as in phase 3, the
   template prefills included.  Per run: tokens/s, TTFT p50 and max,
   prefill forwards a request, the template's build time, hits and misses,
   peak blocks and blocks shared (paged).  Then the handoff, slotted
   bf16, slotted int8 and paged bf16 (a block list): a prefill server
   runs ``prefill_request`` + ``export_kv`` for one request each turn of
   a decode server's ``serve_incremental``, which ``import_kv``s it; the
   streams equal that server serving the requests in place; the RMSNorm
   launches are 65 a prefill forward on the prefill server and the graph's
   nodes on the decode server.  Per variant: payload bytes against fp32
   bytes, prefill, export (pack), unpack and import ms, and TTFT through
   the handoff beside the in-place TTFT; lines ``phase3c prefix {...}``,
   ``phase3c handoff {...}`` and ``phase3c prefix_handoff {...}``.
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
   launches and no bf16 instance of a CUDA-core flash kernel, and the
   RMSNorm kernel at that step's shape ([8192, 1536] bf16): its device
   time a launch from the profile, the call and ``F.rms_norm`` in turns,
   its byte bound; (c) the tiny model's training through the
   cross-entropy kernel, one launch per step.
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
   kernel.  Then its state goes through ``FlashCheckpointer`` (to memory,
   then to storage), is restored into a freshly built state and held bit
   for bit (the fp32 masters, the int8 codes, their scales, the step count
   and the rounding generator), and one more step of each gives bit-equal
   losses and states.
9. Flash checkpoint: Llama-800M with AdamW (full width and depth, B 4 x S
   2048) through ``train.main --ckpt_dir``: two uninterrupted runs of 3
   steps agree bit for bit (else the op that is not deterministic is
   named); a run stops after step 2 and its save; a child process
   (``python -m dlrover_tpu_torch.train``) restores it from the shm arena
   (warm), another from storage alone (cold), and each trains step 3,
   whose loss and resulting state (every tensor's CRC-32) must equal the
   uninterrupted run's, through the flash and RMSNorm kernels.  fsck finds
   the directory clean; a byte flipped in a tensor of the newest step is
   reported, quarantined by ``load`` and the older step restored.  The
   stall (device-to-host and arena copy), the persist, the restores, the
   bytes and ``torch.save`` of the same state beside the card's name and
   power limit on a line ``phase9 checkpoint {...}``.

The lines before the last give the kernels' record as JSON and the card's
name and power limit; the last line is the device record the driver reads.
On a host without CUDA, or without the repository beside it, it fails and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
CKPT_MODEL = "800m"  # phase 9
CKPT_K = 2  # phase 9: the interrupted run stops after step K
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
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
    launches = graph_launch_check(srv, rms, launches, cfg, "phase3")
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


# Phase 3b: the decode dispatch as one CUDA graph, chunked, int8, paged.
SERVE_VARIANTS = (
    ("slotted_k1", {}),
    ("slotted_k8", {"decode_chunk": 8}),
    ("paged_k1", {"paged": True}),
    ("paged_k8", {"paged": True, "decode_chunk": 8}),
    ("paged_k8_tight", {"paged": True, "decode_chunk": 8, "tight": True}),
    ("int8_k1", {"quant_kv": True}),
    ("int8_paged_k8", {"quant_kv": True, "paged": True, "decode_chunk": 8}),
)
SERVE_REQUESTS, SERVE_MNT, SERVE_SLOTS, SERVE_MAX_LEN = 12, 32, 8, 512
BLOCK = 16


def serve_prompts(cfg):
    """Phase 3's seeded requests: 12 prompts of 16-200 tokens."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, 201, size=SERVE_REQUESTS)
    return [rng.randint(1, cfg.vocab_size, size=(int(n),)).astype(np.int32)
            for n in lens]


def tight_pool(prompts) -> int:
    """Blocks for the first ``SERVE_SLOTS`` requests at 70 % of their final
    length: too few for all of them to grow to the end, so the pool
    preempts; still more than the largest request needs alone."""
    need = sum(-(-(len(p) + SERVE_MNT + 7) // BLOCK)
               for p in prompts[:SERVE_SLOTS])
    largest = max(-(-(len(p) + SERVE_MNT + 7) // BLOCK) for p in prompts)
    return max(largest, int(0.7 * need))


def graph_vs_eager(infer, srv, params, cfg) -> dict:
    """One replay of the server's captured K=1 step against an eager
    ``forward_step`` on a copy of the same cache, offsets and tokens (every
    slot active)."""
    import torch

    with torch.inference_mode():
        srv._act.fill_(True)
        snap = [{k: t.clone() for k, t in lay.items()} for lay in srv._kv]
        off, toks = srv._off.clone(), srv._toks.clone()
        srv.decode_graph()
        got = srv._logits.clone()
        ref, _ = infer.forward_step(params, toks[:, None], cfg,
                                    {"layers": snap, "offset": off})
        ref = ref[:, -1, :]
        torch.cuda.synchronize()
    diff = float((got - ref).abs().max())
    rel = diff / float(ref.abs().max())
    res = {"max_abs_diff": diff, "rel": rel,
           "bit_equal": bool(torch.equal(got, ref)),
           "tokens_equal": bool(torch.equal(got.argmax(-1),
                                            ref.argmax(-1)))}
    del snap
    if not rel <= 1e-3:
        raise SystemExit(f"phase3b graph replay vs eager step: {res}")
    return res


def int8_vs_dense(infer, params, cfg, prompt, n_layer: int) -> dict:
    """Prefill logits of the int8 cache against the dense cache's, as
    ``max|d| / span`` (span = max|dense logit|), the measure of the
    reference's ``test_quant_prefill_and_decode_logits_close`` (bound
    0.05 on a 2-layer fp32 model), through the first ``n_layer`` blocks:
    in bf16, and in fp32 on the same weights; and beside them the bf16
    dense cache's own distance from the fp32 one."""
    import torch

    cfg = dataclasses.replace(cfg, n_layer=n_layer)
    params = dict(params, layers=params["layers"][:n_layer])

    toks = torch.from_numpy(prompt.astype("int64")).to(DEV)[None]
    p32 = to_device(params, torch.float32)  # Tensor.to takes a dtype too
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    logits = {}
    with torch.inference_mode():
        for name, (p, c) in (("bf16", (params, cfg)), ("fp32", (p32, cfg32))):
            for quant in (False, True):
                cache = infer.init_cache(c, 1, len(prompt), device=DEV,
                                         quant_kv=quant)
                logits[name, quant] = infer.forward_step(p, toks, c,
                                                         cache)[0].float()
    del p32

    def ratio(a, b):
        return float((a - b).abs().max() / b.abs().max())

    res = {"prompt_len": len(prompt), "n_layer": n_layer,
           "bf16_int8_vs_dense": ratio(logits["bf16", True],
                                       logits["bf16", False]),
           "fp32_int8_vs_dense": ratio(logits["fp32", True],
                                       logits["fp32", False]),
           "bf16_dense_vs_fp32_dense": ratio(logits["bf16", False],
                                             logits["fp32", False]),
           "bf16_int8_vs_fp32_dense": ratio(logits["bf16", True],
                                            logits["fp32", False])}
    return res


def serve_variant(infer, rms, params, cfg, prompts, name, kw) -> tuple:
    """Serve the 12 requests through one server variant (graph captured in
    a warm-up call first); returns (record, outputs)."""
    import numpy as np
    import torch

    kw = dict(kw)
    if kw.pop("tight", False):
        kw["pool_blocks"] = tight_pool(prompts)
    srv = infer.DecodeServer(params, cfg, slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN, seed=SEED,
                             block_size=BLOCK, **kw)
    srv.serve(prompts[:2], 4)  # warm-up: captures the decode graph
    graph = srv.decode_graph
    first: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(rms.rmsnorm)
    t0 = time.perf_counter()
    outs = srv.serve(prompts, SERVE_MNT, on_token=lambda rid, _t:
                     first.setdefault(rid, time.perf_counter() - t0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = dict(srv.last_stats)
    launches = graph_launch_check(srv, rms, rms.rmsnorm.launches, cfg,
                                  f"phase3b {name}")
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + SERVE_MNT or not np.array_equal(o[:len(p)], p)\
                or o.min() < 0 or o.max() >= cfg.vocab_size:
            raise SystemExit(f"phase3b {name}: bad output for a {len(p)}-"
                             "token prompt")
    K = srv.decode_chunk
    new_tokens = sum(len(o) - len(p) for o, p in zip(outs, prompts))
    rec = {
        "variant": name, "decode_chunk": K, "paged": srv.paged,
        "quant_kv": srv.quant_kv, "new_tokens": new_tokens,
        "serve_s": wall, "tokens_per_s": new_tokens / wall,
        "ttft_p50_ms": 1e3 * statistics.median(first.values()),
        "ttft_max_ms": 1e3 * max(first.values()),
        "rounds": st["rounds"], "graph_replays": st["graph_replays"],
        "prefills": st["prefills"], "forwards": st["forwards"],
        "rmsnorm_launches": launches,
        "rmsnorm_launches_eager": rms.rmsnorm.launches,
        "rmsnorm_recorded_per_replay": graph.recorded["rmsnorm"],
        "capture_s": graph.capture_s, "peak_mem_gib": peak / 2 ** 30,
        "kv_bytes": sum(t.numel() * t.element_size()
                        for lay in srv._kv for t in lay.values()),
        "preemptions": srv.preemptions,
    }
    if srv.paged:
        rec.update(pool_blocks=srv.pool_blocks,
                   peak_blocks=st["peak_blocks"],
                   block_stats=srv.block_stats())
    if name == "slotted_k1":
        rec["graph_vs_eager"] = graph_vs_eager(infer, srv, params, cfg)

    # The dispatch eagerly and replayed, every slot at offset 200 and
    # inactive (the same work; the offsets stay put), in turns.
    with torch.inference_mode():
        srv._act.zero_()
        srv._off.fill_(200)
        if srv.paged:
            mb = srv.kv_arena.max_blocks
            srv._table.copy_(torch.arange(SERVE_SLOTS * mb, device=DEV)
                             .view(SERVE_SLOTS, mb) % srv.pool_blocks)
        iters = max(4, 32 // K)
        ms = {"eager": [], "replay": []}
        for which in ("eager", "replay", "replay", "eager"):
            fn = srv._dispatch if which == "eager" else graph.graph.replay
            ms[which].append(time_ms(fn, iters=iters, warmup=2))

        n_prof = 5 if K == 1 else 1

        def replays():
            for _ in range(n_prof):
                graph.graph.replay()
            torch.cuda.synchronize()

        replays()
        busy, kernels, _ = step_profile(replays, iters=n_prof, top=6)
    norm_us, norm_n = kernel_device_us(kernels, "rmsnorm_fwd_kernel")
    want = n_prof * (2 * cfg.n_layer + 1) * K
    # The exact count is the capture's (graph_launch_check).  The profile
    # shows the kernel nodes running, but the profiler can lose records:
    # the first kernel of its window, and a few of the ~10^5 in a window
    # of five K = 8 replays (seen on the card).  Up to 1 % short passes;
    # the count is kept.
    if not want - max(1, want // 100) <= norm_n <= want:
        raise SystemExit(f"phase3b {name}: the profile of {n_prof} "
                         f"replay(s) shows {norm_n} rmsnorm_fwd_kernel "
                         f"launches, want {want}")
    busy["rmsnorm_launches_profiled"] = [norm_n, want]
    busy["rmsnorm_device_us_per_launch"] = norm_us
    rec.update(dispatch_ms_eager=ms["eager"], dispatch_ms_replay=ms["replay"],
               step_ms_eager=statistics.median(ms["eager"]) / K,
               step_ms_replay=statistics.median(ms["replay"]) / K,
               replay_profile=busy)
    log(f"phase3b {name} " + json.dumps(
        {k: v for k, v in rec.items() if k != "replay_profile"}
        | {k: busy[k] for k in ("device_ms", "device_busy_share",
                                "kernels")}))
    del srv, graph
    gc.collect()  # the server and its graph's bound dispatch form a cycle
    torch.cuda.empty_cache()
    return rec, outs


def phase_serve_graph(infer, rms, params, cfg) -> dict:
    """Phase 3b: the graphed decode dispatch, chunked and paged, bf16 and
    int8, against each other token for token."""
    import numpy as np

    prompts = serve_prompts(cfg)
    res = {"requests": len(prompts), "max_new_tokens": SERVE_MNT,
           "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
           "block_size": BLOCK, "variants": []}
    outs = {}
    for name, kw in SERVE_VARIANTS:
        rec, outs[name] = serve_variant(infer, rms, params, cfg, prompts,
                                        name, kw)
        res["variants"].append(rec)
    for name, ref in (("slotted_k8", "slotted_k1"), ("paged_k1", "slotted_k1"),
                      ("paged_k8", "slotted_k1"),
                      ("paged_k8_tight", "slotted_k1"),
                      ("int8_paged_k8", "int8_k1")):
        same = [bool(np.array_equal(a, b))
                for a, b in zip(outs[name], outs[ref])]
        if not all(same):
            raise SystemExit(f"phase3b: {name} differs from {ref} on "
                             f"requests {[i for i, s in enumerate(same) if not s]}")
    tight = [r for r in res["variants"] if r["variant"] == "paged_k8_tight"]
    if not tight[0]["preemptions"] > 0:
        raise SystemExit("phase3b: the tight pool preempted nothing")
    # The reference holds the int8 cache within 0.05 of the dense cache's
    # logit span on a 2-layer model; here at the 7B's width and two
    # blocks, in bf16 and fp32.  Through all 32 random blocks the distance
    # grows with depth (the bf16 dense cache's own distance from fp32
    # passes 0.05 there too), so the full depth is reported, not held.
    res["int8_vs_dense"] = [
        int8_vs_dense(infer, params, cfg, prompts[0], n)
        for n in (2, cfg.n_layer)]
    held = res["int8_vs_dense"][0]
    if not max(held["bf16_int8_vs_dense"],
               held["fp32_int8_vs_dense"]) < 0.05:
        raise SystemExit(f"phase3b int8 vs dense prefill logits: {held}")
    res["int8_agrees_with_bf16_tokens"] = sum(
        bool(np.array_equal(a, b))
        for a, b in zip(outs["int8_k1"], outs["slotted_k1"]))
    return res


# Phase 3c: prefix caching and the prefill/decode KV-segment handoff.
PREFIX_LEN = 256  # above the largest bucket once a request's own tokens join
# The untemplated serve runs first and last on each layout, so that host
# drift across the run shows beside the template's effect.
PREFIX_HOWS = ("concat", "shared_prefix", "submit", "concat")
HANDOFF_VARIANTS = (("slotted", {}), ("int8", {"quant_kv": True}),
                    ("paged", {"paged": True}))


def serve_all(srv, how, prompts, prefix, on_token) -> list:
    """Serve the requests behind ``prefix`` one of three ways: ``serve`` of
    the combined prompts, ``serve(shared_prefix=)``, or ``submit(
    prefix_len=)`` into ``serve_incremental``; the outputs in order."""
    import numpy as np

    full = [np.concatenate([prefix, p]) for p in prompts]
    if how == "concat":
        return srv.serve(full, SERVE_MNT, on_token=on_token)
    if how == "shared_prefix":
        return srv.serve(prompts, SERVE_MNT, on_token=on_token,
                         shared_prefix=prefix)
    for i, p in enumerate(full):
        srv.submit(i, p, SERVE_MNT, prefix_len=len(prefix))
    got: dict = {}
    srv.serve_incremental(
        tick=lambda: bool(srv.pending_count() or srv.active_rids()),
        on_finish=lambda r, t: got.__setitem__(r, t), on_token=on_token)
    return [got[i] for i in range(len(full))]


def prefix_variant(infer, rms, params, cfg, prompts, prefix, layout, how,
                   kw) -> tuple:
    """One server (graph captured in a warm-up call without the prefix)
    serving the 12 requests behind the shared prefix; returns (record,
    outputs)."""
    import numpy as np
    import torch

    srv = infer.DecodeServer(params, cfg, slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN, seed=SEED,
                             block_size=BLOCK, **kw)
    srv.serve(prompts[:2], 4)  # warm-up: captures the decode graph
    first: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(rms.rmsnorm)
    t0 = time.perf_counter()
    outs = serve_all(srv, how, prompts, prefix, lambda rid, _t:
                     first.setdefault(rid, time.perf_counter() - t0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(srv.last_stats)
    what = f"phase3c {layout} {how}"
    launches = graph_launch_check(srv, rms, rms.rmsnorm.launches, cfg, what)
    P0 = len(prefix)
    for p, o in zip(prompts, outs):
        if len(o) != P0 + len(p) + SERVE_MNT or \
                not np.array_equal(o[:P0], prefix) or \
                not np.array_equal(o[P0:P0 + len(p)], p) or \
                o.min() < 0 or o.max() >= cfg.vocab_size:
            raise SystemExit(f"{what}: bad output for a {len(p)}-token "
                             "request")
    templated = how != "concat"
    if templated and not (st["templated"] == len(prompts)
                          and st["template_forwards"] == 1):
        raise SystemExit(f"{what}: {st['templated']} templated admissions "
                         f"of {len(prompts)}, {st['template_forwards']} "
                         "template prefills (want 1)")
    new_tokens = sum(len(o) - P0 - len(p) for o, p in zip(outs, prompts))
    prefill_fwd = st["forwards"] - srv.decode_chunk * st["rounds"]
    rec = {
        "layout": layout, "how": how, "new_tokens": new_tokens,
        "serve_s": wall, "tokens_per_s": new_tokens / wall,
        "ttft_p50_ms": 1e3 * statistics.median(first.values()),
        "ttft_max_ms": 1e3 * max(first.values()),
        "rounds": st["rounds"], "prefills": st["prefills"],
        "prefill_forwards": prefill_fwd,
        "template_forwards": st["template_forwards"],
        "prefill_forwards_per_request": (
            (prefill_fwd + st["template_forwards"]) / len(prompts)),
        "templated": st["templated"], "rmsnorm_launches": launches,
        "rmsnorm_launches_eager": rms.rmsnorm.launches,
        "prefix_hits": srv.prefix_hits, "prefix_misses": srv.prefix_misses,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    if how == "submit" and not (srv.prefix_misses == 1 and
                                srv.prefix_hits == len(prompts) - 1):
        raise SystemExit(f"{what}: {srv.prefix_hits} hits, "
                         f"{srv.prefix_misses} misses")
    if srv.paged:
        rec.update(peak_blocks=st["peak_blocks"],
                   shared_blocks=st["shared_blocks"])
    if how == "shared_prefix":
        # The template's build alone (one 256-token forward into a fresh
        # 1-row cache), warm, by the host clock around a synchronize.
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            srv._template_layers(prefix)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
        rec["template_build_ms"] = ms
    log(f"phase3c prefix {json.dumps(rec)}")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return rec, outs


def handoff_variant(infer, rms, params, cfg, prompts, name, kw) -> dict:
    """A prefill server runs ``prefill_request`` + ``export_kv`` for each
    request, a second server ``import_kv`` and decodes, one request handed
    off each turn of its loop; its streams must equal the second server
    serving the requests in place.  TTFT through the handoff runs from a
    request's prefill to its first token out of the decode server."""
    import numpy as np
    import torch

    dec = infer.DecodeServer(params, cfg, slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN, seed=SEED,
                             block_size=BLOCK, **kw)
    dec.serve(prompts[:2], 4)  # warm-up: captures the decode graph
    in_place: dict = {}
    t0 = time.perf_counter()
    ref = dec.serve(prompts, SERVE_MNT, on_token=lambda rid, _t:
                    in_place.setdefault(rid, time.perf_counter() - t0))
    torch.cuda.synchronize()
    pf = infer.DecodeServer(params, cfg, slots=1, max_len=SERVE_MAX_LEN,
                            seed=SEED, block_size=BLOCK, **kw)
    pf.prefill_request("warm", prompts[0], SERVE_MNT)  # cuBLAS plans
    pf.export_kv("warm")
    reset_launches(rms.rmsnorm)
    fwd0 = pf.prefill_forwards
    times = {"prefill_ms": [], "export_ms": [], "unpack_ms": [],
             "import_ms": []}
    sizes = []
    start: dict = {}
    first: dict = {}
    todo = list(range(len(prompts)))

    def hand_off() -> bool:
        """One request a loop turn: prefill it on the prefill server, ship
        its segment, import it here (it is admitted in the same turn)."""
        if todo:
            i = todo.pop(0)
            p = prompts[i]
            start[i] = t1 = time.perf_counter()
            pf.prefill_request(i, p, SERVE_MNT)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            payload, fp32_bytes = pf.export_kv(i)
            t3 = time.perf_counter()
            dec.import_kv(i, payload, p, SERVE_MNT)
            t4 = time.perf_counter()
            times["prefill_ms"].append(1e3 * (t2 - t1))
            times["export_ms"].append(1e3 * (t3 - t2))
            times["import_ms"].append(1e3 * (t4 - t3))
            sizes.append((len(p), len(payload), fp32_bytes))
        return bool(todo or dec.pending_count() or dec.active_rids())

    got: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.serve_incremental(
        tick=hand_off, on_finish=lambda r, t: got.__setitem__(r, t),
        on_token=lambda rid, _t: first.setdefault(
            rid, time.perf_counter() - start[rid]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(dec.last_stats)
    prefill_fwd = pf.prefill_forwards - fwd0
    per_fwd = 2 * cfg.n_layer + 1
    eager = rms.rmsnorm.launches
    if prefill_fwd < len(prompts) or st["imported"] != len(prompts) or \
            st["prefills"] != 0:
        raise SystemExit(f"phase3c handoff {name}: {prefill_fwd} prefill "
                         f"forwards, {st['imported']} imports, "
                         f"{st['prefills']} decode-side prefills")
    # The prefill server's forwards launch the kernel eagerly; the decode
    # server runs no forward of its own and only replays its graph.
    recorded = dec.decode_graph.recorded.get("rmsnorm", 0)
    if eager != per_fwd * prefill_fwd or \
            recorded != per_fwd * dec.decode_chunk or \
            st["graph_replays"] != st["rounds"] or st["rounds"] == 0:
        raise SystemExit(
            f"phase3c handoff {name}: rmsnorm launches: {eager} eager (want "
            f"{per_fwd} x {prefill_fwd} prefill forwards), {recorded} "
            f"recorded a replay, {st['graph_replays']} replays for "
            f"{st['rounds']} rounds")
    decode = recorded * st["graph_replays"]
    bad = [i for i, r in enumerate(ref) if not np.array_equal(got[i], r)]
    if bad:
        raise SystemExit(f"phase3c handoff {name}: requests {bad} differ "
                         "from the same server serving them in place")
    # Unpack alone, on the largest request's segment.
    big = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    pf.prefill_request("big", prompts[big], SERVE_MNT)
    payload, _ = pf.export_kv("big")
    for _ in range(3):
        t1 = time.perf_counter()
        infer.unpack_kv_segment(payload)
        times["unpack_ms"].append(1e3 * (time.perf_counter() - t1))
    pay = sum(s[1] for s in sizes)
    f32 = sum(s[2] for s in sizes)
    n_big, b_big, f_big = sizes[big]
    rec = {
        "variant": name, "requests": len(prompts),
        "payload_bytes": pay, "fp32_bytes": f32,
        "payload_vs_fp32": pay / f32,
        "largest": {"tokens": n_big, "payload_bytes": b_big,
                    "fp32_bytes": f_big},
        **{k: {"median": statistics.median(v), "max": max(v)}
           for k, v in times.items()},
        "handoff_s": wall, "tokens_per_s": len(prompts) * SERVE_MNT / wall,
        "ttft_p50_ms": 1e3 * statistics.median(first.values()),
        "ttft_max_ms": 1e3 * max(first.values()),
        "in_place_ttft_p50_ms": 1e3 * statistics.median(in_place.values()),
        "in_place_ttft_max_ms": 1e3 * max(in_place.values()),
        "prefill_forwards": prefill_fwd,
        "rmsnorm_launches_prefill": per_fwd * prefill_fwd,
        "rmsnorm_launches_decode": decode,
        "streams_equal_in_place": len(prompts),
    }
    log(f"phase3c handoff {json.dumps(rec)}")
    del dec, pf
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_prefix_handoff(infer, rms, params, cfg) -> dict:
    """Phase 3c: phase 3b's 12 requests behind a shared 256-token prefix,
    served three ways, slotted and paged, all greedy-equal; then the
    KV-segment handoff, slotted bf16, slotted int8 and paged (a block
    list), equal to serving in place."""
    import numpy as np

    prompts = serve_prompts(cfg)
    prefix = np.random.RandomState(SEED + 1).randint(
        1, cfg.vocab_size, size=PREFIX_LEN).astype(np.int32)
    res = {"requests": len(prompts), "prefix_len": PREFIX_LEN,
           "max_new_tokens": SERVE_MNT, "slots": SERVE_SLOTS,
           "max_len": SERVE_MAX_LEN, "block_size": BLOCK, "prefix": [],
           "handoff": []}
    outs = {}
    for layout, kw in (("slotted", {}), ("paged", {"paged": True})):
        for turn, how in enumerate(PREFIX_HOWS):
            rec, outs[layout, turn, how] = prefix_variant(
                infer, rms, params, cfg, prompts, prefix, layout, how, kw)
            rec["turn"] = turn
            res["prefix"].append(rec)
    ref = outs["slotted", 0, "concat"]
    for key, got in outs.items():
        bad = [i for i, (a, b) in enumerate(zip(got, ref))
               if not np.array_equal(a, b)]
        if bad:
            raise SystemExit(f"phase3c {key}: requests {bad} differ from "
                             "the slotted serve of the combined prompts")
    for name, kw in HANDOFF_VARIANTS:
        res["handoff"].append(handoff_variant(infer, rms, params, cfg,
                                              prompts, name, kw))
    return res


def graph_launch_check(srv, rms, eager, cfg, what: str) -> int:
    """The RMSNorm launches of a serve run on the card: ``eager`` (the
    wrapper's count: prefills, template prefills and any graph warm-up,
    which run eagerly)
    plus the graph's recorded nodes times its replays.  Fails unless the
    capture recorded (2L+1) x K launches, the eager count is (2L+1) x the
    eager forwards and each decode round was one replay.  Returns the
    total."""
    st = srv.last_stats
    K = srv.decode_chunk
    per_fwd = 2 * cfg.n_layer + 1
    recorded = srv.decode_graph.recorded.get("rmsnorm", 0)
    replays = st["graph_replays"]
    eager_fwd = st["forwards"] - K * replays + st["graph_warmup_forwards"] \
        + st["template_forwards"]
    if recorded != per_fwd * K or replays != st["rounds"] or \
            eager != per_fwd * eager_fwd or eager == 0:
        raise SystemExit(
            f"{what}: rmsnorm launches: {eager} eager (want {per_fwd} x "
            f"{eager_fwd}), {recorded} recorded a replay (want {per_fwd} "
            f"x {K}), {replays} replays for {st['rounds']} rounds"
        )
    return eager + recorded * replays


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
    stats = parse_train_output(out)
    stats["counts"] = {w.__name__: w.launches for w in counted}
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return stats


def parse_train_output(out: str) -> dict:
    """The fields of a training run's ``TRAIN_DONE`` line, its
    ``CKPT_STATS`` (``ckpt``), its ``restored step=`` lines (``restored``)
    and the stall of each save to memory (``memory_save_stall_ms``)."""
    lines = out.splitlines()
    done = [ln for ln in lines if ln.startswith("TRAIN_DONE")]
    stats = dict(kv.split("=", 1) for kv in done[-1].split()[1:])
    ckpt = [ln for ln in lines if ln.startswith("CKPT_STATS ")]
    if ckpt:
        stats["ckpt"] = json.loads(ckpt[-1].split(" ", 1)[1])
    stats["restored"] = [ln for ln in lines if "restored step=" in ln]
    stats["memory_save_stall_ms"] = [
        float(ln.split("(stall ")[1].split()[0]) for ln in lines
        if "to memory (stall " in ln]
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


def rmsnorm_train_row(kernels, cfg) -> dict:
    """RMSNorm at the 800M training shape ([B·S, d_model] bf16, fp32 gain):
    the device time a launch from the profiled step's kernels, the call
    and ``F.rms_norm`` in turns (CUDA events), the plain version, the byte
    bound (the rows read and written once, the gain read once) and the
    kernel against the plain version (1 bf16 ulp)."""
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import rmsnorm as rms

    rows, D, eps = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.rms_eps
    gen = torch.Generator(device=DEV).manual_seed(SEED + 31)
    x = (torch.randn(rows, D, generator=gen, device=DEV) * 2.0).to(
        torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(D, generator=gen, device=DEV)
    ref = rms._reference(x, w, eps)
    err = (rms.rmsnorm(x, w, eps=eps).double() - ref.double()).abs()
    if not bool((err <= bf16_ulp(ref)).all()):
        raise SystemExit(f"rmsnorm kernel disagrees with plain at {rows}x{D}"
                         f": max err {float(err.max())}")
    w_lib = w.to(torch.bfloat16)
    turns = time_turns({
        "kernel": lambda: rms.rmsnorm(x, w, eps=eps),
        "library": lambda: F.rms_norm(x, (D,), w_lib, eps),
    }, pairs=2, iters=200)
    device_us, launches = kernel_device_us(kernels, "rmsnorm_fwd_kernel")
    nbytes = 2 * rows * D * x.element_size() + 4 * D
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"rows": rows, "d": D, "dtype": "bf16", "max_abs_err":
           float(err.max()), "tolerance": "1 bf16 ulp of the plain value",
           "device_us": device_us, "profile_launches": launches,
           "ms": turns["kernel"][0], "library_ms": turns["library"][0],
           "ms_turns": {k: v[1] for k, v in turns.items()},
           "plain_ms": time_ms(lambda: rms._reference(x, w, eps), iters=50),
           "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes}
    row["bound_share"] = bound_ms / row["ms"]
    if device_us:
        row["device_bound_share"] = bound_ms * 1e3 / device_us
    return row


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
    res["rmsnorm_train_shape"] = rmsnorm_train_row(kernels, cfg)
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
    res["checkpoint"] = ckpt_adam8bit(job, state, batch)
    log("phase8 adam8bit checkpoint " + json.dumps(res["checkpoint"]))
    del state, job, opt
    torch.cuda.empty_cache()
    return res


def state_diff(a, b) -> dict:
    """Leaves of two training states (``tree_utils.flatten_to_shards``
    keys) that are not bit-equal, with the count and bytes compared."""
    import torch

    from dlrover_tpu_torch.checkpoint import tree_utils

    ta, _ = tree_utils.flatten_to_shards(a)
    tb, _ = tree_utils.flatten_to_shards(b)
    unequal = sorted(set(ta) ^ set(tb)) + [
        k for k in ta if k in tb and not (
            ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape
            and torch.equal(ta[k], tb[k].to(ta[k].device)))]
    return {"tensors": len(ta), "unequal": unequal,
            "bytes": sum(t.numel() * t.element_size() for t in ta.values())}


def ckpt_adam8bit(job, state, batch) -> dict:
    """Phase 8's state (fp32 masters, int8 moments, their scales, the step
    count and the rounding generator) through ``FlashCheckpointer``: saved
    to memory and then to storage, restored into a freshly built state
    (other seed), held bit-equal tensor by tensor, and then one more step
    of each: the losses bit-equal and the two states still bit-equal."""
    import torch

    from dlrover_tpu_torch.checkpoint.checkpointer import FlashCheckpointer
    from dlrover_tpu_torch.common.shm import unlink_arena

    tmp = tempfile.mkdtemp(prefix="chip_smoke_a8_")
    ck = FlashCheckpointer(tmp, job_name=f"chip-smoke-a8-{os.getpid()}",
                           max_to_keep=1)
    try:
        meta = {"step": state["step"]}
        ck.save(state, meta=meta)
        first = ck.engine.stats()
        ck.save(state, meta=meta, storage=True)
        if not ck.wait():
            raise SystemExit("adam8bit checkpoint: the persist failed")
        saved = ck.engine.stats()
        fresh = job.create_state(
            torch.Generator(device=DEV).manual_seed(SEED + 1))
        if ck.load(fresh) is None or \
                ck.engine.last_restore_source != "shm":
            raise SystemExit(f"adam8bit checkpoint: no warm restore "
                             f"({ck.engine.stats()})")
        restore = {f: ck.engine.stats()[f] for f in (
            "restore_ms", "restore_copy_ms")}
        before = state_diff(state, fresh)
        _, m1 = job.train_step(state, batch)
        _, m2 = job.train_step(fresh, batch)
        losses = [float(m1["loss"]), float(m2["loss"])]
        after = state_diff(state, fresh)
        del fresh
        if before["unequal"] or after["unequal"] or losses[0] != losses[1]:
            raise SystemExit(
                f"adam8bit restore not bit-equal: restored "
                f"{before['unequal'][:5]}, after a step "
                f"{after['unequal'][:5]}, losses {losses}")
    finally:
        ck.close()
        unlink_arena(ck.engine.arena.name)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"tensors": before["tensors"], "state_bytes": before["bytes"],
            "first_save_stall_ms": first["stall_ms"],
            "first_save_d2h_ms": first["d2h_ms"],
            "first_save_arena_ms": first["arena_ms"],
            "stall_ms": saved["stall_ms"], "d2h_ms": saved["d2h_ms"],
            "arena_ms": saved["arena_ms"], "persist_ms": saved["persist_ms"],
            "persist_mbps": saved["persist_mbps"],
            "shard_bytes": saved["shard_bytes"],
            "arena_bytes": saved["arena_bytes"],
            "arena_backend": saved["arena_backend"],
            "warm_restore": restore, "restored_bit_equal": True,
            "next_step_losses": losses}


def train_child(argv, what: str) -> dict:
    """``python -m dlrover_tpu_torch.train argv`` in a process of its own;
    its ``parse_train_output`` fields."""
    import torch

    torch.cuda.empty_cache()  # the child needs the card's memory
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.train", *argv],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=900)
    out = proc.stdout
    log("\n".join("  " + ln for ln in out.strip().splitlines()[-3:]))
    if proc.returncode != 0 or "TRAIN_DONE" not in out:
        raise SystemExit(f"{what}: rc {proc.returncode}\n{out[-3000:]}\n"
                         f"{proc.stderr[-5000:]}")
    return parse_train_output(out)


def shard_crcs(ckpt_dir: str, step: int) -> dict:
    """Each tensor's CRC-32 in the shard of ``step`` (meta only)."""
    from dlrover_tpu_torch.checkpoint import shard_file
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    man = shard_file.read_shard_manifest(PosixDiskStorage(), ckpt_dir, step,
                                         0)
    if man is None:
        raise SystemExit(f"no shard of step {step} in {ckpt_dir}")
    return {k: tm["ref"]["crc32"] if isinstance(tm.get("ref"), dict)
            else tm["crc32"] for k, tm in man.tensors.items()}


def name_nondeterministic_op(llama, train, argv) -> str:
    """Two forwards and backwards of one fresh state on one batch: where
    they first differ."""
    import torch

    from dlrover_tpu_torch.checkpoint import tree_utils

    args = train.parse_args(argv)
    cfg, _, state = train.build(args)
    toks = torch.from_numpy(train.synth_tokens(
        range(args.batch_per_proc), args.seq_len, cfg.vocab_size)).to(DEV)
    (l1, g1), (l2, g2) = (loss_and_grads(llama, state["params"],
                                         {"tokens": toks}, cfg)
                          for _ in range(2))
    if l1 != l2:
        return f"the forward (llama.loss_fn): {l1!r} then {l2!r}"
    paths = [leaf.path for leaf in tree_utils.state_leaves(state["params"])]
    for path, a, b in zip(paths, g1, g2):
        if not torch.equal(a, b):
            return f"the backward: two gradients of {path} differ"
    return ("neither the forward nor the backward of a step: the optimizer "
            "update or state carried across steps")


def expected_launches(cfg, steps: int) -> dict:
    return {"flash_fwd": cfg.n_layer * steps, "flash_dq": cfg.n_layer * steps,
            "flash_dkv": cfg.n_layer * steps,
            "rmsnorm": (2 * cfg.n_layer + 1) * steps}


def phase_checkpoint(llama, train, counted, card: str) -> dict:
    """Phase 9: flash checkpointing of Llama-800M (AdamW, full width and
    depth, B 4 x S 2048) through the training CLI.  Two uninterrupted runs
    of K + 1 steps (one checkpointing) must agree bit for bit; a run stops
    after step K and its save; a restore in a child process from the arena
    it left (warm) and one from storage alone (cold: a hard-linked copy of
    the directory, whose arena namespace holds nothing) each train step K
    + 1, whose loss must equal the uninterrupted run's bit for bit, and
    whose saved state must equal the uninterrupted run's (every tensor's
    CRC-32).  fsck finds the directory clean; a byte flipped in a tensor
    of the newest step is reported, quarantined by ``load``, and the older
    step restored, whose next step again gives the uninterrupted loss.
    ``torch.save`` of the same state to the same disk is timed as a
    yardstick."""
    import torch

    from dlrover_tpu_torch.checkpoint import fsck, shard_file
    from dlrover_tpu_torch.checkpoint.checkpointer import FlashCheckpointer
    from dlrover_tpu_torch.common.shm import arena_name, unlink_arena
    from dlrover_tpu_torch.common.storage import PosixDiskStorage
    from dlrover_tpu_torch.trainer.sampler import ElasticSampler

    k = CKPT_K
    base = ["--model", CKPT_MODEL, "--seq_len", str(TRAIN_SEQ),
            "--batch_per_proc", str(TRAIN_BATCH), "--device", DEV]
    cfg = train.build_config(train.parse_args(base))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    dirs = {n: os.path.join(tmp, n) for n in ("straight", "run", "cold")}
    arenas = {n: arena_name(train.ckpt_job_name(d), 0)
              for n, d in dirs.items()}
    res = {"card": card, "model": f"{CKPT_MODEL}, AdamW", "k": k,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ}
    try:
        straight = run_train_cli(train, base + ["--steps", str(k + 1)],
                                 counted)
        ckpted = run_train_cli(train, base + [
            "--steps", str(k + 1), "--ckpt_dir", dirs["straight"],
            "--ckpt_interval", str(k + 1)], counted)
        res["uninterrupted_losses"] = [straight["first_loss"],
                                       straight["loss"]]
        if (straight["first_loss"], straight["loss"]) != \
                (ckpted["first_loss"], ckpted["loss"]):
            torch.cuda.empty_cache()
            other = [ckpted["first_loss"], ckpted["loss"]]
            op = name_nondeterministic_op(llama, train, base)
            raise SystemExit(
                f"two uninterrupted runs differ "
                f"({res['uninterrupted_losses']} vs {other}); not "
                f"deterministic: {op}")
        want_crcs = shard_crcs(dirs["straight"], k + 1)
        shard_bytes = ckpted["ckpt"]["shard_bytes"]
        shutil.rmtree(dirs["straight"])
        unlink_arena(arenas["straight"])
        free = shutil.disk_usage(tmp).free
        if free < 3.2 * shard_bytes:
            raise SystemExit(f"checkpoint phase needs ~{3.2 * shard_bytes:.0f}"
                             f" bytes of disk under {tmp}, {free} are free")

        run = run_train_cli(train, base + [
            "--steps", str(k), "--ckpt_dir", dirs["run"],
            "--ckpt_interval", str(k)], counted)
        report = fsck.fsck(dirs["run"])
        if report.damaged or report.committed_step != k:
            raise SystemExit(f"fsck of the interrupted run: "
                             f"{report.to_dict()}")
        ck = run["ckpt"]
        res.update({
            "state_bytes": ck["staged_bytes"],
            "shard_bytes": ck["shard_bytes"],
            "arena_bytes": ck["arena_bytes"],
            "arena_backend": ck["arena_backend"],
            "first_save_stall_ms": run["memory_save_stall_ms"][0],
            "stall_ms": ck["stall_ms"], "d2h_ms": ck["d2h_ms"],
            "arena_ms": ck["arena_ms"], "persist_ms": ck["persist_ms"],
            "persist_mbps": ck["persist_mbps"], "fsck": "clean"})
        if ck["arena_backend"] != "native":
            raise SystemExit(f"the shm arena ran on {ck['arena_backend']}, "
                             "not the native backend")

        shutil.copytree(dirs["run"], dirs["cold"], copy_function=os.link)
        want = expected_launches(cfg, 1)
        for name, src, source in (("warm", "run", "shm"),
                                  ("cold", "cold", "storage")):
            child = train_child(base + [
                "--steps", str(k + 1), "--ckpt_dir", dirs[src],
                "--ckpt_interval", str(k + 2)], f"{name} restore")
            launches = {n: int(child[f"{n}_launches"]) for n in want}
            row = {"restored": child["restored"],
                   **{f: child["ckpt"][f] for f in (
                       "restore_source", "restore_ms", "restore_copy_ms",
                       "stall_ms", "persist_ms",
                       "persist_mbps")},
                   "first_loss": child["first_loss"], "launches": launches}
            crcs = shard_crcs(dirs[src], k + 1)
            row["state_after_step_equal"] = crcs == want_crcs
            res[name] = row
            if (child["restored"] != [f"[worker 0] restored step={k}"]
                    or row["restore_source"] != source
                    or child["first_loss"] != straight["loss"]
                    or launches != want
                    or not row["state_after_step_equal"]):
                diff = [t for t in want_crcs if crcs.get(t) != want_crcs[t]]
                raise SystemExit(
                    f"{name} restore: {row} against the uninterrupted loss "
                    f"{straight['loss']} and launches {want}; unequal "
                    f"tensors {diff[:5]}")

        # A flipped byte in the newest step: fsck names it, load
        # quarantines it and restores the older step.
        d = dirs["run"]
        unlink_arena(arenas["run"])
        man = shard_file.read_shard_manifest(PosixDiskStorage(), d, k + 1, 0)
        key = "['params']['embed']|0"
        tm = man.tensors[key]
        with open(shard_file.shard_path(d, k + 1, 0), "r+b") as f:
            f.seek(man.data_base + tm["offset"] + tm["nbytes"] // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        report = fsck.fsck(d)
        if not any(f.severity == fsck.SEV_DAMAGE and key in f.reason
                   for f in report.findings):
            raise SystemExit(f"fsck missed the flipped byte: "
                             f"{report.to_dict()}")
        args = train.parse_args(base)
        _, job, state = train.build(args)
        ckp = FlashCheckpointer(d, job_name=train.ckpt_job_name(d))
        try:
            got = ckp.load(state)
            restore = {f: ckp.engine.stats()[f] for f in (
                "restore_ms", "restore_copy_ms")}
        finally:
            ckp.close()
        quarantined = os.path.isdir(shard_file.step_dir(d, k + 1)
                                    + shard_file.QUARANTINE_SUFFIX)
        if got is None or got[1]["step"] != k or not quarantined:
            raise SystemExit(f"load after the damage: {got and got[1]}, "
                             f"quarantined {quarantined}")
        path = os.path.join(tmp, "torch_save.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.save({"params": state["params"],
                    "opt_state": state["opt_state"].state_dict(),
                    "step": state["step"]}, path)
        res["torch_save_ms"] = (time.perf_counter() - t0) * 1e3
        res["torch_save_bytes"] = os.path.getsize(path)
        os.remove(path)
        sampler = ElasticSampler(args.dataset_size,
                                 batch_size_per_process=args.batch_per_proc,
                                 seed=17)
        sampler.load_state_dict(got[1]["sampler"])
        toks = train.synth_tokens(next(iter(sampler)), args.seq_len,
                                  cfg.vocab_size)
        _, m = job.train_step(state, {"tokens": toks})
        loss = repr(float(m["loss"]))
        del state, job
        torch.cuda.empty_cache()
        res["damaged_step"] = {"fsck_damage": True, "quarantined": True,
                               "restored_step": k, **restore,
                               "next_loss": loss}
        if loss != straight["loss"]:
            raise SystemExit(f"after the quarantine: loss {loss} != "
                             f"{straight['loss']}")
    finally:
        for name in arenas.values():
            unlink_arena(name)
        shutil.rmtree(tmp, ignore_errors=True)
    log("phase9 checkpoint " + json.dumps(res))
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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
    phase_checkpoint(llama, train, counted, smi)

    # Phase 3b runs last, on the same 7B weights made again from the seed:
    # a profile taken after its graph replays, in phase 5, once lost every
    # kernel record.
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    prefixed = phase_prefix_handoff(infer, rms, params, cfg)
    graphed = phase_serve_graph(infer, rms, params, cfg)
    del params
    torch.cuda.empty_cache()

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
    log("phase3c prefix_handoff " + json.dumps(prefixed))
    log("phase3b serve " + json.dumps(graphed))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
