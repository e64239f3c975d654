"""Serving entry point: continuous-batching decode over a Llama model.

The port's counterpart of ``examples/llama_serve.py`` (plain server mode)
with its own copy of ``examples/serve_common.py`` ``seeded_requests``:

    python -m dlrover_tpu_torch.serve --config llama2_7b --requests 8
    python -m dlrover_tpu_torch.serve --config tiny --device cpu

Weights are random, drawn from ``--seed``; there is nothing to download.
It prints tokens/s, the median time to first token and the number of
RMSNorm kernel launches (0 on the CPU, where the plain version runs).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
from dlrover_tpu_torch.models.llama_infer import DecodeServer
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm

CONFIGS = {
    "tiny": LlamaConfig.tiny,
    "small_300m": LlamaConfig.small_300m,
    "medium_800m": LlamaConfig.medium_800m,
    "llama2_7b": LlamaConfig.llama2_7b,
}


def seeded_requests(cfg: LlamaConfig, requests: int, seed: int,
                    min_len: int = 4, max_len: int = 12):
    """The seeded mixed-length request stream: ``(prompts, rng)``, the
    same draws as the reference's ``serve_common.seeded_requests``."""
    rng = np.random.RandomState(seed)
    prompts = [
        rng.randint(1, cfg.vocab_size, size=(int(n),)).astype(np.int32)
        for n in rng.randint(min_len, max_len, size=(requests,))
    ]
    return prompts, rng


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max_new_tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompts, _ = seeded_requests(cfg, args.requests, args.seed)
    srv = DecodeServer(
        params, cfg, slots=args.slots,
        max_len=max(64, args.max_new_tokens + 24),
        temperature=args.temperature, seed=args.seed,
    )
    ttft: dict = {}
    launches0 = rmsnorm.launches
    t0 = time.perf_counter()

    def on_token(rid, _tok):
        ttft.setdefault(rid, time.perf_counter() - t0)

    outs = srv.serve(prompts, max_new_tokens=args.max_new_tokens,
                     on_token=on_token)
    wall = time.perf_counter() - t0
    total_new = sum(len(o) - len(p) for o, p in zip(outs, prompts))
    for i, o in enumerate(outs[:3]):
        print(f"request {i}: {len(o)} tokens -> {o[:12].tolist()}...")
    st = srv.last_stats
    print(
        f"SERVE_DONE config={args.config} device={dev} "
        f"requests={len(outs)} slots={args.slots} new_tokens={total_new} "
        f"tokens_per_sec={total_new / wall:.1f} "
        f"ttft_p50_ms={1e3 * statistics.median(ttft.values()):.1f} "
        f"rounds={st['rounds']} forwards={st['forwards']} "
        f"rmsnorm_launches={rmsnorm.launches - launches0}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
