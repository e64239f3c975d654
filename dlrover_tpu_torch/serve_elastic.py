"""Elastic serving: a serving worker under the port's launcher that
restarts through ``serve_journaled``.

The port's counterpart of ``examples/llama_serve_elastic.py``::

    python -m dlrover_tpu_torch.run --standalone --nproc_per_node=1 \
        dlrover_tpu_torch/serve_elastic.py -- --journal_dir /tmp/sj \
        --device cpu

The worker builds the seeded tiny model in fp32 and a seeded request
stream, and serves them through
``llama_infer.serve_journaled``: every completion is fsync'd to
``<journal_dir>/results.jsonl`` as its slot frees.  When the agent restarts
a killed worker, the new incarnation rebuilds the same server, answers the
journaled requests from the journal and serves only the rest; greedy decode
makes the replayed tokens the ones an uninterrupted run gives.  Each newly
served completion reports a step to the master (the agent's hang detector
sees progress) and prints ``SERVED rid=N``; the last line is
``SERVE_ELASTIC_DONE``.  It runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max_new_tokens", type=int, default=96)
    p.add_argument("--journal_dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--throttle_s", type=float, default=0.0,
                   help="sleep per completion (stretches the serve window "
                        "so tests can land a kill mid-run)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    import dlrover_tpu_torch.trainer as trainer_sdk
    from dlrover_tpu_torch.common.device import resolve_device
    from dlrover_tpu_torch.models import llama_infer
    from dlrover_tpu_torch.models.llama import init_params
    from dlrover_tpu_torch.serve import CONFIGS, seeded_requests

    dev = resolve_device(args.device)
    ctx = trainer_sdk.init(device=dev)
    # A restarted worker rebuilds the same server from the seed, so greedy
    # replay is exact; fp32 keeps each continuation independent of the
    # slot batch.
    cfg = CONFIGS["tiny"](dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompts, _ = seeded_requests(cfg, args.requests, args.seed + 1)
    os.makedirs(args.journal_dir, exist_ok=True)
    journal = os.path.join(args.journal_dir, "results.jsonl")

    srv = llama_infer.DecodeServer(
        params, cfg, slots=args.slots,
        max_len=max(64, args.max_new_tokens + 16),
    )
    served = [0]

    def on_serve(rid, tokens):
        served[0] += 1
        ctx.report_step(served[0])
        print(f"SERVED rid={rid} ({served[0]} new this incarnation)",
              flush=True)
        if args.throttle_s > 0:
            time.sleep(args.throttle_s)

    t0 = time.perf_counter()
    outs = llama_infer.serve_journaled(
        srv, prompts, args.max_new_tokens, journal, on_serve=on_serve,
    )
    dt = time.perf_counter() - t0
    replayed = len(prompts) - served[0]
    total_new = sum(len(o) - len(p) for o, p in zip(outs, prompts))
    print(
        f"SERVE_ELASTIC_DONE requests={len(outs)} "
        f"served_now={served[0]} from_journal={replayed} "
        f"new_tokens={total_new} tokens_per_sec={total_new / dt:.1f}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
