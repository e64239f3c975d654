"""Serving entry point: continuous-batching decode over a Llama model.

The port's counterpart of ``examples/llama_serve.py`` (plain server mode)
with its own copy of ``examples/serve_common.py`` ``seeded_requests``:

    python -m dlrover_tpu_torch.serve --config llama2_7b --requests 8
    python -m dlrover_tpu_torch.serve --config llama2_7b --decode_chunk 8 \
        --paged --quant_kv
    python -m dlrover_tpu_torch.serve --config llama2_7b --prefix_len 256
    python -m dlrover_tpu_torch.serve --config tiny --device cpu
    python -m dlrover_tpu_torch.serve --config llama2_7b --spec_server \
        --draft_layers 1 --adapt_k
    python -m dlrover_tpu_torch.serve --config tiny --device cpu --speculative

``--quant_kv`` and ``--decode_chunk`` are ``examples/llama_serve.py``'s
(the int8 KV cache; tokens a decode dispatch), ``--paged``,
``--block_size`` and ``--pool_blocks`` ``examples/llama_serve_fleet.py``'s
(the paged KV arena; 0 blocks means the slotted layout's memory).
``--prefix_len N`` is ``examples/llama_serve.py``'s: a random system
prefix of N tokens (drawn after the prompts) shared by every request
through prefix caching (``serve(shared_prefix=)``).  On the card the
decode dispatch is one CUDA graph replay a round.

Speculative decoding, as ``examples/llama_serve.py`` has it:
``--speculative`` decodes every request in one
``generate_speculative_batched`` call, ``--spec_server`` runs speculative
rounds inside the server (``draft_k`` 4, ``--adapt_k`` for the global
adaptive width).  The draft has the target's width at ``--draft_layers``
blocks, its weights drawn from seed 7, as the reference's ``--hf_dir``
branch builds it.  ``--stream`` prints request 0's tokens as they come.
``--tp`` and ``--hf_dir`` raise ``NotImplementedError`` naming the Queue A
items that bring them.

Weights are random, drawn from ``--seed``; there is nothing to download.
It prints tokens/s, the median time to first token, the decode path, the
preemptions (and, paged, the block pool's state), with a prefix the
admissions that started from the template, the template prefills and the
prefix store's hits and misses, and the RMSNorm kernel launches: the eager
ones (prefills, template prefills) plus the graph's nodes times its
replays (0 on the CPU, where the plain version runs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.constants import MODEL_ITEM, TP_COMPUTE_ITEM
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
from dlrover_tpu_torch.models.llama_infer import (
    DecodeServer,
    generate_speculative_batched,
)
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


def draft_model(cfg: LlamaConfig, n_layer: int, dev):
    """``(params, cfg)`` of the draft: the target's width at ``n_layer``
    blocks, weights drawn from seed 7."""
    dcfg = dataclasses.replace(cfg, n_layer=n_layer)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    return init_params(dcfg, gen, dev), dcfg


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
    ap.add_argument("--quant_kv", action="store_true",
                    help="int8 kv cache (half the decode HBM traffic)")
    ap.add_argument("--decode_chunk", type=int, default=1,
                    help="tokens per decode dispatch")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: a block pool with per-request block "
                         "tables")
    ap.add_argument("--block_size", type=int, default=16,
                    help="tokens per KV block under --paged")
    ap.add_argument("--pool_blocks", type=int, default=0,
                    help="KV blocks in the pool under --paged (0 = slots "
                         "* max_len / block_size)")
    ap.add_argument("--prefix_len", type=int, default=0,
                    help="share a random system prefix of N tokens across "
                         "all requests via prefix caching (prefilled once; "
                         "admissions copy or share its kv rows)")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-model speculative decode (one batched "
                         "call over all requests)")
    ap.add_argument("--spec_server", action="store_true",
                    help="speculative rounds inside the continuous-"
                         "batching server")
    ap.add_argument("--draft_layers", type=int, default=1)
    ap.add_argument("--adapt_k", action="store_true",
                    help="(--spec_server) shrink/regrow the draft window "
                         "from measured acceptance")
    ap.add_argument("--stream", action="store_true",
                    help="print request 0's tokens as they decode")
    ap.add_argument("--tp", type=int, default=0,
                    help="shard params over N cards (not ported)")
    ap.add_argument("--hf_dir", default="",
                    help="HF checkpoint dir (not ported)")
    args = ap.parse_args(argv)
    if args.tp > 0:
        raise NotImplementedError(f"--tp comes with {TP_COMPUTE_ITEM}")
    if args.hf_dir:
        raise NotImplementedError(f"--hf_dir comes with {MODEL_ITEM}")
    if args.stream and args.speculative:
        raise SystemExit(
            "--stream requires a server mode (it rides serve's on_token "
            "hook); the one-shot --speculative call has no streaming "
            "surface"
        )

    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompts, rng = seeded_requests(cfg, args.requests, args.seed)
    shared_prefix = None
    if args.prefix_len > 0:
        shared_prefix = rng.randint(
            1, cfg.vocab_size, size=(args.prefix_len,)).astype(np.int32)
    # + the chunk's headroom and the prefix every request's rows hold,
    # rounded up to whole blocks when paged.
    draft_k = 4
    spec = args.spec_server or args.speculative
    draft = draft_model(cfg, args.draft_layers, dev) if spec else None
    if args.speculative:
        return speculative_batched(args, cfg, params, draft, prompts,
                                   draft_k, dev)
    # + the chunk's (or the speculative round's) headroom and the prefix
    # every request's rows hold, rounded up to whole blocks when paged.
    slack = draft_k + 1 if spec else args.decode_chunk - 1
    max_len = max(64, args.max_new_tokens + 24) + slack + args.prefix_len
    if args.paged:
        max_len = -(-max_len // args.block_size) * args.block_size
    spec_kw = ({"draft": draft, "draft_k": draft_k, "adapt_k": args.adapt_k}
               if spec else {})
    srv = DecodeServer(
        params, cfg, slots=args.slots, max_len=max_len,
        temperature=args.temperature, seed=args.seed,
        quant_kv=args.quant_kv, decode_chunk=args.decode_chunk,
        paged=args.paged, block_size=args.block_size,
        pool_blocks=args.pool_blocks or None, **spec_kw,
    )
    ttft: dict = {}
    launches0 = rmsnorm.launches
    t0 = time.perf_counter()

    def on_token(rid, tok):
        ttft.setdefault(rid, time.perf_counter() - t0)
        if args.stream and rid == 0:
            print(f"STREAM r0 +{int(tok)}", flush=True)

    outs = srv.serve(prompts, max_new_tokens=args.max_new_tokens,
                     on_token=on_token, shared_prefix=shared_prefix)
    wall = time.perf_counter() - t0
    total_new = sum(len(o) - len(p) - args.prefix_len
                    for o, p in zip(outs, prompts))
    for i, o in enumerate(outs[:3]):
        print(f"request {i}: {len(o)} tokens -> {o[:12].tolist()}...")
    st = srv.last_stats
    graph = srv.decode_graph
    launches = rmsnorm.launches - launches0 + graph.recorded.get(
        "rmsnorm", 0) * st["graph_replays"]
    paged = (f" block_stats={json.dumps(srv.block_stats())}"
             if args.paged else "")
    prefix = ""
    if shared_prefix is not None:
        prefix = (f" prefix_len={args.prefix_len} "
                  f"templated={st['templated']} "
                  f"template_forwards={st['template_forwards']} "
                  f"prefix_hits={srv.prefix_hits} "
                  f"prefix_misses={srv.prefix_misses}")
    print(
        f"SERVE_DONE config={args.config} device={dev} "
        f"requests={len(outs)} slots={args.slots} new_tokens={total_new} "
        f"tokens_per_sec={total_new / wall:.1f} "
        f"ttft_p50_ms={1e3 * statistics.median(ttft.values()):.1f} "
        f"path={st['path']} decode_chunk={args.decode_chunk} "
        f"quant_kv={args.quant_kv} preemptions={srv.preemptions} "
        f"rounds={st['rounds']} forwards={st['forwards']} "
        f"graph_replays={st['graph_replays']} "
        f"rmsnorm_launches={launches}{prefix}{paged}{spec_line(st)}"
    )
    return 0


def spec_line(st: dict) -> str:
    """The speculative server's counters for the SERVE_DONE line."""
    if st.get("path") != "spec":
        return ""
    return (f" tokens_per_round={st['tokens_per_round']:.2f} "
            f"k_final={st['k_final']} "
            f"spec_fallback_rounds={st['spec_fallback_rounds']} "
            f"draft_forwards={st['draft_forwards']}")


def speculative_batched(args, cfg, params, draft, prompts, k, dev) -> int:
    """``--speculative``: every request in one batched call."""
    lens = np.asarray([len(p) for p in prompts], np.int64)
    padded = np.zeros((len(prompts), int(lens.max())), np.int64)
    for b, p in enumerate(prompts):
        padded[b, :len(p)] = p
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    stats: dict = {}
    launches0 = rmsnorm.launches
    t0 = time.perf_counter()
    out, out_lens = generate_speculative_batched(
        params, cfg, draft[0], draft[1],
        torch.from_numpy(padded).to(dev), torch.from_numpy(lens).to(dev),
        max_new_tokens=args.max_new_tokens, k=k, quant_kv=args.quant_kv,
        temperature=args.temperature, generator=gen, stats=stats,
    )
    wall = time.perf_counter() - t0
    out, out_lens = out.cpu().numpy(), out_lens.cpu().numpy()
    total_new = int((out_lens - lens).sum())
    for i in range(min(3, len(prompts))):
        print(f"request {i}: {int(out_lens[i])} tokens -> "
              f"{out[i, :12].tolist()}...")
    print(
        f"SERVE_DONE config={args.config} device={dev} "
        f"requests={len(prompts)} mode=speculative(batched) k={k} "
        f"new_tokens={total_new} tokens_per_sec={total_new / wall:.1f} "
        f"rounds={stats['rounds']} "
        f"tokens_per_round={stats['tokens_per_round']:.2f} "
        f"quant_kv={args.quant_kv} "
        f"rmsnorm_launches={rmsnorm.launches - launches0}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
