"""KV-cache decoding and the continuous-batching server for Llama, in PyTorch.

Held against ``dlrover_tpu/models/llama_infer.py``: :func:`init_cache`,
:func:`_cached_attention`, :func:`forward_step`, :func:`_filter_logits`,
:func:`_make_sampler`, :func:`generate`, :func:`generate_ragged` and the
plain slotted path of :class:`DecodeServer` (``submit``/``cancel``/
``abort``, ``_prefill``, the single-token ``step``, ``serve``,
``serve_incremental`` and the plain branch of ``_run``).

The reference is functional: every step returns a new cache.  Here the
cache tensors are updated in place (the step writes the new keys and
values into its slots and returns the same layer dicts with a new
offset), which keeps one copy of the cache on the card.

Numerics kept from the reference: attention scores are taken in fp32 from
the cache's values and divided by ``sqrt(D)`` after the product; masks use
the finite ``-1e30``; the probabilities are rounded to the cache dtype
before the PV product, which accumulates in fp32; the attention output is
cast to ``cfg.dtype`` before ``wo``; logits are fp32.

Not ported yet, and refused with an error: the int8 KV cache
(``quant_kv``), the sliding-window ring buffer (a windowed model decodes on
the dense cache with the window mask, as the reference's server does),
paged KV, speculative decoding, ``decode_chunk > 1`` and prefix caching.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.llama import LlamaConfig, _rope, block_apply
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm

SERVING_SLICE = "a later serving slice of the port (see ROADMAP.md)"
NEG_INF = -1e30

Offset = Union[int, torch.Tensor]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, *,
               device: DeviceLike = None, quant_kv: bool = False) -> Dict:
    """Zeroed per-layer k/v cache ``[batch, n_kv_head, max_len, head_dim]``
    in ``cfg.dtype`` plus the write offset (an int; a ``[batch]`` tensor
    puts :func:`forward_step` in ragged mode)."""
    if quant_kv:
        raise NotImplementedError(
            f"the int8 KV cache (quant_kv) comes with {SERVING_SLICE}"
        )
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_head, max_len, cfg.head_dim)
    return {
        "layers": [
            {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            }
            for _ in range(cfg.n_layer)
        ],
        "offset": 0,
    }


def _cached_attention(x: torch.Tensor, layer: Dict, cfg: LlamaConfig,
                      cache_layer: Dict, offset: Offset,
                      positions: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] new tokens; writes their k/v into ``cache_layer`` in
    place and attends to the cache up to each query's position.

    ``offset`` is an int (every row writes at ``offset..offset+T-1``) or a
    ``[B]`` tensor (ragged: row b writes at its own ``offset[b]..``).  A
    write past the cache's length raises; the caller checks capacity."""
    B, T, _ = x.shape
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dt = cfg.dtype
    q = (x @ layer["wq"].to(dt)).reshape(B, T, H, D)
    k = (x @ layer["wk"].to(dt)).reshape(B, T, KV, D)
    v = (x @ layer["wv"].to(dt)).reshape(B, T, KV, D)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)

    kc, vc = cache_layer["k"], cache_layer["v"]
    L = kc.shape[2]
    if torch.is_tensor(offset):
        slots = offset[:, None] + torch.arange(T, device=x.device)  # [B, T]
        rows = torch.arange(B, device=x.device)[:, None]
        # kc[rows, :, slots] is [B, T, KV, D] (advanced dims first).
        kc[rows, :, slots] = k.to(kc.dtype)
        vc[rows, :, slots] = v.to(vc.dtype)
    else:
        if offset + T > L:
            raise IndexError(
                f"cache write [{offset}, {offset + T}) past its {L} slots"
            )
        kc[:, :, offset:offset + T] = k.transpose(1, 2).to(kc.dtype)
        vc[:, :, offset:offset + T] = v.transpose(1, 2).to(vc.dtype)

    rep = H // KV
    # Grouped attention against the compact cache: query heads g*rep..
    # (g+1)*rep-1 read kv head g.  Scores in fp32 (the reference's
    # preferred_element_type=float32), scaled after the product.
    qg = q.transpose(1, 2).reshape(B, KV, rep * T, D).to(kc.dtype)
    s = torch.matmul(qg.float(), kc.float().transpose(-1, -2))
    s = (s / math.sqrt(D)).view(B, KV, rep, T, L)
    kpos = torch.arange(L, device=x.device)
    qpos = positions[:, None, None, :, None]
    s = s.masked_fill(kpos > qpos, NEG_INF)
    if cfg.sliding_window > 0:
        s = s.masked_fill(qpos - kpos >= cfg.sliding_window, NEG_INF)
    p = torch.softmax(s, dim=-1).to(vc.dtype)
    out = torch.matmul(p.view(B, KV, rep * T, L).float(), vc.float())
    out = (
        out.view(B, H, T, D).transpose(1, 2).reshape(B, T, H * D).to(dt)
    )
    return out @ layer["wo"].to(dt)


def forward_step(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Score ``tokens`` [B, T] continuing the cached context.  Returns
    (logits [B, T, vocab] fp32, cache with the same layers, written in
    place, and ``offset + T``)."""
    B, T = tokens.shape
    dt = cfg.dtype
    offset = cache["offset"]
    x = params["embed"].to(dt)[tokens]
    steps = torch.arange(T, device=tokens.device)
    if torch.is_tensor(offset):
        positions = offset[:, None] + steps[None, :]
    else:
        positions = (offset + steps)[None, :].expand(B, T)
    for layer, cache_layer in zip(params["layers"], cache["layers"]):
        def attn_fn(h, layer_, cfg_, positions_, _cache=cache_layer):
            return _cached_attention(h, layer_, cfg_, _cache, offset,
                                     positions_)

        x = block_apply(layer, x, cfg, positions, attn_fn=attn_fn)
    x = rmsnorm(x, params["ln_f"], eps=cfg.rms_eps)
    logits = (x @ params["lm_head"].to(dt)).float()
    return logits, {"layers": cache["layers"], "offset": offset + T}


def _filter_logits(scaled: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """[B, V] temperature-scaled logits -> the same with everything
    outside the top-k / top-p nucleus set to -inf (ties with the k-th
    value survive; the top token always survives)."""
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k, None]
        scaled = scaled.masked_fill(scaled < kth, -math.inf)
    if top_p > 0.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p
        n_keep = keep_sorted.sum(dim=-1).clamp(min=1)
        cutoff = torch.gather(srt, -1, (n_keep - 1)[:, None])
        scaled = scaled.masked_fill(scaled < cutoff, -math.inf)
    return scaled


Picker = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _make_sampler(temperature: float, top_k: int, top_p: float) -> Picker:
    """(logits [B, V], generator) -> [B] token ids: the first maximum at
    temperature 0, else a categorical draw from ``generator`` over the
    top-k / top-p filtered distribution."""

    def pick(logits: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(
            _filter_logits(logits / temperature, top_k, top_p), dim=-1
        )
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return pick


def _generator(device: torch.device,
               generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


@torch.inference_mode()
def generate(params: Dict, cfg: LlamaConfig, prompts: torch.Tensor, *,
             max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0) -> torch.Tensor:
    """[B, P + max_new_tokens]: prompt + continuation.  The prompt is
    scored in one pass, then one token per step against the cache."""
    if max_new_tokens == 0:
        return prompts
    B, P = prompts.shape
    cache = init_cache(cfg, B, P + max_new_tokens, device=prompts.device)
    pick = _make_sampler(temperature, top_k, top_p)
    gen = _generator(prompts.device, generator)
    logits, cache = forward_step(params, prompts, cfg, cache)
    tok = pick(logits[:, -1, :], gen)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_step(params, tok[:, None], cfg, cache)
        tok = pick(logits[:, -1, :], gen)
        out.append(tok)
    return torch.cat([prompts, torch.stack(out, 1).to(prompts.dtype)], 1)


@torch.inference_mode()
def generate_ragged(params: Dict, cfg: LlamaConfig, prompts: torch.Tensor,
                    prompt_lens: torch.Tensor, *, max_new_tokens: int,
                    eos_token: int = -1, pad_token: int = 0,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged batched decode over right-padded ``prompts`` [B, P] with
    true lengths ``prompt_lens`` [B]: per-row offsets and a per-row stop
    on ``eos_token``; the loop ends once every row has emitted it.
    Returns ``(tokens [B, P + max_new_tokens], lengths [B])``: row b is
    its prompt, its continuation right after it (EOS kept), then
    ``pad_token``."""
    B, P = prompts.shape
    N = max_new_tokens
    dev = prompts.device
    prompt_lens = prompt_lens.to(dev, torch.long)
    if N == 0:
        return prompts, prompt_lens
    cache = init_cache(cfg, B, P + N, device=dev)
    pick = _make_sampler(temperature, top_k, top_p)
    gen = _generator(dev, generator)
    logits, cache = forward_step(params, prompts, cfg, cache)
    rows = torch.arange(B, device=dev)
    tok = pick(logits[rows, prompt_lens - 1, :], gen)
    cache["offset"] = prompt_lens.clone()

    buf = torch.full((B, N), pad_token, dtype=prompts.dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    i = 0
    while i < N and not bool(done.all()):
        # ``done`` means the row's EOS is already recorded: the EOS token
        # itself lands in the buffer before the row freezes.
        buf[:, i] = torch.where(done, pad_token, tok).to(buf.dtype)
        done_next = done | (tok == eos_token) if eos_token >= 0 else done
        logits, new_cache = forward_step(params, tok[:, None], cfg, cache)
        nxt = pick(logits[:, -1, :], gen)
        new_cache["offset"] = torch.where(
            done_next, cache["offset"], new_cache["offset"]
        )
        cache = new_cache
        tok = torch.where(done_next, tok, nxt)
        done = done_next
        i += 1

    if eos_token >= 0:
        is_eos = buf == eos_token
        written = torch.where(
            is_eos.any(dim=1),
            is_eos.int().argmax(dim=1) + 1,
            torch.full((B,), i, device=dev),
        ).clamp(max=i)
    else:
        written = torch.full((B,), i, device=dev)
    j = torch.arange(P + N, device=dev)[None, :]
    gen_idx = (j - prompt_lens[:, None]).clamp(0, N - 1)
    gen_vals = torch.gather(buf, 1, gen_idx)
    prompt_padded = torch.nn.functional.pad(prompts, (0, N))
    lens = prompt_lens + written
    out = torch.where(j < prompt_lens[:, None], prompt_padded, gen_vals)
    out = torch.where(j < lens[:, None], out,
                      torch.full_like(out, pad_token))
    return out, lens


class DecodeServer:
    """Continuous-batching greedy/sampled decode over fixed slots: new
    prompts are admitted into slots as sequences finish, so a stream of
    requests keeps every slot busy.

    One single-token step runs over all ``slots`` (ragged per-slot
    offsets); admission scores a new prompt, right-padded to its bucket,
    into one slot's cache rows.  The host loop only schedules.

        srv = DecodeServer(params, cfg, slots=8, max_len=512, eos_token=2)
        outs = srv.serve(list_of_prompt_arrays, max_new_tokens=128)

    The cache lives on the device of ``params``.  Only the plain slotted
    path is ported: ``quant_kv``, ``draft``, ``decode_chunk > 1``,
    ``spec_remote``, ``paged`` and prefixes (``shared_prefix``,
    ``prefix_len``) raise ``NotImplementedError``.
    """

    def __init__(
        self,
        params: Dict,
        cfg: LlamaConfig,
        *,
        slots: int = 8,
        max_len: int = 512,
        eos_token: int = -1,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        prompt_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256),
        seed: int = 0,
        quant_kv: bool = False,
        draft: Optional[Tuple[Dict, LlamaConfig]] = None,
        decode_chunk: int = 1,
        spec_remote: bool = False,
        paged: bool = False,
    ):
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{decode_chunk}")
        refused = {
            "quant_kv=True (int8 KV cache)": quant_kv,
            "draft (speculative decoding)": draft is not None,
            "decode_chunk > 1": decode_chunk > 1,
            "spec_remote=True (remote-draft speculation)": spec_remote,
            "paged=True (paged KV block arena)": paged,
        }
        for what, asked in refused.items():
            if asked:
                raise NotImplementedError(
                    f"DecodeServer {what} comes with {SERVING_SLICE}"
                )
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.eos_token = eos_token
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= max_len
        )
        self._pick = _make_sampler(temperature, top_k, top_p)
        # One sampling stream for every prefill and step, on the device.
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        #: Telemetry of the last serve call (refreshed every loop turn).
        self.last_stats: Dict[str, Any] = {}
        # Incremental admission: ``submit`` enqueues (rid, prompt,
        # max_new_tokens); the serve loop admits as slots free.  The
        # lock makes submit/cancel/abort safe from another thread.
        self._pending: "collections.deque" = collections.deque()
        self._pending_mu = threading.Lock()
        self._abort_rids: set = set()
        # Live views for active_rids/free_slots while a loop runs.
        self._live_active: Optional[np.ndarray] = None
        self._live_slot_req: Optional[list] = None

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds largest bucket "
            f"{self.buckets[-1]}"
        )

    def pop_request_stats(self, rid) -> Optional[Dict[str, Any]]:
        """Per-request speculation telemetry; the plain path records none,
        so this is always None here."""
        return None

    def check_capacity(self, prompt_len: int, max_new_tokens: int) -> None:
        """Raise ValueError if a request of this shape could write past
        ``max_len``.  The plain path writes nothing past the emission
        budget, so ``prompt_len + max_new_tokens <= max_len`` keeps every
        cache index in range (a torch index out of range raises, or trips
        a device-side assert on CUDA, where JAX would drop the write)."""
        need = prompt_len + max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"prompt {prompt_len} + max_new_tokens {max_new_tokens} "
                f"= {need} exceeds max_len {self.max_len}"
            )

    def _as_prompt(self, prompt) -> np.ndarray:
        p = np.asarray(prompt, np.int32)
        if p.ndim != 1 or p.size == 0:
            raise ValueError(
                f"a prompt is a non-empty 1-D token array, got shape "
                f"{p.shape}"
            )
        if p.min() < 0 or p.max() >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size})"
            )
        return p

    def submit(self, rid, prompt, max_new_tokens: int,
               prefix_len: int = 0) -> None:
        """Enqueue one request for incremental admission (any hashable
        ``rid``); the running ``serve_incremental`` loop admits it when a
        slot frees.  Raises ValueError at once if it can never fit."""
        if prefix_len:
            raise NotImplementedError(
                f"prefix templates (prefix_len) come with {SERVING_SLICE}"
            )
        p = self._as_prompt(prompt)
        self.check_capacity(len(p), max_new_tokens)
        with self._pending_mu:
            self._pending.append((rid, p, int(max_new_tokens)))

    def cancel(self, rid) -> bool:
        """Drop a not-yet-admitted request.  False when ``rid`` is unknown
        or already decoding."""
        with self._pending_mu:
            for i, item in enumerate(self._pending):
                if item[0] == rid:
                    del self._pending[i]
                    return True
        return False

    def abort(self, rid) -> bool:
        """A pending ``rid`` is dropped now; an active one is freed at the
        loop's next admission point, its partial output discarded (no
        ``on_finish``, no result).  False for an unknown or finished
        ``rid``."""
        if self.cancel(rid):
            return True
        if rid in self.active_rids():
            with self._pending_mu:
                self._abort_rids.add(rid)
            return True
        return False

    def _pop_pending(self):
        with self._pending_mu:
            return self._pending.popleft() if self._pending else None

    def pending_count(self) -> int:
        with self._pending_mu:
            return len(self._pending)

    def pending_rids(self) -> list:
        with self._pending_mu:
            return [item[0] for item in self._pending]

    def active_rids(self) -> list:
        """Request ids decoding in slots (live only while a loop runs)."""
        act, req = self._live_active, self._live_slot_req
        if act is None or req is None:
            return []
        return [req[s] for s in range(self.slots) if act[s]]

    def free_slots(self) -> int:
        """Slots a new admission could use now: total minus decoding minus
        already queued."""
        act = self._live_active
        busy = int(act.sum()) if act is not None else 0
        return max(0, self.slots - busy - self.pending_count())

    def _prefill(self, cache: Dict, s: int, prompt: np.ndarray
                 ) -> Tuple[torch.Tensor, int]:
        """Zero slot ``s``'s cache rows, score ``prompt`` into them, set
        the slot's offset to its length and pick its first token.  A
        prompt that fits a bucket is right-padded to it and scored in one
        pass (the pad keys sit past the prompt and are causally hidden
        until decode overwrites them); a longer one is scored in full
        chunks of the largest bucket, the last chunk shifted back to end
        at the prompt's end.  Returns (first token, forward calls)."""
        n = len(prompt)
        rows = [{k: t[s:s + 1] for k, t in c.items()}
                for c in cache["layers"]]
        for c in rows:
            for t in c.values():
                t.zero_()
        if n <= self.buckets[-1]:
            padded = np.zeros((1, self._bucket(n)), np.int64)
            padded[0, :n] = prompt
            logits, _ = forward_step(
                self.params, torch.from_numpy(padded).to(self.device),
                self.cfg, {"layers": rows, "offset": 0},
            )
            last, calls = logits[:, n - 1, :], 1
        else:
            # Every chunk is full; re-scoring the shifted-back positions
            # recomputes the same keys from the same complete prefix.
            C = self.buckets[-1]
            calls = 0
            for c0 in range(0, n, C):
                start = c0 if c0 + C <= n else n - C
                piece = torch.from_numpy(
                    prompt[start:start + C].astype(np.int64)
                ).to(self.device)
                logits, _ = forward_step(
                    self.params, piece[None, :], self.cfg,
                    {"layers": rows, "offset": start},
                )
                calls += 1
                if start + C >= n:
                    last = logits[:, (n - 1) - start, :]
        cache["offset"][s] = n
        return self._pick(last, self._gen)[0], calls

    def _step(self, cache: Dict, toks: torch.Tensor, active: np.ndarray
              ) -> Tuple[Dict, torch.Tensor]:
        """One token for every slot; inactive slots keep their offset (their
        rows are rewritten at the same slot and stay unread)."""
        logits, new_cache = forward_step(
            self.params, toks[:, None], self.cfg, cache
        )
        nxt = self._pick(logits[:, -1, :], self._gen)
        act = torch.from_numpy(active).to(self.device)
        new_cache["offset"] = torch.where(
            act, new_cache["offset"], cache["offset"]
        )
        return new_cache, nxt

    def serve(self, prompts, max_new_tokens: int, on_finish=None,
              on_token=None, shared_prefix=None) -> list:
        """Decode every prompt (a list of 1-D int arrays); returns a list of
        1-D int32 arrays (prompt + continuation, EOS included).

        ``on_finish(rid, tokens)`` fires when request ``rid`` (its index)
        completes; ``on_token(rid, token)`` fires for every emitted token,
        the first (sampled at prefill) included."""
        if shared_prefix is not None:
            raise NotImplementedError(
                f"prefix caching (shared_prefix) comes with {SERVING_SLICE}"
            )
        items = []
        for rid, prompt in enumerate(prompts):
            try:
                p = self._as_prompt(prompt)
                self.check_capacity(len(p), max_new_tokens)
            except ValueError as e:
                raise ValueError(f"request {rid}: {e}") from None
            items.append((rid, p, int(max_new_tokens)))
        with self._pending_mu:
            if self._pending:
                raise RuntimeError(
                    f"serve() cannot run with {len(self._pending)} "
                    "incremental submission(s) queued; drain or cancel "
                    "them first (serve()/serve_incremental are exclusive "
                    "modes)"
                )
            self._pending.extend(items)
        results = self._run(on_finish=on_finish, on_token=on_token)
        return [results[i] for i in range(len(items))]

    def serve_incremental(self, tick=None, on_finish=None, on_token=None,
                          idle_wait: float = 0.002) -> dict:
        """Serve requests fed in by :meth:`submit`.  ``tick()`` runs once
        per loop turn (the admission point); returning ``False`` drains
        the loop: admitted and already submitted requests finish, then
        the call returns.  Completions are delivered through
        ``on_finish`` only; returns {}."""
        return self._run(on_finish=on_finish, on_token=on_token,
                         tick=tick, idle_wait=idle_wait)

    @torch.inference_mode()
    def _run(self, on_finish=None, on_token=None, tick=None,
             idle_wait: float = 0.002) -> dict:
        """The decode loop of :meth:`serve` (the queue is filled up front
        and runs to drain) and :meth:`serve_incremental` (``tick`` feeds
        it).  Every request carries its own max_new_tokens budget."""
        self.last_stats = {}
        B = self.slots
        cache = init_cache(self.cfg, B, self.max_len, device=self.device)
        cache["offset"] = torch.zeros(B, dtype=torch.long,
                                      device=self.device)
        toks = torch.zeros(B, dtype=torch.long, device=self.device)
        active = np.zeros(B, bool)
        slot_req: list = [None] * B
        slot_prompt: list = [None] * B
        slot_out: list = [None] * B
        budget = [0] * B
        results: Dict[Any, np.ndarray] = {}
        counts = {"rounds": 0, "emitted": 0, "prefills": 0, "forwards": 0}

        def free(s):
            active[s] = False
            slot_req[s] = slot_prompt[s] = slot_out[s] = None

        def finish(s):
            rid = slot_req[s]
            out = np.concatenate(
                [slot_prompt[s], np.asarray(slot_out[s], np.int32)]
            )
            if tick is None:
                # Batch mode returns the results; the incremental loop
                # delivers through on_finish only (a long-lived replica
                # would otherwise retain every completion).
                results[rid] = out
            free(s)
            if on_finish is not None:
                on_finish(rid, out)

        def admit(s, item):
            rid, prompt, mnt = item
            first, calls = self._prefill(cache, s, prompt)
            counts["prefills"] += 1
            counts["forwards"] += calls
            toks[s] = first
            first = int(first)
            active[s] = True
            slot_req[s] = rid
            slot_prompt[s] = prompt
            slot_out[s] = [first]
            budget[s] = mnt - 1
            if on_token is not None:
                on_token(rid, first)
            if first == self.eos_token or budget[s] <= 0:
                finish(s)

        def emit(nxt):
            """Append each active slot's new token; EOS or an exhausted
            budget finishes the slot.  Returns tokens appended."""
            appended = 0
            for s in range(B):
                if not active[s]:
                    continue
                t = int(nxt[s])
                slot_out[s].append(t)
                appended += 1
                budget[s] -= 1
                if on_token is not None:
                    on_token(slot_req[s], t)
                if t == self.eos_token or budget[s] <= 0:
                    finish(s)
            return appended

        def publish_stats():
            rounds, emitted = counts["rounds"], counts["emitted"]
            self.last_stats = {
                "path": "plain",
                "rounds": rounds,
                "emitted_tokens": emitted,
                "tokens_per_round": emitted / rounds if rounds else 0.0,
                "occupancy": float(active.sum()) / max(1, B),
                "prefills": counts["prefills"],
                "forwards": counts["forwards"],
            }

        self._live_active = active
        self._live_slot_req = slot_req
        try:
            while True:
                publish_stats()
                keep = True
                if tick is not None:
                    keep = tick() is not False
                if self._abort_rids:
                    with self._pending_mu:
                        doomed, self._abort_rids = self._abort_rids, set()
                    for s in range(B):
                        if active[s] and slot_req[s] in doomed:
                            free(s)
                for s in range(B):
                    if not active[s]:
                        item = self._pop_pending()
                        if item is None:
                            break
                        admit(s, item)
                if not active.any():
                    if self.pending_count() == 0:
                        if tick is None or not keep:
                            break
                        time.sleep(idle_wait)
                    continue
                cache, toks = self._step(cache, toks, active)
                counts["rounds"] += 1
                counts["forwards"] += 1
                counts["emitted"] += emit(toks.cpu().numpy())
        finally:
            self._live_active = None
            self._live_slot_req = None
        publish_stats()
        return results
