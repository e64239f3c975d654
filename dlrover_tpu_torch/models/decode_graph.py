"""The decode dispatch as one CUDA graph: capture once, replay every round.

The port's counterpart of the reference's jitted decode programs in
``dlrover_tpu/models/llama_infer.py`` ``DecodeServer.__init__``:
``jax.jit(step)``, ``jax.jit(chunk_step)`` (``decode_chunk`` steps under one
``lax.scan``) and their paged variants ``jax.jit(step_paged)`` /
``jax.jit(chunk_step_paged)``.  XLA runs each of those as one compiled
program a dispatch; PyTorch runs eagerly, and a 7B decode step issues a few
thousand kernel launches from the host, which is what bounds it.  A CUDA
graph records those launches once and replays them with one call.

:class:`DecodeGraph` wraps a function ``fn()`` that reads and writes only
*static* device tensors: buffers made before the capture that live as long
as the graph, which the caller refreshes in place (``copy_``, indexed
writes) before each call and reads after it.  On a CPU device ``fn`` runs
eagerly at every call, as every plain path does there.  On a CUDA device
the first call warms ``fn`` up once on a side stream (that run builds the
kernels' libraries, creates cuBLAS's handles and is a real run of ``fn``),
captures it, and every call after that replays the graph.  A capture or a
replay that fails raises; nothing falls back to eager on the card.

Launch counts.  A kernel wrapper counts its launches by Python calls
(``rmsnorm.launches``); a replay makes no Python call.  During the capture
each wrapper in ``counted`` is called, records its kernel as a node of the
graph and adds to its count, although nothing ran.  :meth:`capture` takes
that change as :attr:`recorded` (per wrapper name: the nodes one replay
launches) and takes it back off the wrapper's count, so a count holds only
launches that ran eagerly.  The launches of a run are then the wrapper's
count plus ``recorded[name] * replays``.

Sampling.  A sampled step draws from the caller's ``torch.Generator``.
That generator is registered with the graph
(``CUDAGraph.register_generator_state``), so each replay advances it and
draws fresh noise, as the reference draws a fresh subkey each dispatch; an
unregistered generator would replay the capture's draw every round.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch


class DecodeGraph:
    """``fn()`` captured once as a CUDA graph and replayed at every call (on
    a CUDA device), or run eagerly (on the CPU)."""

    def __init__(self, fn: Callable[[], None], device: torch.device, *,
                 generator: Optional[torch.Generator] = None,
                 counted: Sequence[Callable] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.generator = generator
        self.counted = tuple(counted)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        #: Wrapper name -> kernel launches one replay makes.
        self.recorded: Dict[str, int] = {}
        #: Replays since the capture.
        self.replays = 0
        #: Host seconds of the warm-up run and the capture.
        self.capture_s: Optional[float] = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self) -> None:
        """Warm ``fn`` up once on a side stream, then capture it."""
        if self.device.type != "cuda":
            raise ValueError(
                f"a CUDA graph needs a CUDA device, got {self.device}"
            )
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = [w.launches for w in self.counted]
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.fn()
        finally:
            recorded = {}
            for w, n in zip(self.counted, before):
                recorded[w.__name__] = w.launches - n
                w.launches = n
        torch.cuda.synchronize(self.device)
        self.recorded = recorded
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self) -> None:
        if self.device.type == "cpu":
            self.fn()
            return
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
