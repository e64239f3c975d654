"""The gateway's instruments and its /metrics endpoint — the port's own
copy of ``CounterSet`` (``dlrover_tpu/agent/metrics.py:22``), ``StatSet``
(``:62``), ``Histogram`` (``:95``, with ``register_gauges`` ``:280``),
``MetricsRegistry`` (``:291``, Prometheus text exposition) and
``MetricsServer`` (``:370``, stdlib ``http.server``), with the same
arithmetic and the same text.  The tier gateways serve it
(``serving/tier.py``); the agent's own endpoint
(``DLROVER_TPU_METRICS_PORT``) and its gauges stay refused with the
``rest`` item of ``common/constants.py``.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common.log import logger

PREFIX = "dlrover_tpu"


class CounterSet:
    """Monotonic named counters, thread-safe, sampled by gauges.

    Process-global instances (``integrity_counters``) let deep layers
    (checkpoint engine, replica exchange, saver) count rare-but-serious
    events without holding a registry reference; the agent registers one
    gauge per name at startup so the counts reach Prometheus."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            val = self._counts.get(name, 0) + n
            self._counts[name] = val
            return val

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class StatSet:
    """Last-value named stats, thread-safe, sampled by gauges — the
    peer of :class:`CounterSet` for non-monotonic signals (latencies,
    throughputs) that deep layers set and the agent exposes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vals: Dict[str, float] = {}

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._vals[name] = float(value)

    def get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._vals.get(name, default)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)


class Histogram:
    """Fixed-bucket latency histogram, thread-safe — the gateway's
    request-latency / TTFT instrument.  Prometheus-shaped:
    ``observe`` increments the first bucket whose upper bound holds the
    value; ``percentile`` answers with that bucket's upper bound (the
    standard conservative bucketed estimate), so p50/p95/p99 gauges are
    O(buckets) at scrape time with no per-observation allocation."""

    #: Default bounds in milliseconds: sub-ms through 30s.
    DEFAULT_BUCKETS_MS = (
        1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
        1000.0, 2000.0, 5000.0, 10000.0, 30000.0,
    )

    def __init__(self, buckets=DEFAULT_BUCKETS_MS,
                 window_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._bounds = tuple(sorted(float(b) for b in buckets))
        # RLock: _roll_locked re-takes it under the public methods'
        # hold, keeping every state write lexically inside a lock.
        self._lock = threading.RLock()
        self._counts = [0] * (len(self._bounds) + 1)  # +inf tail
        self._total = 0
        self._sum = 0.0
        #: ``window_s``: percentiles cover the current + previous
        #: window only, instead of the process lifetime.  A signal that
        #: drives CONTROL (the autoscaler's TTFT pressure) must decay:
        #: a cumulative histogram ratchets — one bad cold-start period
        #: keeps p95 above threshold ~forever and the fleet would scale
        #: up and never back down.
        self._window_s = window_s
        self._clock = clock
        self._epoch_start = clock()
        self._prev_counts = [0] * (len(self._bounds) + 1)
        self._prev_total = 0
        self._prev_sum = 0.0

    def _roll_locked(self) -> None:
        with self._lock:  # re-entrant under the public methods' hold
            if self._window_s is None:
                return
            now = self._clock()
            elapsed = now - self._epoch_start
            if elapsed < self._window_s:
                return
            fresh = [0] * (len(self._bounds) + 1)
            if elapsed < 2 * self._window_s:
                # Current window ages into "previous"; observations
                # older than that fall out.
                self._prev_counts = self._counts
                self._prev_total = self._total
                self._prev_sum = self._sum
            else:
                # Idle for 2+ windows: everything has aged out.
                self._prev_counts = list(fresh)
                self._prev_total = 0
                self._prev_sum = 0.0
            self._counts = fresh
            self._total = 0
            self._sum = 0.0
            self._epoch_start = now

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        for i, b in enumerate(self._bounds):  # noqa: B007
            if v <= b:
                break
        else:
            i = len(self._bounds)
        with self._lock:
            self._roll_locked()
            self._counts[i] += 1
            self._total += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            self._roll_locked()
            return self._total + self._prev_total

    def mean(self) -> float:
        with self._lock:
            self._roll_locked()
            total = self._total + self._prev_total
            return (self._sum + self._prev_sum) / total if total else 0.0

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket containing the p-quantile (p in
        [0, 1]) over the covered span (lifetime, or the last 1-2
        windows when ``window_s`` is set).  Values past the last bound
        report that bound — the histogram saturates rather than
        guessing at the tail."""
        with self._lock:
            self._roll_locked()
            total = self._total + self._prev_total
            if not total:
                return 0.0
            rank = p * total
            seen = 0
            for i in range(len(self._counts)):
                c = self._counts[i] + self._prev_counts[i]
                seen += c
                if seen >= rank and c:
                    return self._bounds[min(i, len(self._bounds) - 1)]
            return self._bounds[-1]

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean": round(self.mean(), 3),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def state(self) -> Dict[str, object]:
        """Mergeable wire form: bucket bounds + the counts
        covering the live window span (current + previous window,
        rolled first so aged-out observations are excluded).  This is
        what one gateway of a sharded tier ships in its stats snapshot
        — percentiles themselves are NOT mergeable (averaging two p95s
        whipsaws the autoscaler); bucket counts are."""
        with self._lock:
            self._roll_locked()
            return {
                "bounds": list(self._bounds),
                "counts": [
                    c + p for c, p in
                    zip(self._counts, self._prev_counts)
                ],
                "total": self._total + self._prev_total,
                "sum": self._sum + self._prev_sum,
            }

    def merge(self, other) -> None:
        """Fold another histogram (or a :meth:`state` dict) into this
        one, bucket-wise.  Window-aware on both sides: ``other``'s
        state covers only its live windows, and the merged counts land
        in THIS histogram's current window (so they age out on this
        instance's clock).  Bounds must match exactly — merging
        differently-bucketed histograms would silently misbin.

        The tier aggregator builds a FRESH histogram per pass and
        merges every gateway's state into it, so counts are never
        double-folded across passes."""
        st = other.state() if isinstance(other, Histogram) else other
        if list(st.get("bounds", [])) != list(self._bounds):
            raise ValueError(
                f"histogram bounds mismatch: {st.get('bounds')} != "
                f"{list(self._bounds)}"
            )
        counts = st["counts"]
        if len(counts) != len(self._counts):
            raise ValueError(
                f"histogram count vector length {len(counts)} != "
                f"{len(self._counts)}"
            )
        with self._lock:
            self._roll_locked()
            for i, c in enumerate(counts):
                self._counts[i] += int(c)
            self._total += int(st["total"])
            self._sum += float(st["sum"])

    @classmethod
    def merged(cls, states, buckets=None) -> "Histogram":
        """A fresh (windowless) histogram holding the bucket-wise sum
        of ``states`` (:meth:`state` dicts and/or Histograms); empty
        input yields an empty histogram over the default buckets."""
        states = list(states)
        if buckets is None:
            for st in states:
                src = st.state() if isinstance(st, Histogram) else st
                if src.get("bounds"):
                    buckets = tuple(src["bounds"])
                    break
            else:
                buckets = cls.DEFAULT_BUCKETS_MS
        agg = cls(buckets=buckets)
        for st in states:
            agg.merge(st)
        return agg

    def register_gauges(self, registry: "MetricsRegistry",
                        name: str) -> None:
        """Expose count/p50/p95/p99 as ``<name>_*`` gauges."""
        registry.gauge(f"{name}_count", lambda: float(self.count))
        for q, label in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
            registry.gauge(
                f"{name}_{label}_ms",
                lambda q=q: self.percentile(q),
            )


class MetricsRegistry:
    """Name -> callable returning a float (sampled at scrape time)."""

    #: Consecutive scrape failures before a gauge's callback failure is
    #: promoted from per-scrape debug to a once-per-gauge WARNING: one
    #: blip during startup is noise, a gauge that never answers is a
    #: blind spot an operator believes is being watched.
    FAIL_PROMOTE_AFTER = 3

    def __init__(self):
        self._lock = threading.Lock()
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._overwrite_warned: set = set()
        self._fail_streak: Dict[str, int] = {}
        self._fail_warned: set = set()

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            if name in self._gauges and \
                    name not in self._overwrite_warned:
                # Two subsystems exporting the same name means one of
                # them is unknowingly dark.  Warn ONCE per name
                # (re-registration is also a legitimate restart idiom).
                self._overwrite_warned.add(name)
                logger.warning(
                    "metrics: gauge %r re-registered; previous "
                    "callback replaced (this warning fires once per "
                    "name)", name,
                )
            self._gauges[name] = fn

    def set(self, name: str, value: float) -> None:
        """Pin a constant value.  Repeated sets UPDATE by design (the
        last-value idiom) — no overwrite warning."""
        with self._lock:
            self._gauges[name] = lambda v=value: v

    def render(self) -> str:
        lines = []
        with self._lock:
            items = list(self._gauges.items())
        for name, fn in items:
            try:
                val = float(fn())
            except Exception as e:  # noqa: BLE001
                # A broken gauge callback should not kill the scrape;
                # one that fails PERSISTENTLY is promoted to a
                # once-per-gauge warning.
                with self._lock:
                    streak = self._fail_streak.get(name, 0) + 1
                    self._fail_streak[name] = streak
                    promote = (
                        streak >= self.FAIL_PROMOTE_AFTER
                        and name not in self._fail_warned
                    )
                    if promote:
                        self._fail_warned.add(name)
                if promote:
                    logger.warning(
                        "metrics: gauge %s has failed %d consecutive "
                        "scrapes (%s) — it is exporting NOTHING",
                        name, streak, e,
                    )
                else:
                    logger.debug("metrics: gauge %s failed: %s",
                                 name, e)
                continue
            with self._lock:
                if self._fail_streak.pop(name, None):
                    # Recovered: a later relapse deserves a new warning.
                    self._fail_warned.discard(name)
            lines.append(f"# TYPE {PREFIX}_{name} gauge")
            lines.append(f"{PREFIX}_{name} {val}")
        return "\n".join(lines) + "\n"


class MetricsServer:
    def __init__(self, registry: MetricsRegistry, port: int = 0):
        self.registry = registry
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = reg.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request logs
                pass

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="metrics-http",
                daemon=True,
            )
            self._thread.start()
            logger.info("metrics endpoint on :%d/metrics", self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
