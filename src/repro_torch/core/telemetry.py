"""Stage-level telemetry: span tracer, unified metrics registry, and
per-request latency attribution.

The paper's headline claims are SLO claims (TTFT < 2 s, TPOT < 50 ms
under E/P/D disaggregation), so the serving stack needs to answer not
just *whether* a request met its deadline but *where its time went*.
This module is the single observability plane shared by the real
``Engine``/``EPDCluster`` (wall time) and the ``Simulator`` (simulated
time), three layers deep:

* :class:`Tracer` — an allocation-light span recorder.
  ``tracer.span(name, request_id=..., **attrs)`` is a context manager
  around a pipeline phase (a prefill chunk, a decode step, a swap-out);
  ``tracer.add(...)`` records spans with *modeled* timestamps (transfer
  groups, retry backoffs — things that never run on this host's clock).
  A disabled tracer (the default) returns a shared no-op context
  manager: zero allocations, zero recorded spans, zero behavior change.
  Spans carry a ``track`` (one per engine instance / link) so the
  Chrome-trace exporter (``core.trace_export``) renders one timeline
  row per instance.

* :class:`MetricsRegistry` — labeled counters / gauges / histograms.
  The ad-hoc counters that used to live on ``Engine`` (refault pages,
  swap totals), ``ClusterReport`` (retry counts, retry time) and
  ``PagePool`` (peak occupancy) now live here under stable names; the
  old attribute names survive as read-through properties. One registry
  per cluster/simulator run; ``snapshot()`` is JSON-able and lands in
  every ``BENCH_*.json`` under the ``"telemetry"`` key.

* :class:`LatencyAccountant` — per-request latency attribution. Every
  request's end-to-end latency is decomposed into the five
  :data:`COMPONENTS` (queue / compute / transfer / swap / retry) on a
  single accounting clock, with the structural invariant that the
  components sum to the end-to-end measurement: every clock advance —
  a wall-time segment (``sync``) or a modeled charge (``advance``) —
  is charged to *every* open request under its current state, so no
  interval of a request's lifetime is ever unattributed.
  ``mark_first_token`` snapshots the components at the TTFT gate,
  giving separate TTFT and TPOT decompositions.

:func:`quantile` is the one histogram-quantile implementation (linear
interpolation, correct at n == 0 and n == 1) reused by ``SimMetrics``
and the benchmark suite.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# The five latency components every request's end-to-end time is
# attributed to. "queue" is any time spent waiting for a resource
# (ingress queue, decode admission, parked-preempted); "compute" is
# encode/prefill/decode service time; "transfer" is exposed P->D KV
# movement (the part not hidden under compute); "swap" is preemption
# swap-out/in + re-fault work; "retry" is fault-recovery backoff and
# wasted attempts charged by the chaos layer.
COMPONENTS = ("queue", "compute", "transfer", "swap", "retry")


# ---------------------------------------------------------------------------
# Quantiles
# ---------------------------------------------------------------------------

def quantile(xs, p: float) -> float:
    """Linear-interpolation quantile of ``xs`` (need not be sorted).

    Correct at the edges the old ad-hoc helpers got wrong: an empty
    input returns 0.0 (not an IndexError), a single sample returns that
    sample for every ``p``, and ``p`` outside [0, 1] clamps. This is
    the single implementation behind ``Histogram.quantile``,
    ``SimMetrics`` p99s, and the benchmark reports.
    """
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    if n == 1:
        return float(xs[0])
    p = min(1.0, max(0.0, float(p)))
    pos = p * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(xs[lo]) * (1.0 - frac) + float(xs[hi]) * frac


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic labeled counter (floats allowed: retry *time* is a
    counter too — it only ever accumulates)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {v}")
        self.value += v


class Gauge:
    """Last-written-value gauge (pool occupancy, hit rates)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def max(self, v: float) -> None:
        """High-water-mark update (peak pool occupancy)."""
        if v > self.value:
            self.value = float(v)


class Histogram:
    """Exact-sample histogram: stores observations, answers quantiles
    via :func:`quantile`. Fine at serving-benchmark cardinalities; a
    production system would swap in fixed buckets behind the same API."""

    __slots__ = ("name", "labels", "values")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.values else 0.0

    def quantile(self, p: float) -> float:
        return quantile(self.values, p)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create registry of labeled metrics.

    ``registry.counter("kv_transfer_retries", site="transfer.wire")``
    returns the same Counter object on every call with the same name
    and label set, so hot paths can cache the handle and ``inc()`` it
    without a lookup. A name must keep one metric type across all its
    label sets.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._types: Dict[str, type] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any]):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            want = self._types.setdefault(name, cls)
            if want is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{want.__name__}, requested {cls.__name__}")
            m = self._metrics[key] = cls(name, key[1])
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge (0.0 when never touched)."""
        m = self._metrics.get((name, _label_key(labels)))
        return m.value if m is not None else 0.0

    def total(self, name: str) -> float:
        """Sum of a counter/gauge across all its label sets."""
        return sum(m.value for (n, _), m in self._metrics.items()
                   if n == name and not isinstance(m, Histogram))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump: every metric keyed ``name{k=v,...}``. This is
        what benchmarks embed under the ``"telemetry"`` key so bench
        deltas can diff component-level counters, not just wall clocks."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), m in sorted(self._metrics.items()):
            key = _fmt_key(name, labels)
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = {
                    "count": m.count, "sum": m.sum, "mean": m.mean,
                    "p50": m.quantile(0.50), "p99": m.quantile(0.99),
                    "max": max(m.values) if m.values else 0.0,
                }
        return out


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One closed interval on one track. ``start``/``end`` are seconds
    on the tracer's clock (wall, accounting, or simulated — the track's
    spans share a timebase, which is all the exporter needs)."""

    name: str
    track: str
    start: float
    end: float
    request_id: Optional[int] = None
    parent: Optional[str] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class _NullSpan:
    """Shared no-op context manager: the disabled tracer's entire cost."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _SpanCM:
    __slots__ = ("_tracer", "_name", "_track", "_rid", "_attrs", "_start",
                 "_parent")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 rid: Optional[int], attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._rid = rid
        self._attrs = attrs

    def __enter__(self):
        t = self._tracer
        self._parent = t._stack[-1] if t._stack else None
        t._stack.append(self._name)
        self._start = t.now()
        return self

    def __exit__(self, *exc):
        t = self._tracer
        t._stack.pop()
        t.spans.append(Span(self._name, self._track, self._start, t.now(),
                            self._rid, self._parent, self._attrs))
        return False


class Tracer:
    """Span recorder. ``enabled=False`` (the default everywhere) makes
    ``span()`` return a shared no-op context manager — no allocation,
    no clock read — so tracing can stay compiled into every hot path.

    ``now`` is the clock: wall time by default, the cluster's accounting
    clock or the simulator's event-loop time when those own the run
    (``set_clock``). ``decode_sample`` thins the highest-frequency span
    family: engines record one batched ``decode_step`` span every N
    steps instead of every step.
    """

    def __init__(self, enabled: bool = False,
                 now: Optional[Callable[[], float]] = None,
                 decode_sample: int = 1):
        if decode_sample < 1:
            raise ValueError(f"decode_sample must be >= 1, "
                             f"got {decode_sample}")
        self.enabled = enabled
        self.now = now if now is not None else time.perf_counter
        self.decode_sample = decode_sample
        self.spans: List[Span] = []
        self._stack: List[str] = []

    def set_clock(self, now: Callable[[], float]) -> None:
        self.now = now

    def span(self, name: str, track: str = "main",
             request_id: Optional[int] = None, **attrs):
        if not self.enabled:
            return NULL_SPAN
        return _SpanCM(self, name, track, request_id, attrs)

    def add(self, name: str, start: float, end: float, track: str = "main",
            request_id: Optional[int] = None, parent: Optional[str] = None,
            **attrs) -> None:
        """Record a span with explicit timestamps — modeled timelines
        (transfer-group schedules, retry backoffs, simulator service
        times) that never ran on this host's clock."""
        if not self.enabled:
            return
        if end < start:
            raise ValueError(f"span {name!r} ends before it starts "
                             f"({end} < {start})")
        self.spans.append(Span(name, track, start, end, request_id,
                               parent, attrs))

    def want_decode_span(self, step: int) -> bool:
        return self.enabled and step % self.decode_sample == 0

    # -- audits ---------------------------------------------------------------
    def assert_balanced(self) -> None:
        """Every opened span must have been closed (the ``with`` block
        exited) and every recorded span must be well-formed. The span
        analogue of the page pool's ``assert_balanced`` leak audit."""
        assert not self._stack, (
            f"unclosed spans: {self._stack} — a span context manager "
            f"was entered but never exited")
        for s in self.spans:
            assert s.end >= s.start, (
                f"span {s.name!r} on {s.track!r} ends before it starts")

    def tracks(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.spans:
            out[s.track] = out.get(s.track, 0) + 1
        return out


NULL_TRACER = Tracer(enabled=False)


# ---------------------------------------------------------------------------
# Latency attribution
# ---------------------------------------------------------------------------

@dataclass
class AttributionRecord:
    """One request's latency decomposition on the accounting clock."""

    request_id: int
    t_open: float
    components: Dict[str, float]
    t_first_token: float = -1.0
    ttft_components: Optional[Dict[str, float]] = None
    t_close: float = -1.0
    n_output_tokens: int = 0

    @property
    def closed(self) -> bool:
        return self.t_close >= 0

    @property
    def e2e(self) -> float:
        """End-to-end latency measured directly on the clock — the
        number the components must sum to."""
        return (self.t_close - self.t_open) if self.closed else -1.0

    @property
    def total(self) -> float:
        return sum(self.components.values())

    @property
    def ttft(self) -> float:
        return (self.t_first_token - self.t_open) \
            if self.t_first_token >= 0 else -1.0

    def decode_components(self) -> Dict[str, float]:
        """Post-first-token share of each component (the TPOT side)."""
        base = self.ttft_components or {c: 0.0 for c in COMPONENTS}
        return {c: self.components[c] - base.get(c, 0.0)
                for c in COMPONENTS}

    def tpot_components_ms(self) -> Dict[str, float]:
        """Per-output-token decode decomposition in milliseconds."""
        n = max(1, self.n_output_tokens - 1)
        return {c: v * 1e3 / n for c, v in self.decode_components().items()}

    def check(self, tol: float = 0.01) -> None:
        """The attribution invariant: components sum to the end-to-end
        measurement within ``tol`` (relative). A failure means some code
        path advanced the clock without charging an open request —
        i.e. unattributed latency."""
        assert self.closed, f"request {self.request_id} never closed"
        gap = abs(self.total - self.e2e)
        assert gap <= tol * max(self.e2e, 1e-9) + 1e-12, (
            f"request {self.request_id}: components sum {self.total:.6f}s "
            f"!= e2e {self.e2e:.6f}s (gap {gap:.6f}s)")

    def as_dict(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id,
            "e2e_ms": round(self.e2e * 1e3, 4),
            "ttft_ms": round(self.ttft * 1e3, 4),
            "components_ms": {c: round(v * 1e3, 4)
                              for c, v in self.components.items()},
            "ttft_components_ms": (
                {c: round(v * 1e3, 4)
                 for c, v in (self.ttft_components or {}).items()}),
        }


class LatencyAccountant:
    """Exhaustive per-request latency ledger on one accounting clock.

    Two clock sources compose into ``now``:

    * ``sync()`` — reads the wall clock and charges the elapsed segment
      (the real cluster calls it at every state transition and after
      every engine step);
    * ``advance(dt, ...)`` — charges *modeled* time (transfer exposure,
      retry backoff, simulated service times). The simulator drives the
      whole accountant this way via ``EventLoop.on_advance``.

    Every charge goes to **all** open requests, each under its current
    state — except that ``advance`` may override one request's
    component (the request the modeled time belongs to, e.g. ``retry``
    for a backoff that everyone else experiences as queueing). That is
    what makes the sum-of-components == e2e invariant structural: no
    clock movement is ever unattributed. ``note`` moves already-charged
    time between a request's components (zero-sum, clamped) for
    after-the-fact reclassification — e.g. the slice of a parked
    request's wait that was really swap traffic.
    """

    def __init__(self, wall: Optional[Callable[[], float]] = None):
        self._wall = wall
        self._last = wall() if wall is not None else 0.0
        self.now = 0.0
        self.records: Dict[int, AttributionRecord] = {}
        self._open: Dict[int, str] = {}
        self._alias: Dict[int, int] = {}

    # -- clock ----------------------------------------------------------------
    def clock(self) -> float:
        """Continuous view of the accounting clock: ``now`` plus the
        wall time elapsed since the last ``sync()`` (as if a sync
        happened this instant). Bind this as the tracer clock so spans
        recorded between syncs land on the same timebase as modeled
        transfer/retry spans. Monotone: ``sync`` folds the elapsed
        segment into ``now`` and resets the reference point."""
        if self._wall is None:
            return self.now
        return self.now + max(0.0, self._wall() - self._last)

    def sync(self) -> None:
        if self._wall is None:
            return
        t = self._wall()
        dt = t - self._last
        self._last = t
        if dt > 0:
            self._charge(dt)

    def _charge(self, dt: float,
                override: Optional[Dict[int, str]] = None) -> None:
        self.now += dt
        for rid, state in self._open.items():
            comp = state
            if override is not None:
                comp = override.get(rid, state)
            self.records[rid].components[comp] += dt

    def advance(self, dt: float, request_id: Optional[int] = None,
                component: Optional[str] = None) -> None:
        """Charge ``dt`` of modeled time: to ``request_id`` under
        ``component`` (when given and open), to every other open
        request under its current state."""
        if dt <= 0:
            return
        override = None
        if request_id is not None and component is not None:
            rid = self._alias.get(request_id, request_id)
            if rid in self._open:
                if component not in COMPONENTS:
                    raise ValueError(f"unknown component {component!r}")
                override = {rid: component}
        self._charge(dt, override)

    # -- request lifecycle ----------------------------------------------------
    def open(self, request_id: int, state: str = "queue") -> None:
        self.sync()
        if request_id in self.records:
            return                      # requeue of a known request
        if state not in COMPONENTS:
            raise ValueError(f"unknown component {state!r}")
        self.records[request_id] = AttributionRecord(
            request_id=request_id, t_open=self.now,
            components={c: 0.0 for c in COMPONENTS})
        self._open[request_id] = state

    def alias(self, alt_id: int, request_id: int) -> None:
        """Attribute charges against ``alt_id`` to ``request_id`` — a
        crash re-route's shadow prefill bills the original request."""
        self._alias[alt_id] = request_id

    def state(self, request_id: int) -> Optional[str]:
        return self._open.get(self._alias.get(request_id, request_id))

    def set_state(self, request_id: int, state: str) -> None:
        rid = self._alias.get(request_id, request_id)
        if rid not in self._open:
            return
        if state not in COMPONENTS:
            raise ValueError(f"unknown component {state!r}")
        self.sync()
        self._open[rid] = state

    def note(self, request_id: int, component: str, amount: float,
             source: str) -> float:
        """Zero-sum reclassification: move up to ``amount`` seconds of
        ``request_id``'s already-charged ``source`` component into
        ``component``. Returns the amount actually moved (clamped to
        the source balance, so the invariant cannot break)."""
        rid = self._alias.get(request_id, request_id)
        rec = self.records.get(rid)
        if rec is None or amount <= 0:
            return 0.0
        if component not in COMPONENTS or source not in COMPONENTS:
            raise ValueError(f"unknown component {component!r}/{source!r}")
        moved = min(float(amount), rec.components[source])
        rec.components[source] -= moved
        rec.components[component] += moved
        return moved

    def mark_first_token(self, request_id: int,
                         n_output_tokens: int = 1) -> None:
        rid = self._alias.get(request_id, request_id)
        rec = self.records.get(rid)
        if rec is None or rec.t_first_token >= 0:
            return
        self.sync()
        rec.t_first_token = self.now
        rec.ttft_components = dict(rec.components)
        rec.n_output_tokens = n_output_tokens

    def close(self, request_id: int, n_output_tokens: int = 0) -> None:
        rid = self._alias.get(request_id, request_id)
        if rid not in self._open:
            return
        self.sync()
        del self._open[rid]
        rec = self.records[rid]
        rec.t_close = self.now
        if n_output_tokens:
            rec.n_output_tokens = n_output_tokens

    # -- reports --------------------------------------------------------------
    @property
    def n_open(self) -> int:
        return len(self._open)

    def assert_all_closed(self) -> None:
        assert not self._open, (
            f"requests still open in the latency ledger: "
            f"{sorted(self._open)}")

    def component_total(self, component: str) -> float:
        if component not in COMPONENTS:
            raise ValueError(f"unknown component {component!r}")
        return sum(r.components[component] for r in self.records.values())

    def check_all(self, tol: float = 0.01) -> None:
        for rec in self.records.values():
            if rec.closed:
                rec.check(tol)

    def report(self) -> Dict[str, Any]:
        """Aggregate attribution report: per-request rows plus mean
        component decomposition (JSON-able — benchmarks embed it)."""
        closed = [r for r in self.records.values() if r.closed]
        mean = {c: 0.0 for c in COMPONENTS}
        for r in closed:
            for c in COMPONENTS:
                mean[c] += r.components[c]
        n = max(1, len(closed))
        return {
            "n_requests": len(closed),
            "mean_components_ms": {c: round(v * 1e3 / n, 4)
                                   for c, v in mean.items()},
            "mean_e2e_ms": round(
                sum(r.e2e for r in closed) * 1e3 / n, 4),
            "requests": [r.as_dict() for r in
                         sorted(closed, key=lambda r: r.request_id)],
        }


def snapshot_json(registry: MetricsRegistry) -> str:
    """Round-trippable snapshot string (CI artifacts, debugging)."""
    return json.dumps(registry.snapshot(), indent=2, sort_keys=True)
