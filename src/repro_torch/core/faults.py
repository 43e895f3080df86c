"""Failure-domain chaos layer: deterministic fault injection + typed
recovery primitives.

EPD disaggregation multiplies failure domains: the E->P feature store
can lose entries, the P->D transfer fabric can drop a group's handshake
or its wire payload, a Decode instance can vanish mid-stream, and the
host swap tier can lose a preempted request's pages. This module is the
single fault *plane* across all of them:

* :class:`FaultPlan` / :class:`FaultInjector` — a seeded, deterministic
  description of which faults fire where. Faults arm at named *sites*
  (``SITE_*`` constants); each site supports a per-check probability
  (``rates``), explicitly armed one/multi-shot faults (``armed``), and a
  per-site total cap (``max_faults``). Every decision is a pure function
  of ``(seed, site, key, attempt)`` — replaying the same plan against
  the same call keys reproduces the same faults bit-for-bit, regardless
  of call order across sites. That is what makes chaos sweeps, CI smoke
  jobs, and "outputs bit-identical to the zero-fault run" acceptance
  tests possible.

* :class:`RetryPolicy` — typed retry/backoff: bounded attempts, capped
  exponential backoff with *seeded* jitter (deterministic per
  ``(seed, key, attempt)``), and a per-request retry-time deadline. The
  recovery arms (store refetch, transfer re-handshake/resend, swap
  re-fault) charge its delays through the CostModel into simulator and
  cluster latency accounting, so recovery is never free.

* the typed error hierarchy — :class:`FaultError` and its subclasses
  (:class:`TransferError`, :class:`StoreMiss`, :class:`InstanceDown`,
  :class:`SwapLost`, :class:`NoFreeSlot`, :class:`PlanError`), joining
  the existing ``serving.kv_pool.PoolExhausted`` precedent: recovery
  code dispatches on types and typed fields, never on message text.
  Everything subclasses RuntimeError (PlanError additionally
  ValueError) so pre-existing ``except RuntimeError`` / string-match
  callers keep working.

Recovery arms per failure domain (who consumes this module):

=====================  ====================================================
failure domain          recovery arm
=====================  ====================================================
store.fetch            retry w/ backoff, then §3.2 local recompute
                       (``EPDCluster.prefill`` / ``EPPrefetcher``)
transfer.handshake /   per-group re-handshake/resend w/ backoff, then a
transfer.wire          fresh grouped plan for only the missing groups
                       (``kv_transfer.recover_plan``)
decode.crash           cross-instance re-route: re-prefill rides the
                       prefix cache, decode resumes at the exact position
                       (``EPDCluster``)
swap.in                radix re-match + suffix recompute of the lost
                       private pages (``Engine._resume`` re-fault path)
=====================  ====================================================
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Fault sites
# ---------------------------------------------------------------------------

SITE_STORE_FETCH = "store.fetch"            # MM-store feature fetch loss
SITE_TRANSFER_HANDSHAKE = "transfer.handshake"  # P->D group handshake drop
SITE_TRANSFER_WIRE = "transfer.wire"        # P->D group wire/payload loss
SITE_DECODE_CRASH = "decode.crash"          # decode instance dies mid-stream
SITE_SWAP_IN = "swap.in"                    # host swap tier loses a handle

SITES = frozenset({SITE_STORE_FETCH, SITE_TRANSFER_HANDSHAKE,
                   SITE_TRANSFER_WIRE, SITE_DECODE_CRASH, SITE_SWAP_IN})


# ---------------------------------------------------------------------------
# Typed error hierarchy
# ---------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base of the typed failure-domain errors. Subclasses RuntimeError
    so legacy ``except RuntimeError`` recovery paths keep catching; new
    code dispatches on the subclass and its typed fields instead of
    message text (the ``PoolExhausted`` precedent)."""

    site: str = ""


class TransferError(FaultError):
    """A P->D transfer group could not be delivered within the retry
    policy (handshake or wire faults exhausted every attempt, including
    the fresh-replan fallback)."""

    def __init__(self, site: str, group: int, attempts: int):
        self.site = site
        self.group = int(group)
        self.attempts = int(attempts)
        super().__init__(
            f"transfer group {group} lost at {site} after "
            f"{attempts} attempts")


class StoreMiss(FaultError):
    """A keyed MM-store fetch found no (or a faulted) entry. The typed
    arm: retry per policy, then take the §3.2 local-recompute path."""

    site = SITE_STORE_FETCH

    def __init__(self, key: str, attempts: int = 1):
        self.key = key
        self.attempts = int(attempts)
        super().__init__(
            f"MM store miss for key {key!r} after {attempts} attempts")


class InstanceDown(FaultError):
    """A serving instance (typically Decode) crashed / left the cluster.
    Recovery re-routes its in-flight requests to a surviving instance."""

    site = SITE_DECODE_CRASH

    def __init__(self, instance: str, n_requests: int = 0):
        self.instance = str(instance)
        self.n_requests = int(n_requests)
        super().__init__(
            f"instance {instance} down ({n_requests} in-flight requests)")


class SwapLost(FaultError):
    """The host swap tier lost (or corrupted) a preempted request's
    pages: the handle is consumed and the KV content is gone. Recovery
    re-faults via radix re-match + suffix recompute from the request's
    known token sequence."""

    site = SITE_SWAP_IN

    def __init__(self, handle_id: int, n_pages: int):
        self.handle_id = int(handle_id)
        self.n_pages = int(n_pages)
        super().__init__(
            f"swap handle {handle_id} lost ({n_pages} pages of KV "
            f"unrecoverable from host store)")


class NoFreeSlot(FaultError):
    """Decode admission found no free batch slot (typed replacement for
    the string-raised RuntimeError; the message is kept verbatim for
    legacy ``match=`` callers)."""

    def __init__(self, msg: str = "no free decode slot"):
        super().__init__(msg)


class PlanError(FaultError, ValueError):
    """Invalid transfer-plan input (negative/zero bytes, empty segment
    lists, nonpositive group sizes/bandwidth). Subclasses ValueError so
    legacy ``except ValueError`` callers keep working."""


# ---------------------------------------------------------------------------
# Deterministic fault plane
# ---------------------------------------------------------------------------

def _unit(seed: int, site: str, key: Any, attempt: int) -> float:
    """Uniform [0, 1) draw that is a pure function of its arguments —
    stable across processes and call order (sha256, not ``hash``)."""
    blob = repr((int(seed), site, key, int(attempt))).encode()
    h = hashlib.sha256(blob).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass
class ArmedFault:
    """One explicitly scheduled fault: fires on the next ``count``
    checks of ``site`` whose key matches (``key=None`` matches any)."""

    site: str
    key: Any = None
    count: int = 1


@dataclass
class FaultPlan:
    """Declarative, seeded fault schedule (the serializable config the
    chaos suite and benchmarks pin).

    seed        — drives every probabilistic draw and all backoff jitter.
    rates       — site -> per-check fault probability in [0, 1].
    armed       — explicit one/multi-shot faults (see ArmedFault).
    max_faults  — site -> cap on total *rate-based* fires (armed faults
                  are already counted); 0/absent = uncapped.
    """

    seed: int = 0
    rates: Dict[str, float] = field(default_factory=dict)
    armed: List[ArmedFault] = field(default_factory=list)
    max_faults: Dict[str, int] = field(default_factory=dict)

    def validate(self) -> "FaultPlan":
        for site, r in self.rates.items():
            if site not in SITES:
                raise PlanError(f"unknown fault site {site!r} "
                                f"(known: {sorted(SITES)})")
            if not (0.0 <= r <= 1.0):
                raise PlanError(f"fault rate for {site} must be in "
                                f"[0, 1], got {r}")
        for a in self.armed:
            if a.site not in SITES:
                raise PlanError(f"unknown fault site {a.site!r}")
            if a.count < 1:
                raise PlanError(f"armed fault count must be >= 1, "
                                f"got {a.count}")
        for site, n in self.max_faults.items():
            if site not in SITES:
                raise PlanError(f"unknown fault site {site!r}")
            if n < 0:
                raise PlanError(f"max_faults[{site}] must be >= 0")
        return self


@dataclass
class FaultStats:
    checks: Dict[str, int] = field(default_factory=dict)
    fired: Dict[str, int] = field(default_factory=dict)

    def record(self, site: str, fired: bool) -> None:
        self.checks[site] = self.checks.get(site, 0) + 1
        if fired:
            self.fired[site] = self.fired.get(site, 0) + 1

    def n_fired(self, site: Optional[str] = None) -> int:
        if site is not None:
            return self.fired.get(site, 0)
        return sum(self.fired.values())


class FaultInjector:
    """Runtime half of the fault plane: subsystems ask
    ``should_fail(site, key, attempt)`` at their instrumented sites and
    get deterministic answers.

    Armed faults fire first (matched by key, decremented per fire);
    probabilistic faults draw from ``_unit(seed, site, key, attempt)``
    so a *retry* of the same operation (attempt+1) re-draws — transient
    faults can heal under retry, which is what the backoff arms exploit.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, metrics=None):
        self.plan = (plan or FaultPlan()).validate()
        self._armed: List[ArmedFault] = [replace(a) for a in self.plan.armed]
        self._rate_fired: Dict[str, int] = {}
        self.stats = FaultStats()
        # optional telemetry registry (core.telemetry.MetricsRegistry):
        # mirrors FaultStats into labeled counters so chaos runs show up
        # in the unified metrics snapshot. Duck-typed to avoid an import
        # cycle (telemetry must stay dependency-free).
        self.metrics = metrics

    def _record(self, site: str, fired: bool) -> None:
        self.stats.record(site, fired)
        if self.metrics is not None:
            self.metrics.counter("fault_checks_total", site=site).inc()
            if fired:
                self.metrics.counter("faults_fired_total", site=site).inc()

    # -- arming (the MMStore.inject_fault generalization) --------------------
    def arm(self, site: str, key: Any = None, count: int = 1) -> None:
        """Explicitly schedule ``count`` faults at ``site`` for checks
        matching ``key`` (None = any). Multi-shot and per-site, unlike
        the legacy one-shot ``MMStore.inject_fault`` it generalizes."""
        if site not in SITES:
            raise PlanError(f"unknown fault site {site!r}")
        if count < 1:
            raise PlanError(f"armed fault count must be >= 1, got {count}")
        self._armed.append(ArmedFault(site, key, count))

    @property
    def armed_remaining(self) -> int:
        return sum(a.count for a in self._armed)

    # -- the decision point ---------------------------------------------------
    def should_fail(self, site: str, key: Any = None,
                    attempt: int = 0) -> bool:
        if site not in SITES:
            raise PlanError(f"unknown fault site {site!r}")
        for a in self._armed:
            if a.site == site and (a.key is None or a.key == key):
                a.count -= 1
                if a.count <= 0:
                    self._armed.remove(a)
                self._record(site, True)
                return True
        rate = self.plan.rates.get(site, 0.0)
        if rate > 0.0:
            cap = self.plan.max_faults.get(site, 0)
            if not cap or self._rate_fired.get(site, 0) < cap:
                if _unit(self.plan.seed, site, key, attempt) < rate:
                    self._rate_fired[site] = \
                        self._rate_fired.get(site, 0) + 1
                    self._record(site, True)
                    return True
        self._record(site, False)
        return False

    def n_fired(self, site: Optional[str] = None) -> int:
        return self.stats.n_fired(site)


# ---------------------------------------------------------------------------
# Typed retry/backoff policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with capped exponential backoff and seeded jitter.

    max_attempts — total tries including the first (1 = no retry).
    backoff_base — delay before the first retry, seconds.
    backoff_mult — exponential growth per further retry.
    backoff_cap  — upper bound on any single backoff delay.
    jitter       — +/- fraction of the delay, drawn deterministically
                   from (seed, key, attempt) so schedules replay.
    deadline     — per-request budget of *cumulative retry time*
                   (backoffs + wasted attempts); recovery escalates to
                   the next arm (replan / recompute / re-route) once the
                   budget is spent instead of retrying forever.
    """

    max_attempts: int = 4
    backoff_base: float = 2e-3
    backoff_mult: float = 2.0
    backoff_cap: float = 50e-3
    jitter: float = 0.1
    deadline: float = math.inf
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise PlanError(f"max_attempts must be >= 1, "
                            f"got {self.max_attempts}")
        if self.backoff_base < 0 or self.backoff_cap < 0:
            raise PlanError("backoff_base/backoff_cap must be >= 0")
        if self.backoff_mult < 1.0:
            raise PlanError(f"backoff_mult must be >= 1, "
                            f"got {self.backoff_mult}")
        if not (0.0 <= self.jitter <= 1.0):
            raise PlanError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.deadline < 0:
            raise PlanError(f"deadline must be >= 0, got {self.deadline}")

    def backoff(self, attempt: int, key: Any = None) -> float:
        """Delay before retry number ``attempt`` (1-based: the wait
        after the ``attempt``-th failure), capped, with seeded jitter."""
        if attempt < 1:
            raise PlanError(f"backoff attempt must be >= 1, got {attempt}")
        d = min(self.backoff_cap,
                self.backoff_base * self.backoff_mult ** (attempt - 1))
        if self.jitter:
            u = _unit(self.seed, "retry.jitter", key, attempt)
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return d

    def next_retry_at(self, now: float, attempt: int,
                      key: Any = None) -> Optional[float]:
        """Non-blocking variant of :meth:`backoff`: the absolute clock
        time retry number ``attempt`` may run, or None when the policy
        is exhausted (``attempt`` would exceed ``max_attempts`` — the
        caller escalates to the next recovery arm instead of parking).
        A scheduler parks the failed operation with this clock as a
        ``retry_at`` barrier and composes the plan around it, rather
        than sleeping through the backoff in a synchronous retry loop."""
        if attempt >= self.max_attempts:
            return None
        return now + self.backoff(attempt, key=key)

    def worst_case_retry_time(self) -> float:
        """Upper bound on the cumulative backoff of one operation —
        what a latency SLO must absorb per recovery (benchmarks assert
        TTFT inflation stays within a small multiple of this)."""
        t = sum(min(self.backoff_cap,
                    self.backoff_base * self.backoff_mult ** (a - 1))
                * (1.0 + self.jitter)
                for a in range(1, self.max_attempts))
        return min(t, self.deadline)


DEFAULT_RETRY = RetryPolicy()
NO_RETRY = RetryPolicy(max_attempts=1)
