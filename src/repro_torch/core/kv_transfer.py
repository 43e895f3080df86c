"""P->D hierarchical grouped KV-cache transmission (paper §3.3).

Three schemes, matching the paper's ablation:

* ``one_shot``   — transfer the whole KV cache after Prefill completes
  (the naive PD-disaggregation baseline; fully exposed).
* ``layer_wise`` — layer L's KV ships while layer L+1 computes, but every
  per-layer transfer pays a *blocking* metadata handshake with the Decode
  side: the handshake sits in the compute stream, stalling the pipeline
  and misaligning communication with computation (paper Fig. 7a/c —
  overlap ratios of only 15-25%).
* ``grouped``    — adjacent layers' KV packed into groups (one handshake
  per group, performed asynchronously off an event queue), with
  delayed-start scheduling so each group's wire time hides under the
  compute of the remaining layers (paper Fig. 7b/d — ~99% overlap, and
  higher effective bandwidth because handshakes are amortized over
  larger payloads).

The planner is deterministic and separately unit-tested; both the
simulator and the real mini-cluster runner call :func:`plan`.

:func:`plan_chunked` is the CHUNKED-prefill variant (streaming P->D):
prefill runs in fixed-size token chunks and chunk *k*'s pages (all
layers, one grouped handshake) ride the link while chunk *k+1* computes.
A cached-prefix segment (zero compute) can ship immediately at t=0. The
only exposed latency is the final chunk's tail — for long prompts this
replaces the serialized prefill-then-transfer TTFT with
max(prefill, transfer) + last-chunk tail.

Metric definitions (paper Table 4):
  kv_latency  — total time the transfer machinery is busy (handshakes +
                wire) for this request's KV.
  exposed     — part of that latency on the request's critical path
                (compute stalls + completion past prefill end).
  overlap     — 1 - exposed / kv_latency.
  effective_bandwidth — payload / kv_latency.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, List, Literal, Optional, Tuple

from repro_torch.core.faults import (SITE_TRANSFER_HANDSHAKE, SITE_TRANSFER_WIRE,
                                     FaultInjector, PlanError, RetryPolicy,
                                     TransferError)

Scheme = Literal["one_shot", "layer_wise", "grouped", "chunked"]


@dataclass(frozen=True)
class GroupPlan:
    """One transmission unit: layers [start, end) (prefill chunks
    [start, end) for the "chunked" scheme)."""
    start: int
    end: int
    nbytes: float
    t_ready: float        # when the last layer of the group finishes compute
    t_send: float         # scheduled send start (after handshake)
    t_done: float         # transfer completion


@dataclass
class TransferPlan:
    scheme: Scheme
    groups: List[GroupPlan]
    prefill_time: float            # compute-only prefill duration
    prefill_end: float             # actual prefill end incl. blocking stalls
    kv_latency: float
    exposed_latency: float
    effective_bandwidth: float

    @property
    def overlap_ratio(self) -> float:
        if self.kv_latency <= 0:
            return 1.0
        return max(0.0, 1.0 - self.exposed_latency / self.kv_latency)

    @property
    def total_done(self) -> float:
        """When the Decode instance holds the full KV (TTFT gate)."""
        return max((g.t_done for g in self.groups), default=self.prefill_end)


def choose_group_size(n_layers: int, per_layer_compute: float,
                      handshake: float, per_layer_transfer: float) -> int:
    """Paper §3.3: group size from compute load vs. handshake latency.

    A group of g layers keeps the link busy for (handshake + g*wire) while
    compute advances g*t_c. To keep the link from falling behind when
    compute is the slower side we need handshake + g*t_x <= g*t_c, i.e.
    g >= handshake / (t_c - t_x). When the wire is slower than compute no
    g keeps up; amortize the handshake to <2% of wire time instead.
    """
    if n_layers <= 1:
        return 1
    t_c, t_x = per_layer_compute, per_layer_transfer
    if t_c > t_x:
        # compute-bound: the link must keep up with compute even though
        # each group pays one handshake: h + g*t_x <= g*t_c
        g = math.ceil(handshake / max(t_c - t_x, 1e-12))
    else:
        # wire-bound: the link is saturated, so completion ~=
        # g*t_c (first group's readiness delay) + (n/g)*h (handshakes)
        # + n*t_x (payload). Minimizing over g: g* = sqrt(n*h/t_c).
        g = round(math.sqrt(n_layers * handshake / max(t_c, 1e-12)))
    return max(1, min(g, max(n_layers // 2, 1)))


def plan(scheme: Scheme, *, n_layers: int, bytes_per_layer: float,
         per_layer_compute: float, handshake: float, link_bw: float,
         group_size: int = 0, page_bytes: float = 0.0) -> TransferPlan:
    """Build the transmission schedule for one request's KV cache.

    page_bytes > 0 switches to page-granular transmission (paged KV
    pools): each layer's payload is rounded up to whole pages, so every
    group's bytes are page-aligned — transfers map 1:1 onto pool pages
    on both ends and the wire never ships a partial page. The padding
    cost of the last partial page is thereby made explicit in the
    schedule instead of hidden in the runtime.

    Invalid inputs raise :class:`~repro_torch.core.faults.PlanError` (a
    ValueError): a malformed plan request is a caller bug, not a
    schedulable transfer, and must never half-build a schedule.
    """
    if n_layers <= 0:
        raise PlanError(f"n_layers must be >= 1, got {n_layers}")
    if bytes_per_layer <= 0:
        raise PlanError(
            f"bytes_per_layer must be positive, got {bytes_per_layer}")
    if per_layer_compute < 0:
        raise PlanError(
            f"per_layer_compute must be >= 0, got {per_layer_compute}")
    if handshake < 0:
        raise PlanError(f"handshake must be >= 0, got {handshake}")
    if link_bw <= 0:
        raise PlanError(f"link_bw must be positive, got {link_bw}")
    if group_size < 0:
        raise PlanError(
            f"group_size must be >= 0 (0 = auto), got {group_size}")
    if page_bytes < 0:
        raise PlanError(f"page_bytes must be >= 0, got {page_bytes}")
    t_c = per_layer_compute
    if page_bytes > 0:
        bytes_per_layer = math.ceil(bytes_per_layer / page_bytes) * page_bytes
    t_x = bytes_per_layer / link_bw
    prefill_time = n_layers * t_c
    payload = n_layers * bytes_per_layer

    if scheme == "one_shot":
        t0 = prefill_time
        busy = handshake + payload / link_bw
        g = GroupPlan(0, n_layers, payload, t0, t0 + handshake, t0 + busy)
        return TransferPlan(scheme, [g], prefill_time, prefill_time,
                            busy, busy, payload / busy)

    if scheme == "layer_wise":
        # Blocking handshake in the compute stream: layer l's compute ends,
        # then the host handshake stalls the pipeline for `handshake`
        # before the (async) wire transfer starts.
        groups: List[GroupPlan] = []
        clock = 0.0          # compute-stream time
        link_free = 0.0
        stalls = 0.0
        for l in range(n_layers):
            clock += t_c                      # layer l computes
            clock += handshake                # blocking metadata handshake
            stalls += handshake
            t_send = max(clock, link_free)
            t_done = t_send + t_x
            groups.append(GroupPlan(l, l + 1, bytes_per_layer,
                                    clock - handshake, t_send, t_done))
            link_free = t_done
        prefill_end = clock
        total_done = groups[-1].t_done
        kv_latency = stalls + n_layers * t_x
        exposed = stalls + max(0.0, total_done - prefill_end)
        eff_bw = payload / kv_latency
        return TransferPlan(scheme, groups, prefill_time, prefill_end,
                            kv_latency, exposed, eff_bw)

    # ---- grouped: async handshakes off the event queue, aligned start ----
    # One handshake per group rides the link (never the compute stream —
    # that's the layer-wise pathology), so handshake cost is amortized over
    # the group's payload. The final group is tapered to a single layer so
    # the unavoidable tail (the last layer's KV, which no compute can
    # hide) is minimal.
    gsz = group_size or choose_group_size(n_layers, t_c, handshake, t_x)
    if gsz > 1 and n_layers > gsz:
        body = [gsz] * ((n_layers - 1) // gsz)
        rest = (n_layers - 1) - sum(body)
        sizes = body + ([rest] if rest else []) + [1]
    else:
        sizes = [gsz] * (n_layers // gsz)
        if n_layers % gsz:
            sizes.append(n_layers % gsz)

    groups = []
    start = 0
    link_free = 0.0
    busy = 0.0
    for sz in sizes:
        end = start + sz
        nbytes = sz * bytes_per_layer
        t_ready = end * t_c
        t_send = max(t_ready, link_free) + handshake
        t_done = t_send + nbytes / link_bw
        groups.append(GroupPlan(start, end, nbytes, t_ready, t_send, t_done))
        link_free = t_done
        busy += handshake + nbytes / link_bw
        start = end
    total_done = groups[-1].t_done
    exposed = max(0.0, total_done - prefill_time)
    eff_bw = payload / busy
    return TransferPlan("grouped", groups, prefill_time, prefill_time,
                        busy, exposed, eff_bw)


def plan_chunked(*, chunk_bytes: List[float], chunk_compute: List[float],
                 handshake: float, link_bw: float,
                 page_bytes: float = 0.0) -> TransferPlan:
    """Streaming transfer schedule for a CHUNKED prefill.

    ``chunk_bytes[k]`` — KV bytes of segment *k* across ALL layers;
    ``chunk_compute[k]`` — that segment's prefill compute time (0 for a
    segment already resident, e.g. a prefix-cache hit, whose pages can
    ship before any compute). Segment *k*'s transfer is one grouped unit
    (single async handshake) eligible to start the moment its compute
    finishes, so it rides the link while segments k+1.. compute. Empty
    (zero-byte) segments emit no group and pay no handshake, but their
    compute still advances the clock.

    ``page_bytes`` > 0 rounds every segment up to whole KV-pool pages
    (here the quantum is a FULL page across all layers — chunk payloads
    map 1:1 onto pool pages, unlike the per-layer slices of
    :func:`plan`).
    """
    if len(chunk_bytes) != len(chunk_compute):
        raise PlanError(
            f"{len(chunk_bytes)} byte segments vs "
            f"{len(chunk_compute)} compute segments")
    if not chunk_bytes:
        raise PlanError("empty segment list: nothing to plan")
    if any(b < 0 for b in chunk_bytes):
        raise PlanError(f"negative segment bytes in {chunk_bytes}")
    if any(t < 0 for t in chunk_compute):
        raise PlanError(f"negative segment compute in {chunk_compute}")
    if handshake < 0:
        raise PlanError(f"handshake must be >= 0, got {handshake}")
    if link_bw <= 0:
        raise PlanError(f"link_bw must be positive, got {link_bw}")
    if page_bytes < 0:
        raise PlanError(f"page_bytes must be >= 0, got {page_bytes}")
    groups: List[GroupPlan] = []
    clock = 0.0                        # compute-stream time
    link_free = 0.0
    busy = 0.0
    payload = 0.0
    for k, (nbytes, t_c) in enumerate(zip(chunk_bytes, chunk_compute)):
        clock += t_c
        if page_bytes > 0 and nbytes > 0:
            nbytes = math.ceil(nbytes / page_bytes) * page_bytes
        if nbytes <= 0:
            continue
        t_send = max(clock, link_free) + handshake
        t_done = t_send + nbytes / link_bw
        groups.append(GroupPlan(k, k + 1, nbytes, clock, t_send, t_done))
        link_free = t_done
        busy += handshake + nbytes / link_bw
        payload += nbytes
    prefill_end = sum(chunk_compute)
    total_done = max((g.t_done for g in groups), default=prefill_end)
    exposed = max(0.0, total_done - prefill_end)
    eff_bw = payload / busy if busy > 0 else 0.0
    return TransferPlan("chunked", groups, prefill_end, prefill_end,
                        busy, exposed, eff_bw)


# ---------------------------------------------------------------------------
# Fault recovery: re-handshake/resend with backoff + fresh replan of
# only the missing groups
# ---------------------------------------------------------------------------

@dataclass
class TransferRecovery:
    """What it took to deliver a plan through an injected fault field."""

    handshake_faults: int = 0
    wire_faults: int = 0
    retries: int = 0              # failed attempts that were retried
    retry_time: float = 0.0       # backoff + wasted handshake/wire time
    replanned_groups: int = 0     # groups delivered via the fresh replan
    deadline_hits: int = 0        # groups whose retry budget ran out
    # link-time event log for the span tracer: (kind, group_start,
    # t_begin, t_end) — wasted attempts and backoff idles, in the same
    # relative timebase as the recovered plan's group schedule.
    events: List[Tuple[str, int, float, float]] = field(default_factory=list)

    @property
    def faults(self) -> int:
        return self.handshake_faults + self.wire_faults


def _attempt_group(g: GroupPlan, clock: float, *, injector: FaultInjector,
                   policy: RetryPolicy, handshake: float, link_bw: float,
                   key: Any, tag: str, rec: TransferRecovery,
                   retry_spent: float) -> Tuple[Optional[GroupPlan], float,
                                                float]:
    """Try to deliver one group starting at link time ``clock``.

    Returns (delivered group or None, new link clock, retry time spent).
    A failed handshake wastes its handshake latency; a failed wire
    transfer wastes handshake + wire (the payload is resent whole —
    partial-delivery resume is below the planning granularity). Between
    attempts the link idles for the policy's seeded backoff. ``None``
    means every attempt (or the retry-time deadline) was exhausted."""
    wire = g.nbytes / link_bw
    t = max(clock, g.t_ready)
    for a in range(1, policy.max_attempts + 1):
        hs_fail = injector.should_fail(
            SITE_TRANSFER_HANDSHAKE, key=(key, tag, g.start), attempt=a)
        wire_fail = (not hs_fail) and injector.should_fail(
            SITE_TRANSFER_WIRE, key=(key, tag, g.start), attempt=a)
        if not hs_fail and not wire_fail:
            done = t + handshake + wire
            return (replace(g, t_send=t + handshake, t_done=done),
                    done, retry_spent)
        wasted = handshake if hs_fail else handshake + wire
        if hs_fail:
            rec.handshake_faults += 1
        else:
            rec.wire_faults += 1
        rec.events.append(("kv.retry.wasted", g.start, t, t + wasted))
        t += wasted
        retry_spent += wasted
        rec.retry_time += wasted
        if a < policy.max_attempts:
            if retry_spent >= policy.deadline:
                rec.deadline_hits += 1
                return None, t, retry_spent
            back = policy.backoff(a, key=(key, tag, g.start))
            rec.events.append(("kv.retry.backoff", g.start, t, t + back))
            t += back
            retry_spent += back
            rec.retry_time += back
            rec.retries += 1
    return None, t, retry_spent


def recover_plan(plan: TransferPlan, *, injector: FaultInjector,
                 policy: RetryPolicy, handshake: float, link_bw: float,
                 key: Any = None,
                 replan: bool = True) -> Tuple[TransferPlan,
                                               TransferRecovery]:
    """Re-schedule ``plan`` under the injector's transfer-fault field.

    Layered recovery, per group and in link order:

    1. re-handshake/resend with the policy's capped, seeded backoff —
       transient handshake or wire faults heal in place;
    2. groups that exhaust their attempts (or the per-request retry-time
       deadline) fall back to a *fresh grouped plan covering only the
       missing groups*, appended after the survivors (one new handshake
       each, a fresh attempt budget — the §3.3 grouped machinery reused
       as the repair path);
    3. a group the replan also cannot deliver raises
       :class:`TransferError` — with ``replan=False`` and
       ``policy=NO_RETRY`` that is the recovery-off baseline, where any
       fault loses the request.

    The recovered plan keeps the original compute timeline
    (``prefill_time`` / ``prefill_end``) — faults cost link time and
    backoff, never compute — so TTFT inflation shows up purely in
    ``exposed_latency`` / ``total_done``, which is exactly where the
    simulator and cluster charge it. Payload is conserved: every
    original group is delivered exactly once (possibly late)."""
    if link_bw <= 0:
        raise PlanError(f"link_bw must be positive, got {link_bw}")
    if handshake < 0:
        raise PlanError(f"handshake must be >= 0, got {handshake}")
    rec = TransferRecovery()
    delivered: List[GroupPlan] = []
    missing: List[GroupPlan] = []
    clock = 0.0
    spent = 0.0
    for g in plan.groups:
        got, clock, spent = _attempt_group(
            g, clock, injector=injector, policy=policy, handshake=handshake,
            link_bw=link_bw, key=key, tag="xfer", rec=rec, retry_spent=spent)
        if got is None:
            missing.append(g)
        else:
            delivered.append(got)
    if missing:
        if not replan:
            raise TransferError(SITE_TRANSFER_WIRE, missing[0].start,
                                policy.max_attempts)
        # fresh grouped plan for ONLY the missing groups: new handshakes,
        # fresh attempt budgets, scheduled after the surviving traffic
        rec.replanned_groups = len(missing)
        for g in missing:
            got, clock, spent = _attempt_group(
                g, clock, injector=injector, policy=policy,
                handshake=handshake, link_bw=link_bw, key=key,
                tag="replan", rec=rec, retry_spent=0.0)
            if got is None:
                raise TransferError(SITE_TRANSFER_WIRE, g.start,
                                    2 * policy.max_attempts)
            delivered.append(got)
    if rec.faults == 0:
        return plan, rec            # zero-fault fast path: plan unchanged
    total_done = max(g.t_done for g in delivered)
    kv_latency = plan.kv_latency + rec.retry_time
    exposed = max(0.0, total_done - plan.prefill_end)
    payload = sum(g.nbytes for g in delivered)
    eff_bw = payload / kv_latency if kv_latency > 0 else 0.0
    out = TransferPlan(plan.scheme, delivered, plan.prefill_time,
                       plan.prefill_end, kv_latency, exposed, eff_bw)
    return out, rec


# ---------------------------------------------------------------------------
# Telemetry: render a transfer schedule as trace spans
# ---------------------------------------------------------------------------

def emit_spans(tracer, plan: TransferPlan, *, base: float, handshake: float,
               compute_track: str, link_track: str,
               chunk_compute: Optional[List[float]] = None,
               request_id: Optional[int] = None,
               recovery: Optional[TransferRecovery] = None) -> None:
    """Record a plan's modeled timeline as tracer spans.

    The plan's group schedule is relative to its own t=0 (prefill
    start); ``base`` anchors it on the tracer's clock. Each group gets a
    ``kv.handshake`` span ([t_send - handshake, t_send]) and a
    ``kv.wire`` span ([t_send, t_done]) on ``link_track``, so the
    chunk-k transfer visibly rides under chunk-k+1 compute in the
    exported trace. ``chunk_compute`` (per-segment compute durations)
    additionally renders the modeled compute stream on
    ``compute_track`` — used when the compute itself is modeled (cost
    model / simulator); the real engine's chunk spans come from its own
    wall clock instead. ``recovery`` adds the retry events (wasted
    attempts, backoff idles) as ``kv.retry.*`` spans on the link track,
    making fault-recovery time visible as explicit timeline gaps."""
    if not tracer.enabled:
        return
    if chunk_compute is not None:
        t = base
        for k, dt in enumerate(chunk_compute):
            if dt > 0:
                tracer.add("prefill.chunk", t, t + dt, track=compute_track,
                           request_id=request_id, chunk=k, modeled=True)
            t += dt
    for g in plan.groups:
        if handshake > 0:
            tracer.add("kv.handshake", base + g.t_send - handshake,
                       base + g.t_send, track=link_track,
                       request_id=request_id, group=g.start)
        tracer.add("kv.wire", base + g.t_send, base + g.t_done,
                   track=link_track, request_id=request_id,
                   group=g.start, nbytes=g.nbytes)
    if recovery is not None:
        for kind, grp, t0, t1 in recovery.events:
            tracer.add(kind, base + t0, base + t1, track=link_track,
                       request_id=request_id, group=grp)
