"""Chrome/Perfetto trace-event JSON export for telemetry spans.

Converts a :class:`~repro_torch.core.telemetry.Tracer`'s recorded spans into
the Trace Event Format (the JSON schema consumed by ``chrome://tracing``
and https://ui.perfetto.dev): one "X" (complete) event per span with
``ts``/``dur`` in microseconds, plus "M" (metadata) events naming one
thread row per telemetry track. Every engine instance / transfer link
gets its own row, so chunked-prefill compute on the P track visibly
overlaps group transfers on the link track, and preemption gaps show as
holes in a D track.

``validate_trace`` is the schema check used by tests and the CI
observability-smoke job — it asserts the exported JSON is loadable by
the viewers (required keys, µs units, non-negative durations, metadata
rows for every referenced track) without needing Chrome in the loop.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .telemetry import Span, Tracer

# All spans share one synthetic process; each telemetry track becomes a
# thread row. tids are assigned in first-appearance order so related
# tracks (engine, then its link) sort adjacently in the viewer.
_PID = 1


def _track_tids(spans: List[Span]) -> Dict[str, int]:
    tids: Dict[str, int] = {}
    for s in spans:
        if s.track not in tids:
            tids[s.track] = len(tids) + 1
    return tids


def to_trace_events(tracer: Tracer,
                    process_name: str = "epd-serve") -> List[Dict[str, Any]]:
    """Spans -> trace-event dicts (µs timestamps, one tid per track)."""
    spans = tracer.spans
    tids = _track_tids(spans)
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": process_name},
    }]
    for track, tid in tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"name": track},
        })
        events.append({
            "name": "thread_sort_index", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"sort_index": tid},
        })
    for s in spans:
        args: Dict[str, Any] = dict(s.attrs)
        if s.request_id is not None:
            args["request_id"] = s.request_id
        if s.parent is not None:
            args["parent"] = s.parent
        events.append({
            "name": s.name, "ph": "X", "pid": _PID, "tid": tids[s.track],
            "ts": s.start * 1e6, "dur": s.duration * 1e6,
            "cat": s.name.split(".", 1)[0],
            "args": args,
        })
    return events


def write_trace(tracer: Tracer, path: str,
                process_name: str = "epd-serve") -> int:
    """Write ``{"traceEvents": [...]}`` JSON to ``path``; returns the
    number of span ("X") events written."""
    events = to_trace_events(tracer, process_name)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return sum(1 for e in events if e["ph"] == "X")


def validate_trace(doc: Any,
                   require_tracks: Optional[List[str]] = None) -> Dict[str, int]:
    """Schema-validate a trace-event document (parsed JSON).

    Asserts the shape ``chrome://tracing`` / Perfetto require: a
    ``traceEvents`` list whose "X" events carry numeric ``ts``/``dur``
    (µs, dur >= 0) plus ``pid``/``tid``/``name``, and whose every
    referenced tid has a ``thread_name`` metadata row. When
    ``require_tracks`` is given, each named track must exist and hold
    at least one span. Returns ``{track_name: span_count}``.
    """
    assert isinstance(doc, dict), "trace document must be a JSON object"
    events = doc.get("traceEvents")
    assert isinstance(events, list), "traceEvents must be a list"
    names_by_tid: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names_by_tid[e["tid"]] = e["args"]["name"]
    counts: Dict[str, int] = {name: 0 for name in names_by_tid.values()}
    for e in events:
        ph = e.get("ph")
        assert ph in ("X", "M"), f"unexpected event phase {ph!r}"
        if ph != "X":
            continue
        for key in ("name", "pid", "tid", "ts", "dur"):
            assert key in e, f"span event missing {key!r}: {e}"
        assert isinstance(e["ts"], (int, float)), "ts must be numeric (µs)"
        assert isinstance(e["dur"], (int, float)), "dur must be numeric (µs)"
        assert e["dur"] >= 0, f"negative duration in {e['name']!r}"
        track = names_by_tid.get(e["tid"])
        assert track is not None, (
            f"span {e['name']!r} references tid {e['tid']} with no "
            f"thread_name metadata row")
        counts[track] += 1
    for want in require_tracks or []:
        assert want in counts, (
            f"required track {want!r} missing; have {sorted(counts)}")
        assert counts[want] > 0, f"required track {want!r} has no spans"
    return counts


def overlap(doc: Any, track_a: str, span_a: str,
            track_b: str, span_b: str) -> float:
    """Total seconds during which some ``span_a`` on ``track_a``
    overlaps some ``span_b`` on ``track_b`` — the measurement behind
    "chunk k's transfer runs under chunk k+1's compute". Span names
    match by prefix so ``"prefill.chunk"`` covers every chunk index."""
    events = doc["traceEvents"]
    names_by_tid = {e["tid"]: e["args"]["name"] for e in events
                    if e.get("ph") == "M" and e.get("name") == "thread_name"}

    def _spans(track: str, name: str):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X"
                      and names_by_tid.get(e["tid"]) == track
                      and e["name"].startswith(name))

    total = 0.0
    for a0, a1 in _spans(track_a, span_a):
        for b0, b1 in _spans(track_b, span_b):
            if b0 >= a1:
                break
            total += max(0.0, min(a1, b1) - max(a0, b0))
    return total / 1e6
