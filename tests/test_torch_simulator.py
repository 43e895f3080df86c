"""The port's copies of the pure-Python host modules against the
reference's: the event simulator (``core/simulator.py``), the co-location
interference model (``core/colocation.py``), the Chrome-trace exporter
(``core/trace_export.py``) and ``launch/serve.py --simulate``.

Both packages run the same Python on the same inputs, so the results are
compared exactly: every ``SimMetrics`` field, every request's timestamps,
the latency attribution, the metrics snapshot and the exported trace.
Request ids come from a per-package counter, which both are restarted at
0 before each run.
"""
import dataclasses
import itertools
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.serving.request as jax_request  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import colocation as JC  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import telemetry as JTel  # noqa: E402
from repro.core import trace_export as JX  # noqa: E402
from repro.core.faults import FaultPlan as JaxFaultPlan  # noqa: E402
import repro_torch.serving.request as port_request  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import telemetry as Tel  # noqa: E402
from repro_torch.core import trace_export as X  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODEL = "openpangu-7b-vl"


def _both(monkeypatch, ds, port_kw=None, ref_kw=None, **kw):
    """simulate() on dataset ``ds`` (a name in each simulator module) in
    each package with request ids from 0; returns the two SimMetrics as
    plain dicts (requests included)."""
    out = []
    for mod, req_mod, get, extra in (
            (S, port_request, get_config, port_kw),
            (JS, jax_request, jax_get_config, ref_kw)):
        monkeypatch.setattr(req_mod, "_ids", itertools.count())
        m = mod.simulate(get(MODEL), dataset=getattr(mod, ds), **kw,
                         **(extra or {}))
        out.append(dataclasses.asdict(m))
    return out


CASES = [("E-P-D", "SHAREGPT_4O"), ("E-P-D", "VISUALWEB"),
         ("EP-D", "SHAREGPT_4O"), ("EP-D", "VISUALWEB"),
         ("(E-P)-D", "VISUALWEB"), ("TP1", "SHAREGPT_4O")]


@pytest.mark.parametrize("dep,ds", CASES)
def test_simulate_equals_reference(monkeypatch, dep, ds):
    port, ref = _both(monkeypatch, deployment=dep, ds=ds, rate=6.0,
                      n_requests=40, seed=7)
    assert port.keys() == ref.keys()
    for k in port:
        assert port[k] == ref[k], k
    assert len(port["requests"]) == 40


def test_simulate_equals_reference_with_every_option(monkeypatch):
    """Paged decode pool with preemption, prefix cache, chunked prefill,
    P->D transfer faults with retries and the tracer on: the metrics,
    the attribution and the exported trace equal the reference's."""
    rates = {"transfer.wire": 0.2, "transfer.handshake": 0.1}
    tp, tj = Tel.Tracer(enabled=True), JTel.Tracer(enabled=True)
    port, ref = _both(
        monkeypatch, deployment="E-P-D", ds="VISUALWEB", rate=16.0,
        n_requests=40, seed=3, kv_page_tokens=16, prefix_cache=True,
        chunked_prefill=True, prefill_chunk_tokens=256,
        decode_kv_pages=200, preemption=True,
        port_kw=dict(faults=FaultPlan(seed=5, rates=rates), tracer=tp),
        ref_kw=dict(faults=JaxFaultPlan(seed=5, rates=rates), tracer=tj))
    for k in port:
        assert port[k] == ref[k], k
    assert port["transfer_retries"] > 0 and port["n_preemptions"] > 0
    ep, er = X.to_trace_events(tp), JX.to_trace_events(tj)
    assert len(ep) > 0 and json.dumps(ep) == json.dumps(er)


def test_h100_profile():
    """The port's card profile: its own peak, HBM, link and host rates,
    every other field V5E's."""
    h, v = costmodel.H100, costmodel.V5E
    assert (h.peak_flops, h.hbm_bw, h.link_bw, h.host_bw) == (
        989e12, 3.35e12, 450e9, 64e9)
    for f in dataclasses.fields(h):
        if f.name not in ("peak_flops", "hbm_bw", "link_bw", "host_bw"):
            assert getattr(h, f.name) == getattr(v, f.name), f.name
    cost = costmodel.CostModel(get_config(MODEL), hw=h)
    assert cost.prefill_time(512) < costmodel.CostModel(
        get_config(MODEL)).prefill_time(512)


# ---------------------------------------------------------------------------
# colocation: tests/test_core.py's case on the port's module
# ---------------------------------------------------------------------------

def test_interference_structure():
    h = C.interference_heatmap()
    assert h[("P", "P")] > h[("P", "D")]
    assert h[("D", "D")] > h[("D", "E")]
    assert h[("E", "P")] > h[("E", "D")]
    for v in h.values():
        assert v >= 1.0
    assert C.stage_slowdown("P", []) == 1.0


@pytest.mark.parametrize("others", [[], ["D"], ["E", "D"], ["P", "P", "E"]])
def test_colocation_equals_reference(others):
    assert C.interference_heatmap() == JC.interference_heatmap()
    assert C.STAGE_MIX == JC.STAGE_MIX
    for stage in ("E", "P", "D"):
        assert C.stage_slowdown(stage, others) == \
            JC.stage_slowdown(stage, others)


# ---------------------------------------------------------------------------
# trace_export: tests/test_telemetry.py's cases on the port's module
# ---------------------------------------------------------------------------

def _traced(tel):
    clk = {"t": 0.0}
    t = tel.Tracer(enabled=True, now=lambda: clk["t"])
    with t.span("prefill", track="P0", request_id=1):
        clk["t"] = 1.0
    t.add("kv.wire", 0.5, 0.8, track="P0->D0", request_id=1)
    t.add("decode.step", 1.0, 1.2, track="D0")
    return t


def test_trace_events_equal_reference(tmp_path):
    ep, er = X.to_trace_events(_traced(Tel)), JX.to_trace_events(_traced(JTel))
    assert ep == er
    n = X.write_trace(_traced(Tel), str(tmp_path / "port.json"))
    JX.write_trace(_traced(JTel), str(tmp_path / "ref.json"))
    assert n == 3
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()


def test_trace_validate_and_overlap():
    doc = {"traceEvents": X.to_trace_events(_traced(Tel))}
    assert X.validate_trace(doc, require_tracks=["P0", "D0"]) == {
        "P0": 1, "P0->D0": 1, "D0": 1}
    with pytest.raises(AssertionError):
        X.validate_trace(doc, require_tracks=["E0"])
    assert X.overlap(doc, "P0", "prefill", "P0->D0", "kv.wire") == \
        pytest.approx(0.3)
    assert X.overlap(doc, "P0", "prefill", "D0", "decode.step") == 0.0


# ---------------------------------------------------------------------------
# launch/serve.py --simulate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [[], ["--deployment", "EP-D", "--dataset",
                                       "visualweb", "--rate", "4"]],
                         ids=["defaults", "ep-d-visualweb"])
def test_serve_simulate_prints_the_reference_lines(args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "",
           "JAX_PLATFORMS": "cpu"}
    out = [subprocess.run([sys.executable, "-m", f"{pkg}.launch.serve",
                           "--simulate", *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
           for pkg in ("repro_torch", "repro")]
    for res in out:
        assert res.returncode == 0, res.stderr
    lines = out[0].stdout.splitlines()
    assert lines == out[1].stdout.splitlines()
    assert len(lines) == 4 and lines[0].startswith("deployment=")
