"""The port's HTTP front door (``repro_torch.launch.serve``) over a live
fleet, in process on an ephemeral port.

Served requests run on the wall clock, so the checks are invariants, never
timing windows: every request is answered with its tokens, the tokens are
the reference ``FakeEngine``'s for the same tenant and prompt, the
endpoints keep their shapes, admission rejections surface as 429, and the
shutdown drains and writes its report. One test serves the stablelm-1.6b
smoke variant on the CPU through real engines.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

from repro.launch import serve as jserve  # noqa: E402
from repro.serving.fleet import FakeEngine as JFakeEngine  # noqa: E402

from repro_torch.api.spec import ServeSpec, SystemSpec  # noqa: E402
from repro_torch.launch.serve import ADMIT_REASONS, FleetServer, run_server  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE_SMOKE = ROOT / "examples" / "specs" / "serve_smoke.json"


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _predict(port, tenant_id, prompt):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps({"tenant_id": tenant_id, "prompt": prompt}).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _serve(spec, device=None):
    """``run_server`` in a thread, as a deployment would call it; returns
    (server, thread) once it listens."""
    ready, started = threading.Event(), []
    thread = threading.Thread(target=run_server, args=(spec,),
                              kwargs=dict(ready=ready, device=device, started=started),
                              daemon=True)
    thread.start()
    assert ready.wait(60), "the server did not come up"
    return started[0], thread


def _stop(server, thread):
    server.httpd.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_serve_smoke_answers_every_request(tmp_path):
    """The committed serve spec (arch=fake): 8 concurrent predicts each get
    the reference FakeEngine's 8 tokens for their tenant and prompt;
    /healthz and /v1/report keep their shapes; the shutdown writes the
    report, counting every request."""
    path = tmp_path / "report.json"
    spec = ServeSpec.from_dict({**ServeSpec.load(str(SERVE_SMOKE)).to_dict(),
                                "report_path": str(path)})
    server, thread = _serve(spec)
    prompts = [(i % 4, [1, 2, 3 + i]) for i in range(8)]
    with ThreadPoolExecutor(8) as ex:
        outs = list(ex.map(lambda tp: _predict(server.port, *tp), prompts))
    engine = JFakeEngine(0, max_new_tokens=8)
    for (tenant, prompt), (status, doc) in zip(prompts, outs):
        assert status == 200 and doc["tenant_id"] == tenant and doc["replica"] in (0, 1)
        want = engine.execute([SimpleNamespace(tenant_id=tenant, payload=prompt)])[0]
        assert doc["tokens"] == want and doc["latency_s"] > 0
    status, health = _get(server.port, "/healthz")
    assert status == 200 and health == {"status": "ok", "replicas": 2, "engine": "fake",
                                        "router": "least_cost", "requests": 8}
    status, report = _get(server.port, "/v1/report")
    assert status == 200 and report["executor"] == "serve" and report["mode"] == "live"
    assert report["metrics"]["http"] == {"requests": 8, "rejected": 0}
    assert sum(report["metrics"]["routed_counts"]) == 8 and "scheduler" in report["metrics"]
    _stop(server, thread)
    doc = json.loads(path.read_text())
    assert doc["metrics"]["http"]["requests"] == 8
    assert doc["spec"]["cost_model"]["hardware"] == "h100"


def test_routes_and_bad_requests_answer_as_the_reference():
    server, thread = _serve(ServeSpec.load(str(SERVE_SMOKE)))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/nope")
        assert e.value.code == 404
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/predict",
                                     data=json.dumps({"prompt": "not-a-list"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    finally:
        _stop(server, thread)
    assert ADMIT_REASONS == jserve.ADMIT_REASONS


def test_an_infeasible_deadline_surfaces_as_429():
    """An SLO no dispatch meets: feasibility admission rejects with reason
    code 3, and the handler answers 429 without waiting."""
    system = SystemSpec.from_dict({
        "mode": "live",
        "workload": {"mix": "single", "tenants": 2, "events": 10, "seed": 0,
                     "rate_hz": 100.0, "arch": "fake", "slo_s": 1e-12},
        "fleet": {"replicas": 2}, "router": {"policy": "least_cost"},
        "scheduler": {"admission_policy": "feasibility"}})
    server, thread = _serve(ServeSpec(system=system, port=0, request_timeout_s=10.0,
                                      poll_interval_s=0.01))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _predict(server.port, 0, [1])
        assert e.value.code == 429
        assert json.loads(e.value.read())["reason"] == "infeasible"
        assert server.report().metrics["http"] == {"requests": 1, "rejected": 1}
    finally:
        _stop(server, thread)


def test_a_real_architecture_serves_on_the_cpu():
    """stablelm-1.6b's smoke variant in float32 behind the front door on
    the CPU: four concurrent predicts each answered with max_new_tokens
    tokens inside the vocabulary, the same tokens for the same tenant and
    prompt, and a clean shutdown."""
    system = SystemSpec().replace(**{
        "mode": "live", "workload.arch": "stablelm-1.6b", "workload.tenants": 2,
        "workload.prompt_tokens": 6, "workload.max_new_tokens": 4, "fleet.replicas": 2,
        "router.policy": "least_cost"})
    server, thread = _serve(ServeSpec(system=system, port=0, poll_interval_s=0.01),
                            device="cpu")
    try:
        prompts = [(0, [5, 6, 7]), (1, [5, 6, 7]), (0, [5, 6, 7]), (1, [9, 8])]
        with ThreadPoolExecutor(4) as ex:
            outs = [doc for _, doc in ex.map(lambda tp: _predict(server.port, *tp), prompts)]
        assert all(len(d["tokens"]) == 4 and all(0 <= t < 1024 for t in d["tokens"])
                   for d in outs)
        assert outs[0]["tokens"] == outs[2]["tokens"]
        assert _get(server.port, "/healthz")[1]["engine"] == "torch"
    finally:
        _stop(server, thread)


def test_shutdown_is_idempotent_and_the_spec_round_trips():
    spec = ServeSpec.load(str(SERVE_SMOKE))
    assert ServeSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    server = FleetServer(spec)
    server.start()
    server.shutdown()
    server.shutdown()
    with pytest.raises(ValueError, match="live"):
        ServeSpec(system=SystemSpec(mode="sim"))
