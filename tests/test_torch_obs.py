"""The port's flight recorder and its read paths against a fresh run of the
JAX package's: the Chrome trace export and the windowed telemetry of
``examples/specs/traced_fleet.json`` equal the reference's, byte for byte.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

from test_torch_sim import (  # noqa: E402
    assert_same_text,
    load_spec,
    port_hw,
    port_run,
    reference_run,
)

from repro.core.queue import ShapeBucket as JBucket  # noqa: E402
from repro.obs import recorder as jrecorder  # noqa: E402
from repro.obs.telemetry import windowed_series as j_windowed  # noqa: E402
from repro.obs.trace_export import chrome_trace_events as j_events  # noqa: E402
from repro.obs.trace_export import export_chrome_trace as j_export  # noqa: E402

from repro_torch.core.queue import ShapeBucket  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    FlightRecorder,
    ReplicaShard,
    chrome_trace_events,
    export_chrome_trace,
    windowed_series,
)
from repro_torch.obs import recorder as trecorder  # noqa: E402
from repro_torch.sim import fleet as tfleet  # noqa: E402

TRACED = {"observability.enabled": True}


@pytest.fixture(autouse=True)
def reference_base(monkeypatch):
    monkeypatch.setattr(tfleet, "BASE_SPEC", port_hw("v5e"))


def recorded_pair(name="traced_fleet", **dotted):
    spec = load_spec(name, **dict(TRACED, **dotted))
    _, jrec = reference_run(spec)
    _, trec = port_run(spec)
    return spec, jrec, trec


@pytest.mark.parametrize("name,dotted", [
    ("traced_fleet", {}),
    ("traced_fleet", {"observability.per_request": False}),
    ("hetero_fleet", {}),
    ("paper_mix", {}),
], ids=["traced_fleet", "traced_fleet-no-requests", "hetero_fleet", "paper_mix"])
def test_chrome_trace_bytes_equal_the_reference(name, dotted):
    _, jrec, trec = recorded_pair(name, **dotted)
    assert trec.total_events() == jrec.total_events() > 0
    got = export_chrome_trace(trec)
    assert_same_text(got, j_export(jrec))
    assert_same_text(json.dumps(chrome_trace_events(trec)), json.dumps(j_events(jrec)))
    doc = json.loads(got)
    n_dispatch = sum(1 for e in doc["traceEvents"] if e.get("cat") == "dispatch")
    assert n_dispatch == sum(s.n_dispatches for s in trec.shards.values()) > 0


@pytest.mark.parametrize("window_s", [0.0005, 0.01])
def test_windowed_series_equals_the_reference(window_s):
    _, jrec, trec = recorded_pair()
    got, want = windowed_series(trec, window_s), j_windowed(jrec, window_s)
    assert_same_text(json.dumps(got, sort_keys=True), json.dumps(want, sort_keys=True))
    assert sum(got["arrivals"]) == sum(s.n_arrivals for s in trec.shards.values())


def test_empty_recorder_series_equal_the_reference():
    assert windowed_series(FlightRecorder(), 0.01) == j_windowed(jrecorder.FlightRecorder(), 0.01)
    assert export_chrome_trace(FlightRecorder()) == j_export(jrecorder.FlightRecorder())
    with pytest.raises(ValueError):
        windowed_series(FlightRecorder(), 0.0)


def test_shard_payload_round_trips():
    """What a shard worker ships back rebuilds the same shard."""
    _, _, trec = recorded_pair()
    for rid, shard in trec.shards.items():
        back = ReplicaShard.from_payload(shard.payload())
        assert back.payload() == shard.payload()
        assert back.replica_id == rid


@pytest.mark.parametrize("bucket", [
    ("gemm", 1024, 1024, 1024, "float32"),
    ("request", 17),
    ("prefill", 128),
    "decode",
], ids=["gemm", "request", "prefill", "str"])
def test_bucket_labels_equal_the_reference(bucket):
    if bucket[0] == "gemm":
        want = jrecorder.bucket_label(JBucket(*bucket))
        got = trecorder.bucket_label(ShapeBucket(*bucket))
        assert got == want == "gemm 1024x1024x1024 float32"
    else:
        assert trecorder.bucket_label(bucket) == jrecorder.bucket_label(bucket)
