"""``chip_smoke.py``'s phase 8 (a live fleet) rehearsed on the CPU.

``torch.cuda`` is stubbed, the attention ops and kernel wrappers count a
launch of their variant and run the plain version, and stablelm-1.6b is
its smoke variant, so the phase's control flow and checks run here: the
wall-clock trace drive, both modes, the recorder, Chrome trace and
calibrator checks, the launch-variant checks and the ``fleet`` object it
prints. The card's numbers come only from the card.
"""

import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]


class _Event:
    def __init__(self, **_):
        pass

    def record(self):
        pass

    def elapsed_time(self, _other):
        return 1.0


@pytest.fixture
def smoke(monkeypatch):
    """``chip_smoke`` with the card stubbed and phase 8 shrunk."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    import repro_torch.config
    from repro_torch.config import smoke_variant
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    for name in ("synchronize", "_sleep", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(chip_smoke, "gpu_identity", lambda: "CPU rehearsal, no card")
    get = repro_torch.config.get_config
    monkeypatch.setattr(repro_torch.config, "get_config", lambda arch: dataclasses.replace(
        smoke_variant(get(arch)), dtype="bfloat16"))

    def flash(q, k, v, *, causal=True, window=0, scale=None, logit_softcap=0.0, q_offset=None,
              kernel=None):
        fa.counter.launched(kernel or fa.variant(q.dtype, q.shape[-1]))
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                             logit_softcap=logit_softcap, q_offset=q_offset)

    def decode(q, kc, vc, lengths, *, scale=None, kernel=None):
        da.counter.launched(
            kernel or da.variant(q.dtype, q.shape[-1], q.shape[1] // kc.shape[1]))
        return ref.decode_attention(q, kc, vc, lengths, scale=scale)

    for mod, name, fn in ((ops, "flash_attention", flash), (fa, "flash_attention", flash),
                          (ops, "decode_attention", decode), (da, "decode_attention", decode)):
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(chip_smoke, "FLEET_REQUESTS", 8)
    monkeypatch.setattr(chip_smoke, "FLEET_RATE_HZ", 200.0)
    monkeypatch.setattr(chip_smoke, "FLEET_NEW", 3)
    monkeypatch.setattr(chip_smoke, "LAUNCH_TERM_ITERS", 10)
    return chip_smoke, ops


def test_phase_8_runs_its_checks_on_the_cpu(smoke):
    chip_smoke, ops = smoke
    rows, fleet = chip_smoke.phase_fleet(ops, torch.device("cpu"), 0)
    json.dumps({"fleet": fleet, "kernels": rows})
    assert [r["mode"] for r in fleet["runs"]] == ["space_time", "time_only"]
    for run in fleet["runs"]:
        assert run["admitted"] == run["requests"] == 8
        assert len(run["dispatches"]) == 2 and min(run["dispatches"]) > 0
        assert sum(run["dispatches"]) == run["recorded_dispatches"]
        assert run["launches"]["flash_attention"] > 0 and run["launches"]["decode_attention"] > 0
        assert all(t for t in run["calibrated_s"].values())
    assert set(fleet["launch_terms"]) == {"dispatch_overhead_s", "context_switch_s"}
    # K4 at the median prefill, and (the fleet's engines prefill by pieces)
    # at a piece of it against the whole cache
    assert [r["name"] for r in rows] == ["decode_attention"] * 2 + ["flash_attention"] * 2
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(r) for r in rows)
    assert rows[0]["launches"] == fleet["runs"][0]["launches"]["decode_attention"]
    assert rows[1]["launches"] == fleet["runs"][1]["launches"]["decode_attention"]
    assert rows[2]["launches"] == rows[3]["launches"] == sum(
        r["launches"]["flash_attention"] for r in fleet["runs"])


def test_phase_8_fails_when_a_launch_takes_another_kernel(smoke, monkeypatch):
    chip_smoke, ops = smoke
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "variant", lambda dtype, D: "cuda_core")
    with pytest.raises(chip_smoke.PhaseFailed, match="flash_attention"):
        chip_smoke.phase_fleet(ops, torch.device("cpu"), 0)
