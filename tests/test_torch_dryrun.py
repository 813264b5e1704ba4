"""The port's dry run (``python -m repro_torch.launch.dryrun``): records
with the reference's file names and keys, meta-device counts, per-device
bytes from ``shard_shape``, the skip reasons of ``eligible``, and the
error path's exit code.

Full-depth records are the card's phase 11 and the CLI's; here configs are
the smoke variants (``get_config`` patched in the dry run's module) and the
shapes small ones registered in the port's shape table for the test.
"""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")

import repro.launch.roofline as jrl  # noqa: E402
from repro.launch.steps import eligible as jeligible  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402

import repro_torch.config.shapes as tshapes  # noqa: E402
from repro_torch.config import InputShape, get_config, smoke_variant  # noqa: E402
from repro_torch.distributed.sharding import shard_bytes, shard_shape, spec_leaves  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402

# The reference's record keys (src/repro/launch/dryrun.py: run_one's record
# and RooflineReport.to_dict); lower_s and compile_s become build_s and
# meta_run_s, and the port adds meta_ops.
RECORD_KEYS = {"arch", "shape", "mesh", "remat", "policy", "tp_acts", "tenants", "microbatch",
               "status", "memory_analysis"}
SMALL = {"small_train": (32, 4, "train"), "small_prefill": (64, 2, "prefill"),
         "small_decode": (64, 4, "decode")}


@pytest.fixture
def small(monkeypatch):
    for name, (seq, batch, kind) in SMALL.items():
        monkeypatch.setitem(tshapes.INPUT_SHAPES, name,
                            InputShape(name, seq_len=seq, global_batch=batch, kind=kind))
    monkeypatch.setattr(dryrun, "get_config", lambda arch: smoke_variant(get_config(arch)))


def _report_keys():
    rep = jrl.RooflineReport(arch="x", shape="y", mesh="pod1", chips=1, hlo_flops=0.0,
                             hlo_bytes=0.0, coll_bytes={}, model_flops=0.0)
    return set(rep.to_dict())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b", "granite-moe-1b-a400m",
                                  "zamba2-7b", "paligemma-3b"])
@pytest.mark.parametrize("shape", sorted(SMALL))
def test_host_records_have_the_reference_keys_and_exact_bytes(arch, shape, small, tmp_path):
    rec = dryrun.run_one(arch, shape, "host", out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS | _report_keys() | {"build_s", "meta_run_s", "meta_ops"}
    assert rec["chips"] == 1 and rec["coll_total"] == 0
    assert set(rec["coll_bytes"]) == set(jrl.COLL_FACTOR) and rec["analytic_coll"]["total"] == 0
    assert rec["hlo_flops_raw"] > 0 and rec["hlo_bytes_raw"] > 0 and rec["meta_ops"] > 0
    mem = rec["memory_analysis"]
    _, args, in_specs, _ = build_step(smoke_variant(get_config(arch)), shape,
                                      dryrun.make_host_mesh(), device="meta")
    whole = sum(t.numel() * t.element_size() for t in spec_leaves(list(args)))
    assert mem["argument_size_in_bytes"] == whole  # one card holds every argument
    assert mem["temp_size_in_bytes"] > 0
    assert mem["approx_total_per_device_bytes"] == (mem["argument_size_in_bytes"]
                                                     + mem["temp_size_in_bytes"]
                                                     + mem["output_size_in_bytes"])
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__host.json").read_text())
    assert on_disk == {k: v for k, v in rec.items()}


def test_pod_records_shard_the_arguments_and_leave_temporaries_out(small, tmp_path):
    rec = dryrun.run_one("stablelm-1.6b", "small_train", "pod1", out_dir=str(tmp_path),
                         verbose=False, policy="tp", microbatch=2)
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory_analysis"]
    assert "temp_size_in_bytes" not in mem and "temp_size_note" in mem
    mesh = make_production_mesh()
    _, args, in_specs, _ = build_step(smoke_variant(get_config("stablelm-1.6b")), "small_train",
                                      mesh, policy="tp", microbatch=2, device="meta")
    per_device = sum(math.prod(shard_shape(tuple(t.shape), s, mesh)) * t.element_size()
                     for t, s in zip(spec_leaves(list(args)), spec_leaves(list(in_specs))))
    assert mem["argument_size_in_bytes"] == per_device == shard_bytes(list(args),
                                                                       list(in_specs), mesh)
    assert rec["chips"] == 256 and rec["analytic_coll"]["total"] > 0
    assert (tmp_path / "stablelm-1.6b__small_train__pod1__tp__mb2.json").exists()
    rec2 = dryrun.run_one("stablelm-1.6b", "small_decode", "pod2", out_dir=str(tmp_path),
                          verbose=False, tenants=2)
    assert rec2["status"] == "ok" and rec2["chips"] == 512
    assert (tmp_path / "stablelm-1.6b__small_decode__pod2__R2.json").exists()


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-1.6b", "gemma3-27b", "stablelm-1.6b"])
def test_skips_carry_the_reason_from_eligible(arch, tmp_path):
    ok, why = jeligible(jget_config(arch), "long_500k")
    assert dryrun.eligible(get_config(arch), "long_500k") == (ok, why)
    if ok:
        return
    rec = dryrun.run_one(arch, "long_500k", "host", out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "skipped" and rec["reason"] == why
    assert json.loads((tmp_path / f"{arch}__long_500k__host.json").read_text())["reason"] == why


def test_an_error_is_recorded_and_sets_the_exit_code(small, monkeypatch, tmp_path, capsys):
    def broken(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "build_step", broken)
    rec = dryrun.run_one("stablelm-1.6b", "small_decode", "host", out_dir=str(tmp_path),
                         verbose=False)
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: no such step"
    assert "traceback" in rec
    assert "traceback" not in json.loads(
        (tmp_path / "stablelm-1.6b__small_decode__host.json").read_text())
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "small_decode", "--mesh", "host"])
    assert e.value.code == 1
    monkeypatch.undo()
    for name, (seq, batch, kind) in SMALL.items():
        monkeypatch.setitem(tshapes.INPUT_SHAPES, name,
                            InputShape(name, seq_len=seq, global_batch=batch, kind=kind))
    monkeypatch.setattr(dryrun, "get_config", lambda arch: smoke_variant(get_config(arch)))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "small_decode", "--mesh", "host"])
    assert e.value.code == 0


def test_the_meta_count_reads_flops_bytes_and_peak():
    """MetaCount on a known program: one (64 x 32) @ (32 x 16) product is
    2 * 64 * 32 * 16 FLOPs; its bytes are its inputs' and output's; the
    peak counts the buffers made during the run, not the arguments."""
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    count = dryrun.MetaCount(external=[a, b])
    with count:
        c = a @ b
        d = c.t()  # a view: no bytes, no new buffer
        e = d + 1.0
        del c, d, e
    assert count.flops == 2 * 64 * 32 * 16
    assert count.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 + (64 * 16 * 2) * 4 + 0
    assert count.peak == 2 * 64 * 16 * 4 and count.live == 0


def test_mesh_choices_and_help_name_the_host_mesh(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "pod1" in out and "pod2" in out and "host" in out and "--jobs" in out
    assert dataclasses.is_dataclass(dryrun.make_host_mesh())


def test_the_meta_wkv_scan_counts_the_loops_arithmetic():
    """On the meta device ``ref.wkv6_scan`` runs its T steps as one batched
    step: the same matmul FLOPs as its loop over real tensors, and outputs
    and state of the loop's shapes and dtypes."""
    from repro_torch.kernels import ref

    BH, T, N = 3, 7, 8
    gen = torch.Generator().manual_seed(0)
    real = [torch.randn((BH, T, N), generator=gen).to(torch.bfloat16) for _ in range(4)]
    u = torch.randn((BH, N), generator=gen)
    s0 = torch.randn((BH, N, N), generator=gen)
    counts = []
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in real] + [u.to(dev)]
        count = dryrun.MetaCount()
        with count:
            out, state = ref.wkv6_scan(*args, init_state=s0.to(dev))
        counts.append(count.flops)
        assert out.shape == (BH, T, N) and out.dtype == torch.bfloat16
        assert state.shape == (BH, N, N) and state.dtype == torch.float32
    assert counts[0] == counts[1] == 2 * BH * T * N * N
