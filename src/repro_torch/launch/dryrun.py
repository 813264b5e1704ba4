"""Dry run: build every (arch x input shape x mesh) step and count it on
the meta device, then write the roofline record.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k --mesh host
    python -m repro_torch.launch.dryrun --all --mesh pod1 --out experiments/dryrun_torch

The JAX package lowers and compiles each step for 512 placeholder TPU
devices. The port runs on one card and compiles nothing: ``build_step``'s
program runs once on ``torch.device("meta")`` (no allocation, no values)
under ``MetaCount``, a ``TorchDispatchMode`` that reads every aten op:

* ``hlo_flops_raw``: the program's matmul-class FLOPs by
  ``torch.utils.flop_counter``'s formulas; ``hlo_bytes_raw``: the input
  and output bytes of every op that is not a view. The keys keep the
  reference's names so the same readers take both records; here they are
  meta-device counts. A meta tensor reaches the plain version of each op
  (``kernels.ops``), so they count the plain versions' arithmetic:
  attention computes the full S x S product under its mask, and a WKV6
  scan all T steps at once (``ref.wkv6_scan``). As in the reference, the
  roofline terms come from ``roofline.analytic_cost``; the raw counts are
  kept for transparency.
* ``memory_analysis``: argument and output bytes per device are exact,
  ``shard_shape`` of every leaf under the step's specs on the chosen mesh.
  Temporaries are counted only on ``--mesh host`` (one card): the peak live
  bytes of the buffers the meta run creates. A pod mesh's temporaries
  belong to a partitioned program the port never builds, so the pod
  records leave ``temp_size_in_bytes`` out and say why.
* ``coll_bytes`` is zero in every kind (a one-card program issues no
  collective); ``analytic_coll`` is the reference's first-order model on a
  pod mesh and zero on ``host``.
* ``build_s`` (building the model, the meta stand-ins and the specs) and
  ``meta_run_s`` (the counted run) stand where the reference records
  ``lower_s`` and ``compile_s``.

``--mesh`` takes the reference's ``pod1`` and ``pod2`` and ``host``, the
one-card mesh (``make_host_mesh``). A meta run costs ~0.15 ms of host
time an op (tens of thousands of ops a full-depth step), so ``--jobs N``
runs the records in N worker processes; the records are the same. A
failing step is recorded with its exception and traceback, and the exit
code is 1 when any record has ``status: "error"``.
"""

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.config import INPUT_SHAPES, get_config, get_shape, list_configs
from repro_torch.distributed.constraints import use_mesh
from repro_torch.distributed.sharding import shard_bytes, spec_leaves
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import build_step, eligible

MESHES = ("pod1", "pod2", "host")
TEMP_NOTE = ("left out on a pod mesh: its per-device temporaries belong to the partitioned "
             "program, which one card never builds; --mesh host counts them")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaCount(TorchDispatchMode):
    """Counts a program run on meta tensors: matmul-class FLOPs
    (``flop_registry``), the input and output bytes of every non-view op,
    and the peak live bytes of the buffers created during the run (buffers
    of tensors passed in, ``external``, are not counted)."""

    def __init__(self, external=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in external}
        self._sizes = {}

    def _free(self, key):
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._known or key in self._sizes:
                continue
            size = storage.nbytes()
            self._sizes[key] = size
            weakref.finalize(storage, self._free, key)
            self.live += size
            self.peak = max(self.peak, self.live)
        return out


def _tensors(tree):
    return [t for t in spec_leaves(tree) if isinstance(t, torch.Tensor)]


def run_one(arch: str, shape_name: str, mesh_name: str, out_dir=None, verbose=True,
            remat: str = "block", policy: str = "fsdp", tp_acts: str = "auto",
            tenants: int = 1, microbatch: int = 1):
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = eligible(cfg, shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "remat": remat,
              "policy": policy, "tp_acts": tp_acts, "tenants": tenants,
              "microbatch": microbatch}
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        _write(record, out_dir)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIP ({why})")
        return record

    mesh = make_host_mesh() if mesh_name == "host" else \
        make_production_mesh(multi_pod=(mesh_name == "pod2"))
    chips = mesh.size
    t0 = time.time()
    try:
        step_fn, args, in_specs, out_specs = build_step(
            cfg, shape_name, mesh, remat=remat, policy=policy, tenants=tenants,
            microbatch=microbatch, device="meta")
        t_build = time.time() - t0
        tp_on = tp_acts != "off"
        arg_bytes = shard_bytes(list(args), list(in_specs), mesh)
        count = MetaCount(external=_tensors(list(args)))
        with use_mesh(mesh, tp_activations=tp_on), count:
            outputs = step_fn(*args)
        t_run = time.time() - t0 - t_build
        out_bytes = shard_bytes(list(outputs), list(out_specs), mesh)

        ana = rl.analytic_cost(cfg, shape, remat=(remat == "block"))
        if chips == 1:
            ana_coll = {"weight_ag": 0.0, "grad_ar": 0.0, "tp_ar": 0.0, "pod_ar": 0.0,
                        "total": 0.0}
        else:
            ana_coll = rl.analytic_collectives(
                cfg, shape,
                # tenant-stacked serving forces tp weights internally
                policy="tp" if tenants > 1 else policy,
                tp_acts=tp_on,
                pods=2 if mesh_name == "pod2" else 1,
            )
        report = rl.RooflineReport(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            hlo_flops=float(count.flops), hlo_bytes=float(count.bytes),
            coll_bytes=rl.no_collectives(),
            model_flops=rl.model_flops_for(cfg, shape),
            analytic_flops=ana["flops"], analytic_bytes=ana["hbm_bytes"],
            analytic_coll=ana_coll,
        )
        record.update(report.to_dict())
        record["status"] = "ok"
        record["build_s"] = round(t_build, 2)
        record["meta_run_s"] = round(t_run, 2)
        record["meta_ops"] = count.ops
        record["memory_analysis"] = _mem_dict(arg_bytes, out_bytes,
                                              count.peak if mesh_name == "host" else None)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                  f"(build {t_build:.1f}s meta run {t_run:.1f}s, {count.ops} ops)")
            print(f"  memory_analysis: {record['memory_analysis']}")
            print(f"  meta counts: flops={count.flops:.3e} bytes={count.bytes:.3e}")
            print(f"  roofline: compute={report.t_compute:.3e}s "
                  f"memory={report.t_memory:.3e}s collective={report.t_collective:.3e}s "
                  f"-> {report.bottleneck}-bound; useful-FLOPs ratio "
                  f"{report.useful_flops_ratio:.3f}")
    except Exception as e:  # noqa: BLE001 -- record the failure, it's a bug to fix
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: ERROR {record['error']}")
    _write(record, out_dir)
    return record


def _mem_dict(arg_bytes: int, out_bytes: int, temp_bytes):
    out = {"argument_size_in_bytes": int(arg_bytes), "output_size_in_bytes": int(out_bytes)}
    if temp_bytes is None:
        out["temp_size_note"] = TEMP_NOTE
    else:
        out["temp_size_in_bytes"] = int(temp_bytes)
    total = out["argument_size_in_bytes"] + out.get("temp_size_in_bytes", 0) \
        + out["output_size_in_bytes"]
    out["approx_total_per_device_bytes"] = total
    out["approx_total_per_device_gib"] = round(total / 2**30, 3)
    return out


def _write(record, out_dir):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if record.get("policy", "fsdp") == "fsdp" else f"__{record['policy']}"
    if record.get("tenants", 1) > 1:
        suffix += f"__R{record['tenants']}"
    if record.get("microbatch", 1) > 1:
        suffix += f"__mb{record['microbatch']}"
    path = os.path.join(
        out_dir,
        f"{record['arch']}__{record['shape']}__{record['mesh']}{suffix}.json",
    )
    record = dict(record)
    record.pop("traceback", None)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod1", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--remat", default="block", choices=["block", "none"])
    ap.add_argument("--policy", default="fsdp",
                    choices=["fsdp", "tp", "replicate", "auto"])
    ap.add_argument("--tp-acts", default="auto", choices=["auto", "on", "off"],
                    help="tensor-parallel activation constraints (recorded; one card "
                         "applies none)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="R>1: tenant-stacked multi-tenant serve step (decode shapes)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="k>1: gradient-accumulation microbatching (train shapes)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes that run the records (default 1: in this process)")
    args = ap.parse_args(argv)

    if args.all:
        archs = list_configs()
        shapes = list(INPUT_SHAPES)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        archs, shapes = [args.arch], [args.shape]

    kw = dict(out_dir=args.out, remat=args.remat, policy=args.policy, tp_acts=args.tp_acts,
              tenants=args.tenants, microbatch=args.microbatch)
    cases = [(arch, shape) for arch in archs for shape in shapes]
    if args.jobs > 1:
        # the long meta runs (train, then prefill: whole sequences) go first
        order = {"train": 0, "prefill": 1, "decode": 2}
        cases.sort(key=lambda c: order.get(get_shape(c[1]).kind, 3))
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futures = [pool.submit(run_one, arch, shape, args.mesh, **kw)
                       for arch, shape in cases]
            records = [f.result() for f in futures]
    else:
        records = [run_one(arch, shape, args.mesh, **kw) for arch, shape in cases]
    sys.exit(1 if any(rec["status"] == "error" for rec in records) else 0)


if __name__ == "__main__":
    main()
