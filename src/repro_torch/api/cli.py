"""``python -m repro_torch`` — the unified CLI over live, sim, and fleet runs.

Subcommands:

    simulate   run one spec end to end, print the headline summary,
               optionally write the RunReport JSON (--out) and gate
               determinism (--check: run twice, byte-identical metrics;
               live specs check report schema/shape invariants instead —
               wall-clock runs are not byte-reproducible)
    serve      HTTP front door over a live fleet (ServeSpec JSON):
               GET /healthz, POST /v1/predict, GET /v1/report
    sweep      cross-product grid over spec fields (--axis a.b=v1,v2),
               BENCH-style JSON export, --dry-run lists the cells
    trace      run one spec with the flight recorder forced on and export
               the Chrome trace_event JSON (open in Perfetto) plus
               optional windowed telemetry; --check gates byte-identical
               trace export across a same-seed rerun
    report     inspect a saved RunReport JSON: the headline summary,
               scheduler counters, and (--timeline) the windowed
               telemetry series recorded by an observability-enabled run
    calibrate  fit a CalibratedCostModel from LIVE dispatches of the
               spec's kernel mix and save the table for simulated replay
    check      validate a spec file and print the resolved plan without
               running anything
    specs      list every registered name a spec can reference
               (hardware, mixes, processes, routers, autoscalers,
               strategies)

All subcommands speak the same declarative ``SystemSpec`` JSON
(``repro_torch.api.spec``); ``--set section.field=value`` overrides any field
from the command line, so a committed spec file plus a couple of --set
flags replaces each of the old per-benchmark argparse forests.

The port's counterpart of ``repro.api.cli``, subcommand for subcommand.
Its hardware names are the H100's (``specs`` lists them): a committed
spec that names the reference's card runs with ``--set
cost_model.hardware=h100`` (and ``--set 'fleet.specs=["h100","h100_half"]'``
where it lists cards). ``calibrate`` draws its operands with torch on the
card; live specs of a real architecture serve on the card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.api.spec import (
    MIXES,
    MODES,
    PROCESSES,
    SystemSpec,
)
from repro_torch.sim.costmodel import STRATEGIES
from repro_torch.sim.metrics import SCHEMA_VERSION, to_bench_json
from repro_torch.sim.router import ROUTERS


def _parse_value(text: str):
    """CLI value -> JSON value: try JSON first (numbers, booleans, null,
    lists), fall back to the bare string."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def _parse_sets(pairs: Sequence[str]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(
                f"--set/--axis needs section.field=value, got {pair!r}")
        key, _, value = pair.partition("=")
        out[key.strip()] = _parse_value(value.strip())
    return out


def _load_spec(args, extra_sets: Optional[Dict[str, object]] = None) -> SystemSpec:
    """The spec of ``--spec`` (or the defaults) with ``--events``,
    ``--seed``, ``--set`` and ``extra_sets`` applied. A file's overrides
    are merged into its JSON before it is built, so ``--set
    cost_model.hardware=h100`` runs a file that names another card
    (``repro_torch.api.spec``)."""
    overrides: Dict[str, object] = {}
    if getattr(args, "events", None) is not None:
        overrides["workload.events"] = args.events
    if getattr(args, "seed", None) is not None:
        overrides["workload.seed"] = args.seed
    overrides.update(_parse_sets(getattr(args, "set", None) or []))
    overrides.update(extra_sets or {})
    if args.spec:
        return SystemSpec.load(args.spec, overrides)
    spec = SystemSpec()
    return spec.replace(**overrides) if overrides else spec


def _print_summary(report) -> None:
    s = report.summary
    print(f"executor={report.executor} mode={report.mode} "
          f"schema_version={report.schema_version}")
    keys = ("completed", "requests", "dispatches", "p50_s", "p95_s", "p99_s",
            "slo_attainment", "goodput_cost_per_s", "utilization",
            "replicas", "final_active", "cold_start_fraction", "wall_s")
    for k in keys:
        if k in s:
            v = s[k]
            if k in ("p50_s", "p95_s", "p99_s"):
                print(f"  {k:22s} {v * 1e3:12.3f} ms")
            elif k == "wall_s":
                print(f"  {k:22s} {v:12.3f} s")
            else:
                print(f"  {k:22s} {v:12.4g}")


# ------------------------------------------------------------------ simulate
def _check_live_report(report, spec) -> List[str]:
    """Schema/shape invariants for live reports — the wall clock makes
    byte equality meaningless, but the report contract is still checkable:
    versioned schema, the shared summary keys, and request accounting
    that adds up."""
    problems: List[str] = []
    m = report.metrics
    if report.schema_version != SCHEMA_VERSION:
        problems.append(f"schema_version {report.schema_version!r} != "
                        f"{SCHEMA_VERSION}")
    summary = m.get("summary")
    if not isinstance(summary, dict):
        problems.append("metrics.summary missing")
    else:
        for k in ("completed", "p50_s", "p95_s", "slo_attainment"):
            if k not in summary:
                problems.append(f"summary.{k} missing")
    sched = m.get("scheduler")
    if not isinstance(sched, dict):
        problems.append("metrics.scheduler missing")
    routed = m.get("routed_counts")
    if not isinstance(routed, list) or \
            len(routed) != spec.fleet.replicas:
        problems.append(f"routed_counts should list {spec.fleet.replicas} "
                        f"replicas, got {routed!r}")
    elif isinstance(sched, dict):
        admitted = sum(routed)
        # scheduler `rejected` counts every refusal (cap + infeasible)
        rejected = sched.get("rejected", 0)
        if admitted + rejected != spec.workload.events:
            problems.append(
                f"request accounting: routed {admitted} + rejected "
                f"{rejected} != {spec.workload.events} events offered")
        if sched.get("completed", 0) > admitted:
            problems.append(f"completed {sched['completed']} > admitted "
                            f"{admitted}")
    for k in ("arch", "engine", "wall_s"):
        if k not in m:
            problems.append(f"metrics.{k} missing")
    return problems


def cmd_simulate(args) -> int:
    spec = _load_spec(args)
    executor = spec.build()
    report = executor.run()
    _print_summary(report)
    if args.check:
        if spec.mode == "live":
            problems = _check_live_report(report, spec)
            print("live --check verifies report schema/shape invariants "
                  "(wall-clock runs are not byte-reproducible): "
                  f"{'OK' if not problems else 'FAILED'}")
            if problems:
                for p in problems:
                    print(f"CHECK FAILED: {p}", file=sys.stderr)
                return 1
        else:
            rerun = spec.build().run()
            identical = rerun.to_json() == report.to_json()
            print(f"same-seed rerun byte-identical: {identical}")
            if not identical:
                print("CHECK FAILED: rerun JSON differs (nondeterminism)",
                      file=sys.stderr)
                return 1
    if args.out:
        report.save(args.out)
        print(f"wrote {args.out}")
    return 0


# --------------------------------------------------------------------- serve
def cmd_serve(args) -> int:
    import dataclasses

    from repro_torch.api.spec import ServeSpec
    from repro_torch.launch.serve import run_server

    spec = ServeSpec.load(args.spec)
    overrides = {}
    if args.port is not None:
        overrides["port"] = args.port
    if args.report is not None:
        overrides["report_path"] = args.report
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    run_server(spec)
    return 0


# --------------------------------------------------------------------- trace
def cmd_trace(args) -> int:
    from repro_torch.obs.trace_export import export_chrome_trace

    extra: Dict[str, object] = {"observability.enabled": True}
    if args.window is not None:
        extra["observability.window_s"] = args.window
    spec = _load_spec(args, extra_sets=extra)
    if spec.mode == "live":
        raise SystemExit(
            "trace drives the simulated executors (live runs can enable "
            "the recorder via observability.trace_path on the spec); "
            "set mode='sim'")
    executor = spec.build()
    executor.run_metrics()
    rec = executor.last_recorder
    text = export_chrome_trace(rec) + "\n"
    with open(args.out, "w") as fh:
        fh.write(text)
    print(f"wrote {args.out} ({rec.total_events()} recorded events) — "
          f"open it at ui.perfetto.dev or chrome://tracing")
    if args.telemetry:
        from repro_torch.obs.telemetry import windowed_series

        series = windowed_series(rec, spec.observability.window_s)
        with open(args.telemetry, "w") as fh:
            fh.write(json.dumps(series, indent=2, sort_keys=True) + "\n")
        print(f"wrote {args.telemetry} ({series['windows']} windows of "
              f"{spec.observability.window_s * 1e3:g} ms)")
    if args.check:
        rerun = spec.build()
        rerun.run_metrics()
        identical = export_chrome_trace(rerun.last_recorder) + "\n" == text
        print(f"same-seed rerun trace byte-identical: {identical}")
        if not identical:
            print("CHECK FAILED: rerun trace differs (nondeterminism)",
                  file=sys.stderr)
            return 1
    return 0


# -------------------------------------------------------------------- report
def cmd_report(args) -> int:
    from repro_torch.api.report import RunReport

    rep = RunReport.load(args.report)
    _print_summary(rep)
    sched = rep.metrics.get("scheduler")
    if isinstance(sched, dict):
        print("scheduler counters:")
        for k in sorted(sched):
            v = sched[k]
            if isinstance(v, list):
                print(f"  {k:22s} {v}")
            else:
                print(f"  {k:22s} {v:12.4g}")
    if not args.timeline:
        return 0
    t = rep.metrics.get("telemetry")
    if not isinstance(t, dict) or not t.get("windows"):
        raise SystemExit(
            "no telemetry in this report: re-run its spec with "
            "observability.enabled=true (e.g. `python -m repro_torch simulate "
            "--spec ... --set observability.enabled=true --out ...`)")
    w_ms = t["window_s"] * 1e3
    print(f"timeline: {t['windows']} windows of {w_ms:g} ms "
          f"(t0 = {t['t0_s']:g} s)")
    print(f"{'win':>5s} {'arrive':>7s} {'reject':>7s} {'done':>7s} "
          f"{'p50 ms':>9s} {'p95 ms':>9s} {'attain':>7s} {'backlog':>8s} "
          f"{'util':>6s}")
    for k in range(t["windows"]):
        print(f"{k:5d} {t['arrivals'][k]:7d} {t['rejected'][k]:7d} "
              f"{t['completed'][k]:7d} {t['p50_ms'][k]:9.3f} "
              f"{t['p95_ms'][k]:9.3f} {t['slo_attainment'][k]:7.3f} "
              f"{t['backlog'][k]:8d} {t['utilization'][k]:6.2f}")
    return 0


# --------------------------------------------------------------------- sweep
def _cells(axes: List[Tuple[str, List[object]]]):
    names = [a[0] for a in axes]
    for combo in itertools.product(*(a[1] for a in axes)):
        label = "_".join(f"{n.split('.')[-1]}={v}" for n, v in zip(names, combo))
        yield label, dict(zip(names, combo))


def cmd_sweep(args) -> int:
    axes: List[Tuple[str, List[object]]] = []
    for pair in args.axis or ():
        key, _, values = pair.partition("=")
        if not values:
            raise SystemExit(f"--axis needs section.field=v1,v2,..., got {pair!r}")
        axes.append((key.strip(),
                     [_parse_value(v) for v in values.split(",") if v != ""]))
    if not axes:
        raise SystemExit("sweep needs at least one --axis section.field=v1,v2")

    base = _load_spec(args)
    cells = list(_cells(axes))
    print(f"sweep over {' x '.join(f'{k}[{len(v)}]' for k, v in axes)}: "
          f"{len(cells)} cells")
    if args.dry_run:
        for label, overrides in cells:
            base.replace(**overrides)  # validate every cell
            print(f"  {label}")
        print("dry run: all cells validate; re-run without --dry-run to "
              "execute")
        return 0

    sections = {}
    print(f"{'cell':>40s} {'p95 ms':>9s} {'attain':>7s} {'goodput':>10s}")
    for label, overrides in cells:
        spec = base.replace(**overrides)
        if spec.mode == "live":
            raise SystemExit("sweep drives the simulated executors; run "
                             "live cells one at a time with `simulate`")
        m = spec.build().run_metrics()
        sections[label] = m
        s = m.summary()
        print(f"{label:>40s} {s['p95_s'] * 1e3:9.3f} "
              f"{s['slo_attainment']:7.3f} {s['goodput_cost_per_s']:10.4g}")
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(to_bench_json(
                args.name, sections,
                extra={"spec": base.to_dict(),
                       "axes": {k: v for k, v in axes}}))
        print(f"wrote {args.json}")
    return 0


# ----------------------------------------------------------------- calibrate
def calibrate(spec: SystemSpec, device=None):
    """Fit a ``CalibratedCostModel`` from live dispatches of the spec's
    kernel mix: every arrival of the spec's trace submits its tenant's
    float32 ``GemmProblem`` to a ``DynamicSpaceTimeScheduler`` whose
    ``on_dispatch`` tap feeds the table, so each merged dispatch is one
    ``batched_gemm`` launch on the card. ``device`` is the card unless the
    caller asks for another (the tests pass "cpu", where the dispatches
    run the plain version); with no card it raises. Returns (the model,
    arrivals submitted)."""
    from repro_torch.api.build import build_mix, build_trace, fold_seed
    from repro_torch.sim.costmodel import CalibratedCostModel

    mix = build_mix(spec.workload)
    non_kernel = sorted({s.kind for s in mix} - {"kernel"})
    if non_kernel:
        raise SystemExit(
            f"calibrate drives real GEMM dispatches, so it needs a kernel "
            f"mix (sgemm / fleet / single); {spec.workload.mix!r} contains "
            f"{non_kernel} workloads")

    import numpy as np
    import torch

    from repro_torch.core import DynamicSpaceTimeScheduler, GemmProblem
    from repro_torch.models.transformer import resolve_device

    dev = resolve_device(device)
    model = CalibratedCostModel(ewma_alpha=spec.cost_model.ewma_alpha)
    sched = DynamicSpaceTimeScheduler(
        spec.scheduler.to_schedule_config() if spec.scheduler else None,
        on_dispatch=model.observe)

    # device-resident operands per (tenant, bucket): weights per tenant,
    # a small rotation of activations per bucket shape
    def normal(shape, stream: int) -> torch.Tensor:
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_seed(spec.workload.seed, stream))
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    rng = np.random.default_rng(spec.workload.seed)
    xs: Dict[object, List] = {}
    ws: Dict[Tuple[int, object], object] = {}
    for i, t in enumerate(mix):
        b = t.bucket
        if b not in xs:
            xs[b] = [normal((b.M, b.K), 1000 + 8 * i + j) for j in range(4)]
        ws[(t.tenant_id, b)] = normal((b.K, b.N), i)

    submitted = 0
    for ev in build_trace(spec, mix):
        t = ev.spec
        sched.submit(GemmProblem(
            tenant_id=t.tenant_id,
            x=xs[t.bucket][int(rng.integers(len(xs[t.bucket])))],
            w=ws[(t.tenant_id, t.bucket)],
            slo_s=t.slo_s))
        sched.pump()
        submitted += 1
    sched.flush()
    return model, submitted


def cmd_calibrate(args) -> int:
    spec = _load_spec(args)
    model, submitted = calibrate(spec)
    model.save(args.out)
    print(f"calibrated {len(model.table)} (bucket, pow2-R) keys from "
          f"{submitted} live arrivals -> {args.out}")
    print(f"replay them with: cost_model.kind=calibrated "
          f"cost_model.calibration_path={args.out}")
    return 0


# --------------------------------------------------------------------- check
def cmd_check(args) -> int:
    from repro_torch.api.build import build_mix, resolve_rate_hz

    spec = _load_spec(args)
    print(f"spec OK (schema_version {SCHEMA_VERSION}): "
          f"{args.spec or '<defaults>'}")
    executor = spec.build()
    w, f = spec.workload, spec.fleet
    print(f"  mode={spec.mode} -> executor: {executor.executor}")
    line = f"  workload: mix={w.mix} tenants={w.tenants} process={w.process}"
    if w.process == "replay":
        line += f" csv={w.csv_path}"
    else:
        line += f" events={w.events} seed={w.seed}"
    print(line)
    if spec.mode != "live" and w.process != "replay":
        rate = resolve_rate_hz(spec, build_mix(w))
        anchor = (f"rho={w.rho}" if w.rate_hz is None
                  else "explicit rate_hz")
        print(f"  offered load: ~{rate:,.0f} arrivals/s ({anchor})")
    if f.is_fleet:
        hw = ",".join(f.specs) if f.specs else spec.cost_model.hardware
        scale = (f", autoscale {f.autoscale.policy} "
                 f"{f.autoscale.min_replicas}..{f.autoscale.max_replicas}"
                 if f.autoscale else "")
        print(f"  fleet: {f.replicas} replica(s) of [{hw}], "
              f"router={spec.router.policy}{scale}")
    elif spec.mode == "live":
        print(f"  live engine: arch={w.arch} tenants={w.tenants} "
              f"requests={w.events} (prompt {w.prompt_tokens}, "
              f"decode {w.max_new_tokens})")
    else:
        print(f"  solo replica on {spec.cost_model.hardware}")
    cm = spec.cost_model
    cold = f", cold-start compile {cm.compile_us:g}us" if cm.compile_us else ""
    table = (f", table={cm.calibration_path}" if cm.kind == "calibrated"
             else "")
    print(f"  cost model: {cm.kind} on {cm.hardware}, "
          f"strategy={cm.strategy}{cold}{table}")
    sched = spec.scheduler
    if sched is None:
        print("  scheduler: executor defaults")
    else:
        print(f"  scheduler: window={sched.batching_window_s * 1e3:g}ms "
              f"({sched.batching_policy}), "
              f"max_superkernel_size={sched.max_superkernel_size}")
    if spec.partition is not None:
        from repro_torch.api.build import build_partition

        plan, _ = build_partition(spec, build_mix(w))
        replan = (f", replan every {spec.partition.replan_interval_s:g}s"
                  if spec.partition.replan_interval_s > 0 else "")
        print(f"  partition: policy={spec.partition.policy}, "
              f"{len(plan.groups)} slice(s) per replica{replan}")
        for g in plan.groups:
            win = (f", window={g.window_s * 1e3:g}ms"
                   if g.window_s is not None else "")
            print(f"    {g.name}: share={g.share:.4g} "
                  f"tenants={list(g.tenants)}{win}")
    return 0


# --------------------------------------------------------------------- specs
def cmd_specs(args) -> int:
    from repro_torch.launch.roofline import HARDWARE_SPECS
    from repro_torch.api.spec import AUTOSCALERS, PARTITION_POLICIES

    doc = {
        "schema_version": SCHEMA_VERSION,
        "hardware": {
            name: {"peak_tflops": hw.peak_flops / 1e12,
                   "hbm_gb_s": hw.hbm_bw / 1e9}
            for name, hw in sorted(HARDWARE_SPECS.items())},
        "mixes": list(MIXES),
        "processes": list(PROCESSES),
        "routers": list(ROUTERS),
        "autoscalers": list(AUTOSCALERS),
        "strategies": list(STRATEGIES),
        "partition_policies": list(PARTITION_POLICIES),
        "modes": list(MODES),
    }
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    print(f"spec schema_version: {SCHEMA_VERSION}")
    print("hardware (cost_model.hardware / fleet.specs):")
    for name, hw in doc["hardware"].items():
        print(f"  {name:12s} {hw['peak_tflops']:8.1f} TFLOP/s "
              f"{hw['hbm_gb_s']:8.0f} GB/s HBM")
    for label, key in (("mixes (workload.mix)", "mixes"),
                       ("processes (workload.process)", "processes"),
                       ("routers (router.policy)", "routers"),
                       ("autoscalers (fleet.autoscale.policy)", "autoscalers"),
                       ("strategies (cost_model.strategy)", "strategies"),
                       ("partition policies (partition.policy)",
                        "partition_policies"),
                       ("modes (mode)", "modes")):
        print(f"{label}: {', '.join(doc[key])}")
    return 0


# ---------------------------------------------------------------------- main
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="One front door over the repo's live, sim, and fleet "
                    "execution paths, driven by declarative SystemSpec JSON "
                    "(see examples/specs/).")
    sub = ap.add_subparsers(dest="command", required=True)

    def add_spec_args(p, events_help="override workload.events"):
        p.add_argument("--spec", default=None,
                       help="SystemSpec JSON file (default: built-in defaults)")
        p.add_argument("--set", action="append", metavar="FIELD=VALUE",
                       help="override any spec field by dotted path, e.g. "
                            "--set router.policy=least_cost")
        p.add_argument("--events", type=int, default=None, help=events_help)
        p.add_argument("--seed", type=int, default=None,
                       help="override workload.seed")

    p = sub.add_parser("simulate", help="run one spec, print the summary")
    add_spec_args(p)
    p.add_argument("--out", default=None, help="write the RunReport JSON here")
    p.add_argument("--check", action="store_true",
                   help="run twice and fail unless metrics JSON is "
                        "byte-identical (sim determinism gate)")
    p.set_defaults(func=cmd_simulate)

    p = sub.add_parser("serve",
                       help="HTTP front door over a live fleet "
                            "(/healthz, /v1/predict, /v1/report)")
    p.add_argument("--spec", required=True, help="ServeSpec JSON file")
    p.add_argument("--port", type=int, default=None,
                   help="override serve.port (0 picks a free port)")
    p.add_argument("--report", default=None,
                   help="override serve.report_path (RunReport JSON "
                        "written on graceful shutdown)")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("trace",
                       help="run with the flight recorder on, export a "
                            "Perfetto-loadable Chrome trace")
    add_spec_args(p)
    p.add_argument("--out", default="trace.json",
                   help="write the Chrome trace_event JSON here "
                        "(default: trace.json)")
    p.add_argument("--telemetry", default=None,
                   help="also write the windowed telemetry series JSON here")
    p.add_argument("--window", type=float, default=None,
                   help="telemetry window in seconds "
                        "(override observability.window_s)")
    p.add_argument("--check", action="store_true",
                   help="re-run same-seed and fail unless the exported "
                        "trace is byte-identical")
    p.set_defaults(func=cmd_trace)

    p = sub.add_parser("report",
                       help="inspect a saved RunReport (summary, scheduler "
                            "counters, --timeline telemetry)")
    p.add_argument("report", help="RunReport JSON file (simulate --out)")
    p.add_argument("--timeline", action="store_true",
                   help="print the windowed telemetry table")
    p.set_defaults(func=cmd_report)

    p = sub.add_parser("sweep", help="grid over spec fields")
    add_spec_args(p)
    p.add_argument("--axis", action="append", metavar="FIELD=V1,V2,...",
                   help="sweep axis by dotted path (repeatable; cells are "
                        "the cross product)")
    p.add_argument("--json", default=None, help="write BENCH-style JSON here")
    p.add_argument("--name", default="repro_sweep",
                   help="benchmark name in the JSON document")
    p.add_argument("--dry-run", action="store_true",
                   help="validate and list the cells without running")
    p.set_defaults(func=cmd_sweep)

    p = sub.add_parser("calibrate",
                       help="fit a measured-cost table from live dispatches")
    add_spec_args(p, events_help="live arrivals to fit from")
    p.add_argument("--out", required=True,
                   help="write the CalibratedCostModel JSON here")
    p.set_defaults(func=cmd_calibrate)

    p = sub.add_parser("check", help="validate a spec and print the plan")
    add_spec_args(p)
    p.set_defaults(func=cmd_check)

    p = sub.add_parser("specs", help="list registered names specs can use")
    p.add_argument("--json", action="store_true", help="machine-readable")
    p.set_defaults(func=cmd_specs)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except (TypeError, ValueError) as e:
        # spec validation errors are user errors: one actionable line, no
        # traceback. TypeError covers mistyped JSON values ("tenants":
        # "8") surfacing from dataclass __post_init__ comparisons.
        print(f"spec error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
