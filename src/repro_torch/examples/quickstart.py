"""Quickstart: the paper's claim through the port's one front door; the
port of ``examples/quickstart.py``.

Loads the committed ``examples/specs/paper_mix.json`` SystemSpec (the
paper's Table-1 SGEMM tenant mix under tiered SLOs) on the port's card
(the file names the reference's; ``HARDWARE_SETS`` overrides it), runs it
under each multiplexing strategy, and prints the throughput ordering the
paper measures — space_time > space_only > time_only. Everything flows
through ``repro_torch.api``: the same spec, ``replace()``d per strategy,
picks the right executor and returns the same ``RunReport`` shape the
fleet and live paths produce.

Equivalent CLI:

    PYTHONPATH=src python -m repro_torch simulate --spec examples/specs/paper_mix.json \\
        --set cost_model.hardware=h100
    PYTHONPATH=src python -m repro_torch sweep --spec examples/specs/paper_mix.json \\
        --set cost_model.hardware=h100 \\
        --axis cost_model.strategy=time_only,space_only,space_time

For the live (real-kernel) versions of this demo see
``repro_torch.examples.spacetime_ablation`` and
``repro_torch.examples.multi_tenant_serving``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from pathlib import Path

from repro_torch.api import SystemSpec

SPECS = Path(__file__).resolve().parents[3] / "examples" / "specs"
SPEC = str(SPECS / "paper_mix.json")
HARDWARE_SETS = {"cost_model.hardware": "h100"}  # the port's card in place of the file's
EVENTS = None  # arrivals per run; None keeps the spec's own


def main() -> None:
    sets = dict(HARDWARE_SETS)
    if EVENTS is not None:
        sets["workload.events"] = EVENTS
    spec = SystemSpec.load(SPEC, sets)
    w = spec.workload
    print(f"spec: {SPEC}")
    print(f"{w.tenants} SGEMM tenants, {w.events} {w.process} arrivals "
          f"@ rho={w.rho} of space_time capacity, seed={w.seed}\n")

    print("strategy     tput cost/s    p95 ms   attain     util")
    tput = {}
    for strat in ("time_only", "space_only", "space_time"):
        report = spec.replace(**{"cost_model.strategy": strat}).run()
        s = report.summary
        tput[strat] = s["throughput_cost_per_s"]
        print(f"{strat:12s} {s['throughput_cost_per_s']:11.4g} "
              f"{s['p95_s']*1e3:9.3f} {s['slo_attainment']:8.3f} "
              f"{s['utilization']:8.3f}")

    print(f"\nspace_time / space_only: "
          f"{tput['space_time'] / tput['space_only']:.2f}x   "
          f"space_time / time_only: "
          f"{tput['space_time'] / tput['time_only']:.2f}x   "
          f"(paper: 3.23x / 7.73x)")

    # the same spec shape scales out: bump the fleet and reroute
    fleet = spec.replace(**{
        "fleet.replicas": 4,
        "router.policy": "least_cost",
        "cost_model.compile_us": 200.0,
    })
    s = fleet.run().summary
    print(f"\nsame spec, 4 replicas behind least_cost routing: "
          f"p95 {s['p95_s']*1e3:.3f}ms, attainment {s['slo_attainment']:.3f}, "
          f"cold-start fraction {s['cold_start_fraction']:.3f}")
    print("\nnext: python -m repro_torch check --spec examples/specs/hetero_fleet.json "
          "--set cost_model.hardware=h100 --set 'fleet.specs=[\"h100\",\"h100_half\"]'")
    print("      python -m repro_torch simulate --spec examples/specs/hetero_fleet.json "
          "--set cost_model.hardware=h100 --set 'fleet.specs=[\"h100\",\"h100_half\"]'")


if __name__ == "__main__":
    main()
