"""Fleet routing walkthrough — the JSQ-vs-affinity trade-off, end to end;
the port of ``examples/fleet_routing.py``.

Four replicas of the REAL scheduler (each on its own virtual clock, each
with its own cold compile cache) serve one bursty Zipf-weighted tenant
stream under every routing policy — all described by ONE ``SystemSpec``
with the router swapped per cell, and finished with the committed
heterogeneous/elastic spec (``examples/specs/hetero_fleet.json``) on the
port's cards (``HARDWARE``, ``FLEET_SPECS``: a whole H100 and half of
one). No device work, deterministic per seed, seconds on CPU.

The point this example makes: load balancing and cache affinity pull in
opposite directions. `jsq` equalizes queues but sprays every tenant's
shapes across all four compile caches; `affinity` pins tenants (few
compiles, warm caches) but lets hot tenants pile up on their pinned
replica; `least_cost` prices both effects — backlog seconds AND the
compile a cold replica would pay — and typically wins tail latency while
merging more aggressively (watch its routing imbalance: concentration is
deliberate, not drift).

Equivalent CLI:

    PYTHONPATH=src python -m repro_torch sweep --spec examples/specs/hetero_fleet.json \\
        --set cost_model.hardware=h100 --set 'fleet.specs=["h100","h100_half"]' \\
        --axis router.policy=round_robin,jsq,least_cost,affinity

    PYTHONPATH=src python -m repro_torch.examples.fleet_routing
"""

from pathlib import Path

from repro_torch.api import CostModelSpec, FleetRun, SchedulerSpec, SystemSpec, WorkloadSpec
from repro_torch.sim import ROUTERS

EVENTS = 20_000
REPLICAS = 4
SEED = 0
HARDWARE = "h100"
FLEET_SPECS = ["h100", "h100_half"]  # the hetero spec's cards, in the file's order

HETERO_SPEC = str(Path(__file__).resolve().parents[3] / "examples" / "specs"
                  / "hetero_fleet.json")


def main() -> None:
    # Zipf arrival shares (mix="fleet"): a few hot tenants dominate
    base = SystemSpec(
        workload=WorkloadSpec(mix="fleet", tenants=12, process="mmpp",
                              events=EVENTS, seed=SEED, rho=0.85),
        scheduler=SchedulerSpec(batching_window_s=0.0005,
                                max_superkernel_size=32),
        cost_model=CostModelSpec(hardware=HARDWARE),
    )
    base = base.replace(**{"fleet.replicas": REPLICAS,
                           "cost_model.compile_us": 200.0})

    print(f"=== {REPLICAS} replicas, bursty MMPP @ rho=0.85, "
          f"{EVENTS} events, compile cold-start 200us ===")
    print(f"{'router':12s} {'p95 ms':>8s} {'attain':>7s} {'goodput':>10s} "
          f"{'imbal':>6s} {'util':>6s} {'cold%':>6s} {'cold 1st->2nd half':>19s}")
    for router in ROUTERS:
        m = FleetRun(base.replace(**{"router.policy": router})).run_metrics()
        s = m.summary()
        first, second = m.cold_fraction_halves()
        print(f"{router:12s} {s['p95_s']*1e3:8.3f} {s['slo_attainment']:7.3f} "
              f"{s['goodput_cost_per_s']:10.4g} {s['routing_imbalance']:6.3f} "
              f"{s['utilization']:6.3f} {s['cold_start_fraction']*100:6.2f} "
              f"{first:9.3f} -> {second:.3f}")

    print("\nround_robin balances counts but is blind to bursts and caches;")
    print("jsq corrects imbalance as it forms; least_cost also sees compile")
    print("costs and merge opportunities; affinity minimizes cold starts at")
    print("the price of hot-replica tails. Per-replica detail: "
          "FleetMetrics.per_replica / .routed_counts.")

    # ---- heterogeneous + elastic: the committed spec, as-is and tweaked ----
    hetero = SystemSpec.load(HETERO_SPEC, {"cost_model.hardware": HARDWARE,
                                           "fleet.specs": list(FLEET_SPECS)}).replace(**{
        "workload.events": EVENTS})
    print(f"\n=== mixed {' + '.join(FLEET_SPECS)} fleet ({HETERO_SPEC}) ===")
    print(f"{'cell':22s} {'p95 ms':>8s} {'goodput':>10s} {'replicas':>9s}")
    for name, overrides in (
        ("hetero round_robin", {"fleet.replicas": REPLICAS,
                                "fleet.autoscale": None,
                                "router.policy": "round_robin"}),
        ("hetero least_cost", {"fleet.replicas": REPLICAS,
                               "fleet.autoscale": None,
                               "router.policy": "least_cost"}),
        ("elastic least_cost", {}),  # the committed spec: grown from 1
    ):
        m = hetero.replace(**overrides).build().run_metrics()
        s = m.summary()
        repl = f"{m.initial_replicas}->{m.final_active}" if m.scale_events \
            else str(m.final_active)
        print(f"{name:22s} {s['p95_s']*1e3:8.3f} "
              f"{s['goodput_cost_per_s']:10.4g} {repl:>9s}")
    print("\nspeed-aware least_cost routes around the slow chips that blind")
    print("round_robin trips over; the elastic fleet grows on the backlog")
    print("signal, each new replica arriving with a stone-cold compile cache")
    print("(FleetMetrics.scale_events has the full timeline).")


if __name__ == "__main__":
    main()
