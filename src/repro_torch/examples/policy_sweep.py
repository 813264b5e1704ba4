"""Policy sweep on the trace-driven simulator — no device work, seconds
on CPU, deterministic per seed; the port of ``examples/policy_sweep.py``.

Demonstrates the declarative ``repro_torch.api`` workflow end-to-end: ONE
base ``SystemSpec`` per tenant mix, ``replace()``d across arrival processes
(steady Poisson, bursty MMPP, diurnal, flash crowd) and batching
policies, every cell replayed through the REAL DynamicSpaceTimeScheduler
on a virtual clock and priced by the roofline cost model of the port's
card (``HARDWARE``).

The point the sweep makes: neither window policy dominates. On the
serving mix (tight decode SLOs against a wide window) the adaptive
window buys large attainment gains; on the kernel mix under saturating
bursts it can LOSE throughput by giving up merging exactly when merging
matters most. Latency predictability is a policy property — which is why
these sweeps run in simulation, where the whole surface costs seconds.

Equivalent CLI for one row of this grid:

    PYTHONPATH=src python -m repro_torch sweep --spec examples/specs/paper_mix.json \\
        --set cost_model.hardware=h100 \\
        --axis workload.process=poisson,mmpp,diurnal,flash \\
        --axis scheduler.batching_policy=fixed,slo_adaptive

    PYTHONPATH=src python -m repro_torch.examples.policy_sweep
"""

from repro_torch.api import CostModelSpec, SchedulerSpec, SystemSpec, WorkloadSpec, build_mix

EVENTS = 30_000
SEED = 0
HARDWARE = "h100"


def sweep(mix_name: str, tenants: int, rho: float) -> None:
    # offered load anchored to the mix's merged-roofline capacity (the
    # spec's rho semantics), so one rho means the same pressure for
    # FLOP-priced GEMMs and byte-priced decode cohorts alike
    base = SystemSpec(
        workload=WorkloadSpec(mix=mix_name, tenants=tenants, events=EVENTS,
                              seed=SEED, rho=rho),
        scheduler=SchedulerSpec(max_superkernel_size=64),
        cost_model=CostModelSpec(hardware=HARDWARE),
    )
    mix = build_mix(base.workload)
    # a window wide enough to threaten the tightest SLO tier, so the
    # adaptive policy has a violation budget to win back
    base = base.replace(**{
        "scheduler.batching_window_s": 0.5 * min(s.slo_s for s in mix)})
    print(f"\n=== mix={mix_name} @ rho={rho:.2f}, {EVENTS} events/cell ===")
    print(f"{'process':>9s} {'policy':>13s} {'p50 ms':>8s} {'p95 ms':>8s} "
          f"{'attain':>7s} {'goodput':>10s}")
    for process in ("poisson", "mmpp", "diurnal", "flash"):
        for policy in ("fixed", "slo_adaptive"):
            m = base.replace(**{
                "workload.process": process,
                "scheduler.batching_policy": policy,
            }).build().run_metrics()
            s = m.summary()
            print(f"{process:>9s} {policy:>13s} {s['p50_s']*1e3:8.3f} "
                  f"{s['p95_s']*1e3:8.3f} {s['slo_attainment']:7.3f} "
                  f"{s['goodput_cost_per_s']:10.3g}")


def main() -> None:
    # kernel-level tenants: steady load leaves slack, only bursts bite
    sweep("sgemm", tenants=8, rho=0.6)
    # engine-shaped cohorts: decode steps dominate arrivals, prefills are
    # rare and heavy — the realistic serving mix
    sweep("serving", tenants=4, rho=0.6)


if __name__ == "__main__":
    main()
