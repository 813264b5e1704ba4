"""Multi-tenant inference engine: space-time scheduled decode loop.

R tenants of the same architecture (different weights) are served from
ONE set of tenant-stacked weights and caches. In ``space_time`` mode every
tenant's decode cohort runs as one merged step
(``Model.forward_decode_tenants``): each projection is one batched product
across tenants and each layer's attention one decode-kernel launch (an
RWKV-6 layer's recurrence one step) over all R x B sequences -- the
paper's mechanism applied to whole models. A recurrent (RWKV-6) prefill
writes its final state into the request's slot, and a fresh prefill
overwrites whatever state the slot's last request left.

All work flows through the shared ``DynamicSpaceTimeScheduler``: each
admitted prefill and each tenant's decode step is submitted as a generic
``Workload`` (bucket, cost, SLO, execute-callback) and dispatched by the
scheduler's pump, which owns admission control, per-tenant SLO/latency
tracking and straggler eviction.

``mode="time_only"`` is the contrast case: each tenant's decode cohort
gets its OWN bucket, so the scheduler dispatches them one after another
(one program per tenant per step, with a device sync after each, the
analogue of CUDA context time-slicing); a tenant's recorded latency then
includes waiting for every tenant ahead of it.

Same submit/step/run_until_drained/report surface as the JAX package's
engine. Differences: caches are updated in place (per-tenant decode writes
through views into the stacked caches), and the engine keeps only the
stacked weights; a tenant's own weights are views into them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ScheduleConfig
from repro_torch.core.scheduler import DynamicSpaceTimeScheduler
from repro_torch.core.tenancy import stack_params, tenant_view
from repro_torch.core.workload import Workload
from repro_torch.models.transformer import Model
from repro_torch.serving.kv_cache import SlotManager
from repro_torch.serving.request import InferenceRequest, RequestState
from repro_torch.serving.sampling import SamplingParams, sample


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_tenants: int
    slots_per_tenant: int = 4
    cache_len: int = 256
    mode: str = "space_time"        # "space_time" | "time_only"
    # >0: prefill prompts in fixed-size chunks (the flash kernel takes the
    # chunk's start position at run time; the WKV6 scan starts from the
    # state the previous chunk left). Requires a non-sliding-window
    # architecture (chunked continuation needs linear caches).
    prefill_chunk: int = 0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    seed: int = 0
    ewma_alpha: float = 0.2
    eviction_ratio: float = 10.0    # effectively off unless benchmarking isolation
    # optional override for the shared scheduler core; None derives one
    # from the fields above.
    schedule: Optional[ScheduleConfig] = None

    def __post_init__(self) -> None:
        if self.mode not in ("space_time", "time_only"):
            raise ValueError(f"mode must be 'space_time' or 'time_only', got {self.mode!r}")


class MultiTenantEngine:
    """Serve R tenants of one model.

    Give either ``tenant_params`` (a list of R per-tenant param trees, stacked
    here; the caller may drop them afterwards) or ``stacked_params`` (one
    tree with a leading tenant axis, e.g. from ``Model.init_stacked``).
    """

    def __init__(
        self,
        model: Model,
        tenant_params: Optional[List[Any]] = None,
        config: Optional[EngineConfig] = None,
        *,
        stacked_params: Optional[Any] = None,
    ):
        if config is None:
            raise ValueError("MultiTenantEngine needs an EngineConfig")
        if (tenant_params is None) == (stacked_params is None):
            raise ValueError("give exactly one of tenant_params and stacked_params")
        if tenant_params is not None:
            if len(tenant_params) != config.num_tenants:
                raise ValueError(
                    f"{len(tenant_params)} tenant param trees for num_tenants={config.num_tenants}")
            stacked_params = stack_params(tenant_params)
        elif stacked_params["embed"].shape[0] != config.num_tenants:
            raise ValueError("stacked_params' leading axis must equal num_tenants")
        self.model = model
        self.cfg = config
        self.device = model.device
        self.stacked_params = stacked_params

        R, B = config.num_tenants, config.slots_per_tenant
        self.caches = model.init_caches(B, config.cache_len, tenants=R)
        self.slots = SlotManager(R, B)

        schedule = config.schedule or ScheduleConfig(
            batching_window_s=0.0,
            max_superkernel_size=max(128, config.num_tenants),
            latency_ewma_alpha=config.ewma_alpha,
            straggler_eviction_ratio=config.eviction_ratio,
        )
        self.scheduler = DynamicSpaceTimeScheduler(schedule)

        self.queue: List[InferenceRequest] = []
        self.active: Dict[tuple, InferenceRequest] = {}  # (tenant, slot) -> req
        self.finished: List[InferenceRequest] = []
        self.last_token = np.zeros((R, B), np.int64)
        self.steps = 0
        self.decode_tokens = 0
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(config.seed)
        self._step_logits: Optional[torch.Tensor] = None  # (R, B, V)
        self._cohort_step = -1                            # last step decoded merged

    # ---------------------------------------------------------------- monitor
    @property
    def monitor(self):
        """Per-tenant latency/SLO tracking lives in the shared core."""
        return self.scheduler.monitor

    def _sync(self) -> None:
        """Wait for the card (the JAX engine's block_until_ready)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ intake
    def submit(self, req: InferenceRequest, now: Optional[float] = None) -> None:
        req.arrival_time = now if now is not None else time.perf_counter()
        req.state = RequestState.QUEUED
        self.queue.append(req)

    # ------------------------------------------------------------------ prefill
    def _admit(self) -> None:
        # Each admitted prefill is a Workload bucketed by prompt length so
        # the scheduler accounts its latency per tenant.
        remaining = []
        submitted = False
        for req in self.queue:
            slot = self.slots.acquire(req.tenant_id, req.request_id)
            if slot is None:
                remaining.append(req)
                continue
            req.slot = slot
            req.state = RequestState.PREFILLING
            ok = self.scheduler.submit(Workload(
                tenant_id=req.tenant_id,
                bucket=("prefill", len(req.prompt)),
                cost=float(len(req.prompt)),
                slo_s=req.slo_s,
                execute=self._execute_prefill_batch,
                payload=req,
                kind="prefill",
            ))
            if not ok:
                # admission control pushed back: return the slot, retry later
                self.slots.release(req.tenant_id, slot)
                req.slot = None
                req.state = RequestState.QUEUED
                remaining.append(req)
                continue
            submitted = True
        self.queue = remaining
        if submitted:
            self.scheduler.flush()

    def _execute_prefill_batch(self, batch: List[Workload]) -> List[int]:
        """Scheduler executor: prefill each admitted request, install its
        cache into the stacked cohort, and activate its decode slot."""
        outs = []
        for wl in batch:
            req: InferenceRequest = wl.payload
            t, s = req.tenant_id, req.slot
            params_t = tenant_view(self.stacked_params, t)
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)[None, :]
            logits, cache = self._run_prefill(params_t, tokens)
            tok = int(torch.argmax(logits[0]))
            req.generated.append(tok)
            req.first_token_time = time.perf_counter()
            req.prefill_time = req.first_token_time
            for name, layers in cache.items():  # every cache the model keeps
                for big, small in zip(self.caches[name], layers):
                    big[t, s].copy_(small[0])
            self.slots.set_length(t, s, tokens.shape[1])
            self.last_token[t, s] = tok
            req.state = RequestState.DECODING
            self.active[(t, s)] = req
            outs.append(tok)
        return outs

    def _run_prefill(self, params_t, tokens):
        """Whole-prompt or chunked prefill."""
        C = self.cfg.prefill_chunk
        S = tokens.shape[1]
        model, cache_len = self.model, self.cfg.cache_len
        if C <= 0 or S <= C:
            return model.forward_prefill(params_t, tokens, cache_len)
        logits, cache = model.forward_prefill(params_t, tokens[:, :C], cache_len)
        pos = C
        while pos < S:
            n = min(C, S - pos)
            logits, cache = model.forward_prefill(
                params_t, tokens[:, pos:pos + n], cache_len, caches=cache, start=pos)
            pos += n
        return logits, cache

    # ------------------------------------------------------------------ decode
    def _lengths(self) -> np.ndarray:
        R, B = self.cfg.num_tenants, self.cfg.slots_per_tenant
        out = np.zeros((R, B), np.int64)
        for t in range(R):
            out[t] = self.slots.lengths(t)
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _execute_decode_cohort(self, batch: List[Workload]) -> List[torch.Tensor]:
        """space_time executor: ONE merged step for the whole cohort --
        every active tenant in the batch shares the dispatch.

        The decode runs exactly once per engine step even if the scheduler
        splits the cohort's workloads across pump batches (caches must
        advance once); later sub-batches reuse the same step's logits."""
        if self._cohort_step != self.steps:
            logits, _ = self.model.forward_decode_tenants(
                self.stacked_params, self._to_device(self.last_token), self.caches,
                self._to_device(self._lengths()))
            self._sync()
            self._step_logits = logits
            self._cohort_step = self.steps
        return [self._step_logits[wl.payload] for wl in batch]

    def _execute_decode_tenant(self, batch: List[Workload]) -> List[torch.Tensor]:
        """time_only executor: a per-tenant program with a device sync per
        dispatch (the CUDA context-switch analogue). The tenant's caches
        are views into the stacked caches and update in place."""
        outs = []
        for wl in batch:
            t = wl.payload
            caches_t = {name: [c[t] for c in layers] for name, layers in self.caches.items()}
            lg, _ = self.model.forward_decode(
                tenant_view(self.stacked_params, t), self._to_device(self.last_token[t]),
                caches_t, self._to_device(np.asarray(self.slots.lengths(t), np.int64)))
            self._sync()
            if self._step_logits is None:
                R, B = self.cfg.num_tenants, self.cfg.slots_per_tenant
                self._step_logits = torch.zeros((R, B, lg.shape[-1]), dtype=lg.dtype,
                                                device=self.device)
            self._step_logits[t] = lg
            outs.append(lg)
        return outs

    def step(self) -> int:
        """One engine iteration: admit + one decode step. Returns #tokens.

        The decode cohort is submitted to the shared scheduler as one
        Workload per active tenant. In space_time mode they share one
        bucket (one merged dispatch); in time_only mode each tenant gets
        its own bucket and the scheduler dispatches them one by one.
        """
        self._admit()
        if not self.active:
            return 0

        slo_by_tenant: Dict[int, float] = {}
        slots_by_tenant: Dict[int, int] = {}
        for (t, _), req in self.active.items():
            slo_by_tenant[t] = min(slo_by_tenant.get(t, float("inf")), req.slo_s)
            slots_by_tenant[t] = slots_by_tenant.get(t, 0) + 1
        merged = self.cfg.mode == "space_time"
        for t in sorted(slots_by_tenant):
            ok = self.scheduler.submit(Workload(
                tenant_id=t,
                bucket=("decode", "cohort") if merged else ("decode", t),
                cost=float(slots_by_tenant[t]),
                slo_s=slo_by_tenant[t],
                execute=(self._execute_decode_cohort if merged
                         else self._execute_decode_tenant),
                payload=t,
                kind="decode",
            ))
            if not ok:
                # a dropped decode workload would silently desync caches
                raise RuntimeError(
                    "decode workload rejected by scheduler admission control; "
                    "max_pending_per_tenant must admit one decode workload "
                    "per tenant per step"
                )
        self.scheduler.flush()

        next_tokens = sample(self._step_logits, self.cfg.sampling, self._sample_gen).cpu().numpy()
        produced = 0
        now = time.perf_counter()
        for (t, s), req in list(self.active.items()):
            tok = int(next_tokens[t, s])
            req.generated.append(tok)
            produced += 1
            self.slots.set_length(t, s, self.slots.slots[(t, s)].length + 1)
            self.last_token[t, s] = tok
            if req.done:
                req.finish_time = now
                req.state = RequestState.FINISHED
                self.finished.append(req)
                self.slots.release(t, s)
                del self.active[(t, s)]
        self.steps += 1
        self.decode_tokens += produced
        return produced

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            self.step()
            if not self.queue and not self.active:
                return
        raise RuntimeError("engine did not drain")

    # ------------------------------------------------------------------ metrics
    def report(self) -> Dict[str, float]:
        rep = {
            "steps": float(self.steps),
            "decode_tokens": float(self.decode_tokens),
            "finished": float(len(self.finished)),
            "slot_utilization": self.slots.utilization(),
            "scheduler_dispatches": float(self.scheduler.stats.dispatches),
        }
        rep.update(self.monitor.summary())
        # decode-step semantics for the headline percentiles: prefill
        # dispatches are tracked too but reported apart
        rep.update(self.monitor.summary_for("decode"))
        rep.update({f"prefill_{k}": v
                    for k, v in self.monitor.summary_for("prefill").items()})
        lats = [r.latency_s for r in self.finished if r.latency_s is not None]
        if lats:
            rep["req_mean_latency_s"] = float(np.mean(lats))
            rep["req_p95_latency_s"] = float(np.percentile(lats, 95))
        return rep
