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

Decode steps run as ``serving.graphs.StepProgram``s, the counterpart of the
reference's jitted ``_decode_all`` / ``_decode_one``: tokens and lengths go
through static device buffers, and on the card each step (the merged one,
or each tenant's) is captured as a CUDA graph after its first, eager run
and replayed from then on (``graphs.use_graphs``; ``graphs=False`` runs
eagerly on the card). The caches and the stacked weights are captured by
pointer: they are written in place and never rebound.

Prefills, the counterpart of the reference's jitted ``_prefill`` and
``_prefill_cont``, take one of two routes, fixed when the engine is built
(``prefill_route``), never as a fallback:

- the piece route (graphed engines of an architecture ``takes_pieces``
  allows: no sliding-window ring cache, no MoE FFN, whose capacity depends
  on the sequence length): a prompt of S tokens is prefilled as pieces of
  the lengths ``prefill_pieces`` gives, every length from a fixed set
  (``piece_sizes``), each a continuation from a ``start`` on the device
  into one scratch single-sequence cache made at build, whose recurrent
  state is zeroed before a prompt's first piece and which is then copied
  into the request's slot. On the card every (tenant, piece size) is
  captured as a CUDA graph when the engine is built
  (``graphs.PrefillPrograms``), so a prefill replays a few graphs;
  ``pieces=True`` runs the same pieces eagerly (how the card's checks hold
  the graphs against eager bit for bit);
- the whole-prompt route (eager engines, and MoE and ring-cache
  architectures): one eager ``forward_prefill`` per prompt into a fresh
  cache, or fixed-size chunks with ``prefill_chunk``, as the reference's
  engine runs them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import AttentionKind, BlockKind, ModelConfig, ScheduleConfig
from repro_torch.core.scheduler import DynamicSpaceTimeScheduler
from repro_torch.core.tenancy import stack_params, tenant_view
from repro_torch.core.workload import Workload
from repro_torch.models.transformer import Model
from repro_torch.serving import graphs as _graphs
from repro_torch.serving.kv_cache import SlotManager
from repro_torch.serving.request import InferenceRequest, RequestState
from repro_torch.serving.sampling import SamplingParams, sample


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_tenants: int
    slots_per_tenant: int = 4
    cache_len: int = 256
    mode: str = "space_time"        # "space_time" | "time_only"
    # >0: prefill prompts in chunks of this many tokens (the flash kernel
    # takes the chunk's start position at run time; the WKV6 scan and the
    # SSD scan start from the state the previous chunk left). On the
    # whole-prompt route, fixed-size chunks and a shorter last one; on the
    # piece route, floor(S / C) pieces of C, then the rest in powers of two
    # (``prefill_pieces``), and with 0 pieces of powers of two below
    # cache_len. Requires a non-sliding-window architecture (chunked
    # continuation needs linear caches).
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


def piece_sizes(chunk: int, cache_len: int) -> Tuple[int, ...]:
    """The fixed set of prefill piece lengths, longest first: ``chunk``
    (``prefill_chunk``, when 0 < chunk < cache_len, else the largest power
    of two below ``cache_len``), then every power of two below it. At most
    1 + log2(cache_len) sizes: one program per tenant and size."""
    top = chunk if 0 < chunk < cache_len else 1 << max(cache_len - 1, 1).bit_length() - 1
    return (top,) + tuple(1 << i for i in range((top - 1).bit_length() - 1, -1, -1))


def prefill_pieces(S: int, chunk: int, cache_len: int) -> List[int]:
    """The piece lengths of an S-token prompt on the piece route:
    floor(S / top) pieces of the longest size ``top`` (``piece_sizes``),
    then the rest in descending powers of two (its binary digits). They sum
    to S, each lies in ``piece_sizes(chunk, cache_len)``, and there are at
    most floor(S / top) + log2(top) of them; e.g. 742 at cache_len 2048 is
    512, 128, 64, 32, 4, 2."""
    top = piece_sizes(chunk, cache_len)[0]
    rest = S % top
    return [top] * (S // top) + [1 << i for i in range(rest.bit_length() - 1, -1, -1)
                                 if rest >> i & 1]


def takes_pieces(cfg: ModelConfig) -> bool:
    """Whether an architecture may prefill by pieces: no sliding-window
    layer (its ring cache cannot continue: ``attn_prefill_continue``) and
    no MoE FFN (its capacity comes from the sequence length, so pieces
    would route tokens differently from the whole prompt)."""
    ring = any(cfg.attention_kind_at(i) == AttentionKind.SLIDING and cfg.sliding_window > 0
               for i in range(cfg.num_layers))
    return not ring and BlockKind.ATTN_MOE not in cfg.layer_pattern


def prefill_route(cfg: ModelConfig, graphed: bool, pieces: Optional[bool] = None) -> str:
    """"pieces" or "whole", decided when the engine is built: ``pieces``
    where given (True raises for an architecture ``takes_pieces``
    refuses), else "pieces" exactly for a graphed engine of an architecture
    that takes them."""
    if pieces is None:
        return "pieces" if graphed and takes_pieces(cfg) else "whole"
    if pieces and not takes_pieces(cfg):
        raise ValueError(f"{cfg.name}: a sliding-window or MoE architecture prefills whole "
                         "prompts, not pieces")
    return "pieces" if pieces else "whole"


class MultiTenantEngine:
    """Serve R tenants of one model.

    Give either ``tenant_params`` (a list of R per-tenant param trees, stacked
    here; the caller may drop them afterwards) or ``stacked_params`` (one
    tree with a leading tenant axis, e.g. from ``Model.init_stacked``).
    ``graphs`` picks how decode steps run: None by the device (CUDA graphs
    on the card, eager elsewhere), False eager, True graphs (the card only;
    raises elsewhere); see ``serving.graphs``. ``pieces`` picks the prefill
    route (``prefill_route``): None by the rule (pieces for a graphed
    engine of an architecture that takes them), True pieces on either route,
    False whole prompts. On the graph route the piece programs are
    captured here, so the engine's build pays for them and no request does.
    """

    def __init__(
        self,
        model: Model,
        tenant_params: Optional[List[Any]] = None,
        config: Optional[EngineConfig] = None,
        *,
        stacked_params: Optional[Any] = None,
        graphs: Optional[bool] = None,
        pieces: Optional[bool] = None,
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
        graphed = _graphs.use_graphs(self.device, graphs)
        self.programs = _graphs.StepPrograms(self.device, graphed)
        self.prefill_route = prefill_route(model.cfg, graphed, pieces)

        R, B = config.num_tenants, config.slots_per_tenant
        self.caches = model.init_caches(B, config.cache_len, tenants=R)
        self.slots = SlotManager(R, B)
        self.scratch = None  # the piece route's single-sequence cache
        if self.prefill_route == "pieces":
            self._build_pieces()

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
        # flight-recorder shard (repro_torch.obs); whoever attaches it also
        # taps scheduler.on_dispatch -- the engine only records arrivals
        self.recorder = None
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
        if self.recorder is not None:
            self.recorder.record_arrival(
                req.arrival_time, req.tenant_id,
                ("request", len(req.prompt)), True)
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
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)[None, :]
            if self.scratch is None:
                logits, cache = self._run_prefill(tenant_view(self.stacked_params, t), tokens)
            else:
                logits, cache = self._run_pieces(t, tokens), self.scratch
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

    def _build_pieces(self) -> None:
        """The piece route: a ``start`` buffer, the scratch cache and one
        program per (tenant, piece size); on the graph route they are
        captured now, then the scratch cache is zeroed (the warm-ups wrote
        it), so that every engine starts from the same scratch."""
        model, cache_len = self.model, self.cfg.cache_len
        self.start = torch.zeros((), dtype=torch.int64, device=self.device)
        self.scratch = model.init_caches(1, cache_len)
        # every cache but K/V is recurrent state: RWKV-6's and Mamba2's
        self._state = [c for name, layers in self.scratch.items() if name not in ("k", "v")
                       for c in layers]
        params, scratch = self.stacked_params, self.scratch

        def make_step(t):
            params_t = tenant_view(params, t)
            return lambda tokens, start: model.forward_prefill(
                params_t, tokens, cache_len, caches=scratch, start=start)[0]
        prefill = _graphs.PrefillPrograms(
            make_step, self.cfg.num_tenants, piece_sizes(self.cfg.prefill_chunk, cache_len),
            self.start, self.device, self.programs.share)
        self.programs.prefill = prefill
        if self.programs.graphed:
            prefill.capture()
            for layers in self.scratch.values():
                for c in layers:
                    c.zero_()

    def _run_pieces(self, tenant: int, tokens: torch.Tensor) -> torch.Tensor:
        """Tenant ``tenant``'s prompt (1, S) prefilled into the scratch cache
        by pieces, from zeroed recurrent state (K/V need no reset: the
        causal mask at each piece's start hides every slot past its last
        token); returns the last piece's logits."""
        for c in self._state:
            c.zero_()
        pos = 0
        for n in prefill_pieces(tokens.shape[1], self.cfg.prefill_chunk, self.cfg.cache_len):
            logits = self.programs.prefill.run(tenant, tokens[:, pos:pos + n], pos)
            pos += n
        return logits

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

    def decode_program(self, tenant: Optional[int] = None) -> _graphs.StepProgram:
        """The merged decode step (``tenant`` None) or tenant ``tenant``'s
        own, made on first use over the caches and weights as they are."""
        model, params, caches = self.model, self.stacked_params, self.caches
        B = self.cfg.slots_per_tenant
        if tenant is None:
            def merged():
                return lambda tok, lens: model.forward_decode_tenants(params, tok, caches, lens)[0]
            return self.programs.get(None, merged, (self.cfg.num_tenants, B))

        def one():
            # the tenant's weights and caches are views into the stacks
            params_t = tenant_view(params, tenant)
            caches_t = {name: [c[tenant] for c in layers] for name, layers in caches.items()}
            return lambda tok, lens: model.forward_decode(params_t, tok, caches_t, lens)[0]
        return self.programs.get(tenant, one, (B,))

    def _execute_decode_cohort(self, batch: List[Workload]) -> List[torch.Tensor]:
        """space_time executor: ONE merged step for the whole cohort --
        every active tenant in the batch shares the dispatch.

        The decode runs exactly once per engine step even if the scheduler
        splits the cohort's workloads across pump batches (caches must
        advance once); later sub-batches reuse the same step's logits."""
        if self._cohort_step != self.steps:
            self._step_logits = self.decode_program().run(self.last_token, self._lengths())
            self._sync()
            self._cohort_step = self.steps
        return [self._step_logits[wl.payload] for wl in batch]

    def _execute_decode_tenant(self, batch: List[Workload]) -> List[torch.Tensor]:
        """time_only executor: a per-tenant program with a device sync per
        dispatch (the CUDA context-switch analogue). The tenant's caches
        are views into the stacked caches and update in place."""
        outs = []
        for wl in batch:
            t = wl.payload
            lg = self.decode_program(t).run(self.last_token[t], self.slots.lengths(t))
            self._sync()
            if self._step_logits is None:
                R, B = self.cfg.num_tenants, self.cfg.slots_per_tenant
                self._step_logits = torch.zeros((R, B, lg.shape[-1]), dtype=lg.dtype,
                                                device=self.device)
            self._step_logits[t] = lg
            outs.append(self._step_logits[t])
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
