"""Inference request lifecycle + per-request metrics."""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional


class RequestState(str, enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


_ids = itertools.count()


@dataclasses.dataclass
class InferenceRequest:
    tenant_id: int
    prompt: List[int]
    max_new_tokens: int = 16
    slo_s: float = 0.1
    eos_token: Optional[int] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))

    # lifecycle
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)

    # timing
    arrival_time: float = 0.0
    prefill_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def done(self) -> bool:
        if self.eos_token is not None and self.generated and self.generated[-1] == self.eos_token:
            return True
        return len(self.generated) >= self.max_new_tokens

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time
