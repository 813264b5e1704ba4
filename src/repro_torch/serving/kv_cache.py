"""Slot-based multi-tenant cache management.

Each tenant owns ``num_slots`` sequence slots inside the stacked cache
pytree (leading axes: [tenant, ..., batch=slot, ...]). The manager tracks
slot occupancy and per-slot live lengths; freeing a slot just zeroes its
length (the decode kernels mask by length, so stale data is never read).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class SlotState:
    request_id: Optional[int] = None
    length: int = 0

    @property
    def free(self) -> bool:
        return self.request_id is None


class SlotManager:
    def __init__(self, num_tenants: int, slots_per_tenant: int):
        self.slots: Dict[Tuple[int, int], SlotState] = {
            (t, s): SlotState()
            for t in range(num_tenants)
            for s in range(slots_per_tenant)
        }
        self.num_tenants = num_tenants
        self.slots_per_tenant = slots_per_tenant

    def acquire(self, tenant: int, request_id: int) -> Optional[int]:
        for s in range(self.slots_per_tenant):
            st = self.slots[(tenant, s)]
            if st.free:
                st.request_id = request_id
                st.length = 0
                return s
        return None

    def release(self, tenant: int, slot: int) -> None:
        self.slots[(tenant, slot)] = SlotState()

    def set_length(self, tenant: int, slot: int, length: int) -> None:
        self.slots[(tenant, slot)].length = length

    def lengths(self, tenant: int) -> List[int]:
        return [self.slots[(tenant, s)].length for s in range(self.slots_per_tenant)]

    def active(self, tenant: int) -> List[int]:
        return [
            s for s in range(self.slots_per_tenant) if not self.slots[(tenant, s)].free
        ]

    def utilization(self) -> float:
        busy = sum(0 if s.free else 1 for s in self.slots.values())
        return busy / len(self.slots)
