"""Multi-tenant model store: stacked weight trees + eviction.

The space-time scheduler's model-level form: R tenants of the same
architecture (different weights -- "These models have different weights
and inputs, as is likely in a multi-tenancy setting") are stored STACKED
along a leading tenant axis, so one merged program serves all tenants:
every projection becomes a batched product across tenants, and every
GEMM of the super-kernel path reads its tenant's slice of the stack. A
tenant's own weights are views into the stack (``tenant_view``), never a
second copy.

Contrast with per-process replication (paper Fig 5): stacked storage holds
exactly R copies of the weights and zero framework duplication.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


def stack_params(params_list: List[Params]) -> Params:
    """Stack R tenants' trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def tenant_view(stacked: Params, t: int) -> Params:
    """Tenant ``t``'s params as views into the stacked tree (no copy)."""
    return tree_map(lambda x: x[t], stacked)


def unstack_params(stacked: Params, r: int) -> List[Params]:
    """The first ``r`` tenants' trees, as views into the stack."""
    return [tenant_view(stacked, i) for i in range(r)]


def tenant_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


@dataclasses.dataclass
class TenantSlot:
    tenant_id: int
    active: bool = True
    evictions: int = 0


class TenantManager:
    """Registry of co-located tenants and their stacked weights."""

    def __init__(self) -> None:
        self._slots: Dict[int, TenantSlot] = {}
        self._params: Dict[int, Params] = {}
        self._stacked: Optional[Params] = None
        self._stack_order: List[int] = []
        self._dirty = True

    # ------------------------------------------------------------- membership
    def register(self, tenant_id: int, params: Params) -> None:
        if tenant_id in self._slots:
            raise ValueError(f"tenant {tenant_id} already registered")
        self._slots[tenant_id] = TenantSlot(tenant_id)
        self._params[tenant_id] = params
        self._dirty = True

    def evict(self, tenant_id: int) -> None:
        """Straggler eviction: drop the tenant from the merged cohort.

        The tenant is marked inactive (its weights stay resident so it can
        be re-admitted to a fresh slot, as the paper's evict-and-restart
        policy does) and the stacked cohort is rebuilt without it.
        """
        slot = self._slots[tenant_id]
        slot.active = False
        slot.evictions += 1
        self._dirty = True

    def readmit(self, tenant_id: int) -> None:
        self._slots[tenant_id].active = True
        self._dirty = True

    @property
    def active_ids(self) -> List[int]:
        return sorted(tid for tid, s in self._slots.items() if s.active)

    # ------------------------------------------------------------- stacking
    def stacked(self) -> Params:
        """Stacked weights of the ACTIVE cohort, rebuilt lazily on change."""
        if self._dirty:
            ids = self.active_ids
            if not ids:
                raise ValueError("no active tenants")
            self._stacked = stack_params([self._params[i] for i in ids])
            self._stack_order = ids
            self._dirty = False
        return self._stacked

    @property
    def stack_order(self) -> List[int]:
        self.stacked()
        return list(self._stack_order)

    def memory_bytes(self) -> int:
        """Total resident weight bytes (registered tenants)."""
        return sum(tenant_bytes(self._params[i]) for i in self._slots)
