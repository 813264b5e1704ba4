"""Multi-tenant weight store: stacked weight trees.

R tenants of the same architecture (different weights) are stored STACKED
along a leading tenant axis, so one merged program serves all tenants:
every projection becomes a batched product across tenants. A tenant's own
weights are views into the stack (``tenant_view``), never a second copy.
"""

from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


def stack_params(params_list: List[Params]) -> Params:
    """Stack R tenants' trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def tenant_view(stacked: Params, t: int) -> Params:
    """Tenant ``t``'s params as views into the stacked tree (no copy)."""
    return tree_map(lambda x: x[t], stacked)


def tenant_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
