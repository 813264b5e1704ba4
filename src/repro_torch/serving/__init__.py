"""Multi-tenant inference serving runtime of the port.

R tenants of one architecture run as ONE merged program over stacked
weights/caches, with a slot-based continuous batcher feeding the decode
loop; prefill and decode cohorts go through the shared
``DynamicSpaceTimeScheduler`` as generic ``Workload`` items.
"""

from repro_torch.serving.engine import EngineConfig, MultiTenantEngine  # noqa: F401
from repro_torch.serving.request import InferenceRequest, RequestState  # noqa: F401
from repro_torch.serving.sampling import SamplingParams, sample  # noqa: F401
