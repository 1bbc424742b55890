from repro_torch.serving.drafter import NgramDrafter
from repro_torch.serving.engine import ContinuousBatchingEngine, ServingEngine
from repro_torch.serving.faults import (
    NO_FAULTS,
    FaultInjector,
    PoolAuditError,
    PoolAuditor,
    ScriptedFaults,
    SeededFaults,
)
from repro_torch.serving.lifecycle import (
    LifecycleError,
    Request,
    RequestRecord,
    RequestState,
    TERMINAL_STATES,
    validate_request,
)
from repro_torch.serving.paged_cache import (
    SCRATCH_PAGE,
    PageAccountingError,
    PagedKVCacheManager,
    PagePoolExhausted,
    PoolConfigError,
    page_footprint_bytes,
)

__all__ = [
    "ServingEngine", "ContinuousBatchingEngine", "NgramDrafter",
    "FaultInjector",
    "NO_FAULTS", "ScriptedFaults", "SeededFaults", "PoolAuditor",
    "PoolAuditError", "LifecycleError", "Request", "RequestRecord",
    "RequestState", "TERMINAL_STATES", "validate_request", "SCRATCH_PAGE",
    "PagedKVCacheManager", "PagePoolExhausted", "PageAccountingError",
    "PoolConfigError", "page_footprint_bytes",
]
