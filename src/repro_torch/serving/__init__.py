from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import NO_FAULTS, FaultInjector
from repro_torch.serving.lifecycle import (
    LifecycleError,
    Request,
    RequestRecord,
    RequestState,
    TERMINAL_STATES,
    validate_request,
)

__all__ = [
    "ServingEngine", "FaultInjector", "NO_FAULTS", "LifecycleError",
    "Request", "RequestRecord", "RequestState", "TERMINAL_STATES",
    "validate_request",
]
