"""Runtime helpers of the port (copies of ``repro.runtime.elastic``)."""
from repro_torch.runtime.elastic import (
    StragglerMonitor,
    elastic_remesh,
    handle_failure,
    renormalize_strategy,
)

__all__ = ["StragglerMonitor", "elastic_remesh", "handle_failure", "renormalize_strategy"]
