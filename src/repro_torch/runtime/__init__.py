"""Runtime helpers of the port: checkpoints, the int8 gradient codec and
failure / straggler handling (``repro.runtime``'s modules, ported)."""
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.compression import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    init_error,
    quantize_int8,
)
from repro_torch.runtime.elastic import (
    StragglerMonitor,
    elastic_remesh,
    handle_failure,
    renormalize_strategy,
)

__all__ = [
    "CheckpointManager",
    "compress_tree", "decompress_tree", "dequantize_int8", "init_error", "quantize_int8",
    "StragglerMonitor", "elastic_remesh", "handle_failure", "renormalize_strategy",
]
