from repro_torch.serving.batching import (
    ExitPredictor,
    FifoBatcher,
    Request,
    ShapeBucketBatcher,
    SlotRing,
    batch_tokens,
    pack_decode_batch,
    pad_tokens,
    padded_batch_size,
    pow2_floor,
)
from repro_torch.serving.engine import CollaborativeEngine, ServeStats, StagePrograms
from repro_torch.serving.steps import (
    make_decode_step,
    make_prefill_step,
    monolithic_generate,
    select_exit,
)

__all__ = [
    "ExitPredictor", "FifoBatcher", "Request", "ShapeBucketBatcher", "SlotRing",
    "batch_tokens", "pack_decode_batch", "pad_tokens", "padded_batch_size",
    "pow2_floor",
    "CollaborativeEngine", "ServeStats", "StagePrograms",
    "make_decode_step", "make_prefill_step", "monolithic_generate", "select_exit",
]
