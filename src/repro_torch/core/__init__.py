"""DTO-EE control plane of the port: topology, M/D/1-PS queueing, penalty,
Omega/Delta gradients and DTO-R / DTO-O / DTO-EE (Algorithms 1-3).

The pure-numpy modules are copies of ``repro.core``'s; the ``jnp`` ones run
on float32 torch tensors on the CPU.  Baselines and ``simulate_slot`` are
not ported yet (ROADMAP).
"""
from repro_torch.core.types import (
    BERT_PROFILE,
    DtoHyperParams,
    ModelProfile,
    RESNET101_PROFILE,
    Topology,
)

__all__ = [
    "BERT_PROFILE", "DtoHyperParams", "ModelProfile", "RESNET101_PROFILE", "Topology",
]
