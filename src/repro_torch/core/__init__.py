"""DTO-EE control plane of the port: topology, M/D/1-PS queueing, penalty,
Omega/Delta gradients, DTO-R / DTO-O / DTO-EE (Algorithms 1-3), the
baselines (CF, BF, NGTO, GA) and the discrete-event simulator that
measures them.

The pure-numpy modules (the event simulator among them) are copies of
``repro.core``'s; the ``jnp`` ones (the baselines' strategies among them)
run on float32 torch tensors on the CPU.
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
