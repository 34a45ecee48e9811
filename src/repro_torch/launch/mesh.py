"""Production mesh construction: the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and starts no process group.  Both need a process group the caller
started (``torch.distributed.init_process_group``) whose world size is the
mesh's size.

Single pod : (16, 16)    axes ("data", "model")          — 256 devices
Multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   — 512 devices
The "pod" axis is pure data parallelism across the slow boundary between
pods; "data" is in-pod DP/FSDP; "model" is tensor parallelism.  The shapes
are the reference's, so cells and specs line up with it; on H100 nodes of
8 GPUs a 16-wide "model" axis spans two NVLink domains.
"""
from __future__ import annotations

import os


def production_mesh_shape(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``(shape, axis names)`` of the production mesh.  ``REPRO_MESH=DxM``
    reshapes the single-pod (data, model) factorization."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    override = os.environ.get("REPRO_MESH", "")
    if override and not multi_pod:
        d, m = (int(x) for x in override.split("x"))
        shape, axes = (d, m), ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` on ``device_type`` ("cuda" unless the
    caller asks for "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """A 1x1 ("data", "model") mesh on the one device of a world of 1."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))
