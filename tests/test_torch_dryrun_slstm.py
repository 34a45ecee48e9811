"""sLSTM's collective traffic under a mesh against the reference's compiled
program: full-width xlstm-350m at one period a stage (``num_layers =
len(period) * num_stages``: 8 layers, 4 sLSTM blocks), B 4, on a (2, 2)
("data", "model") mesh and, for decode, on (1, 8), where "model" is wider
than xlstm's 4 heads (as pod16x16's 16 is).

The reference is compiled once, in one subprocess on 8 forced host devices,
with every scan unrolled (``jax.lax.scan`` wrapped with ``unroll=True`` there,
and ``repro.models.layers.set_unroll(True)``), so each sLSTM step's
collectives stand in its HLO; ``repro.roofline.hlo.collective_stats`` prices
them.  The port's steps run on meta tensors under a fake group
(``launch.dryrun.count_step``), priced by the same ring model.  Bytes a
device, reference / port / parent (the commit before sLSTM kept its
recurrent weight in place):

  * decode, S 64, (2, 2): 508,144 / 235,856 / 4,413,776 (8.7x);
  * decode, S 64, (1, 8): 973,120 / 961,968 / 8,072,624 (8.3x);
  * prefill, added by each step from S 8 to S 16: 344,232 / 200,896 /
    4,350,144 (12.6x);
  * train, added by each step from S 8 to S 16: 14,019,252 / 4,708,432 /
    38,291,552 (2.7x).

The parent's largest records in decode and prefill were all-gathers of
``r_gates`` (bf16 [4, 256, 1024], 2,097,152 B), one per sLSTM block and step:
DTensor swapped the weight's shard from its columns to its heads inside the
time loop.  The port may move at most 2x the reference's bytes, and no
record of decode or prefill may reach 1 MB (training's FSDP gathers of whole
weights are large by design)."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.roofline import collectives

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_RATIO = 2.0
RECORD_MAX_BYTES = 1 << 20
CELLS = ("2x2:decode:64", "1x8:decode:64", "2x2:prefill:8", "2x2:prefill:16",
         "2x2:train:8", "2x2:train:16")

_REFERENCE = """
import dataclasses, functools, json, sys
import jax
from jax.sharding import AxisType
jax.lax.scan = functools.partial(jax.lax.scan, unroll=True)
from repro.models import layers
layers.set_unroll(True)
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch import dryrun
from repro.roofline.hlo import collective_stats
cfg = get_config("xlstm-350m")
cfg = dataclasses.replace(cfg, num_layers=len(cfg.period) * cfg.num_stages)
out = {}
for cell in sys.argv[1:]:
    mesh_key, mode, S = cell.split(":")
    shape = tuple(int(v) for v in mesh_key.split("x"))
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    text = dryrun.build_lowered(cfg, ShapeSpec(mode, int(S), 4, mode), mesh).compile().as_text()
    out[cell] = collective_stats(text, n).per_device_bytes
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, *CELLS], capture_output=True,
                          text=True, env=env, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("REF ")), None)
    assert line is not None, proc.stdout + proc.stderr[-3000:]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def port():
    """Per cell: (bytes a device, the records)."""
    cfg = get_config("xlstm-350m")
    cfg = dataclasses.replace(cfg, num_layers=len(cfg.period) * cfg.num_stages)
    out = {}
    for cell in CELLS:
        mesh_key, mode, S = cell.split(":")
        shape = tuple(int(v) for v in mesh_key.split("x"))
        with dryrun.fake_world(shape[0] * shape[1]):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            mode_, _, _ = dryrun.count_step(cfg, ShapeSpec(mode, int(S), 4, mode), mesh)
        out[cell] = (mode_.stats(shape[0] * shape[1]).per_device_bytes, mode_.records)
    return out


@pytest.mark.parametrize("cell", ["2x2:decode:64", "1x8:decode:64"])
def test_decode_moves_at_most_twice_the_reference(cell, reference, port):
    nbytes, records = port[cell]
    assert 0 < nbytes <= MAX_RATIO * reference[cell], (nbytes, reference[cell])
    assert max(n for _, n, _ in records) < RECORD_MAX_BYTES, sorted(set(records))[-3:]


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_each_step_adds_at_most_twice_the_reference(mode, reference, port):
    short, long_ = f"2x2:{mode}:8", f"2x2:{mode}:16"
    ref_step = (reference[long_] - reference[short]) / 8
    port_step = (port[long_][0] - port[short][0]) / 8
    assert 0 < port_step <= MAX_RATIO * ref_step, (port_step, ref_step)
    if mode == "prefill":
        for cell in (short, long_):
            records = port[cell][1]
            assert max(n for _, n, _ in records) < RECORD_MAX_BYTES, sorted(set(records))[-3:]


def _swap(recorder):
    """One DTensor swap on a fake group of 4, (2, 2) mesh: [8, 16, 32] f32
    split over "model" by its last dim, re-split by its first.  Returns the
    recorder's records and the local shard's bytes."""
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty((8, 16, 32), device="meta"), mesh,
                              [Replicate(), Shard(2)], src_data_rank=None)
        with recorder() as rec:
            y = x.redistribute(mesh, [Replicate(), Shard(0)])
        local = y.to_local()
    assert tuple(local.shape) == (4, 16, 32)
    return rec.records, local.numel() * local.element_size()


def _one_all_to_all(records, nbytes):
    assert records == [("all-to-all", nbytes, 2)], records


@pytest.mark.parametrize("recorder", [collectives.CollectiveRecorder, dryrun.CostMode])
def test_a_shard_swap_counts_as_one_all_to_all_of_the_shard(recorder, monkeypatch):
    """The swap is recorded as NCCL runs it, one all-to-all of this device's
    shard (8,192 B), and the CPU fallback's all-gather of the whole tensor
    is not recorded.  Planted fault: without the swap hook (the recording
    before it) the same swap fails the check."""
    _one_all_to_all(*_swap(recorder))
    monkeypatch.setattr(collectives, "_swap_sites", lambda: [])
    records, nbytes = _swap(recorder)
    assert records == [("all-gather", 2 * nbytes, 2)], records
    with pytest.raises(AssertionError):
        _one_all_to_all(records, nbytes)
