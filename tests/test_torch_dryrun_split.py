"""The decode step's collective traffic under a mesh against the
reference's compiled program, on one reduced cell: stablelm-1.6b
``.reduced(vocab_size=512)``, ``decode_32k`` cut to B 8 x S 4096, a (2, 2)
("data", "model") mesh with the default ``REPRO_CACHE_SHARD=seq`` cache
layout (the KV cache's sequence over "model").

The reference is lowered and compiled by ``repro.launch.dryrun.build_lowered``
on 4 forced host devices in a subprocess (``AxisType.Auto`` axes: jax's
default explicit axes fail in ``embed``, as the seed's
``tests/test_system.py::test_dryrun_cell_compiles_in_subprocess`` does) and
its HLO priced by ``repro.roofline.hlo.collective_stats``; the port's step
runs on meta tensors under a fake group of 4 (``launch.dryrun.count_step``)
and its records are priced by the same ring model.  The port may move at
most 4x the reference's bytes a device, and no single record may exceed
16 KB: a gathered layer of K or V (4 MB here), a gathered row-parallel
weight or a gathered LM head fails it."""
import dataclasses
import json
import os
import subprocess
import sys

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_RATIO = 4.0
RECORD_MAX_BYTES = 16 * 1024

_REFERENCE = """
import dataclasses, json
import jax
from jax.sharding import AxisType
from repro.configs import SHAPES, get_config
from repro.launch import dryrun
from repro.roofline.hlo import collective_stats
cfg = get_config("stablelm-1.6b").reduced(vocab_size=512)
shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=8, seq_len=4096)
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
st = collective_stats(dryrun.build_lowered(cfg, shape, mesh).compile().as_text(), 4)
print("REF " + json.dumps({"per_device": st.per_device_bytes, "counts": st.counts}))
"""


def _cell():
    return (get_config("stablelm-1.6b").reduced(vocab_size=512),
            dataclasses.replace(SHAPES["decode_32k"], global_batch=8, seq_len=4096))


def test_decode_collectives_within_4x_of_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                          env=env, timeout=600)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("REF ")), None)
    assert line is not None, proc.stdout + proc.stderr[-3000:]
    ref = json.loads(line[4:])

    from torch.distributed.device_mesh import init_device_mesh

    cfg, shape = _cell()
    os.environ.pop("REPRO_CACHE_SHARD", None)
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        mode, _, _ = dryrun.count_step(cfg, shape, mesh)
    port = mode.stats(4)
    biggest = max(nbytes for _, nbytes, _ in mode.records)
    assert 0 < port.per_device_bytes <= MAX_RATIO * ref["per_device"], (port, ref)
    assert biggest <= RECORD_MAX_BYTES, sorted(set(mode.records))[-5:]
    # the distributed flash-decode plan: the scores' max and sum and the
    # outputs all-reduced over the sequence shards, the row-parallel
    # products' partial sums all-reduced
    assert port.counts.get("all-reduce", 0) >= 3 * cfg.num_layers, port.counts
