"""The port's dry run and whole-program roofline against the reference:
``SHAPES`` / ``shape_applicable`` / ``input_specs`` / ``abstract_params``
equal, the collective pricing equals the HLO parser's on the records of
``tests/test_sharding_roofline.py``'s ``FAKE_HLO``, ``RooflineReport``,
``model_flops_for`` and ``slstm_missing_cost`` equal on the same inputs, and
the fake-group gates of reduced stablelm-1.6b run in a subprocess (the
counterpart of ``tests/test_system.py``'s dry-run test).  The counted sLSTM
time steps are held to ``slstm_missing_cost``'s matmul term within 1%."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs
from repro.configs.base import shape_applicable as jshape_applicable
from repro.models import model as jmodel
from repro.roofline import analysis as janalysis
from repro.roofline import corrections as jcorrections
from repro.roofline.hlo import collective_stats as jcollective_stats
from repro_torch.configs import SHAPES, get_config, input_specs, shape_applicable
from repro_torch.models import model
from repro_torch.roofline import analysis, constants, corrections
from repro_torch.roofline.collectives import CollectiveStats, collective_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = list_archs()
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int32: torch.int32}


def _jdtype(d):
    return _DT[jnp.dtype(d).type]


def test_shapes_equal_reference():
    assert list(SHAPES) == list(JSHAPES)
    for name in SHAPES:
        a, b = SHAPES[name], JSHAPES[name]
        assert (a.name, a.seq_len, a.global_batch, a.mode) == (
            b.name, b.seq_len, b.global_batch, b.mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_applicability_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        assert shape_applicable(cfg, SHAPES[name]) == jshape_applicable(jcfg, JSHAPES[name])
        t, j = input_specs(cfg, SHAPES[name]), jinput_specs(jcfg, JSHAPES[name])
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].is_meta
            assert tuple(t[k].shape) == tuple(j[k].shape)
            assert t[k].dtype == _jdtype(j[k].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_reference(arch):
    from torch.utils._pytree import tree_flatten_with_path

    from repro_torch.sharding.specs import _path_str

    jp = jmodel.abstract_params(jget_config(arch))
    tp = model.abstract_params(get_config(arch))
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): leaf
             for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {_path_str(p): leaf for p, leaf in tree_flatten_with_path(tp)[0]}
    assert sorted(jflat) == sorted(tflat)
    for k, leaf in tflat.items():
        assert leaf.is_meta
        assert tuple(leaf.shape) == tuple(jflat[k].shape), k
        assert leaf.dtype == _jdtype(jflat[k].dtype), k


# the records of tests/test_sharding_roofline.py's FAKE_HLO: (op, result
# bytes, group size); the last is a degenerate group of one
FAKE_HLO = """
  %all-reduce.1 = f32[16,1024]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %all-gather.2 = bf16[4,512]{1,0} all-gather(%y), replica_groups=[2,8]<=[16], dimensions={0}
  %reduce-scatter.3 = f32[128]{0} reduce-scatter(%z), replica_groups={{0,1}}, to_apply=%add
  %collective-permute.4 = bf16[64,64]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %all-reduce.5 = f32[8]{0} all-reduce(%v), replica_groups={{0}}, to_apply=%add
"""
FAKE_RECORDS = [
    ("all-reduce", 16 * 1024 * 4, 4),
    ("all-gather", 4 * 512 * 2, 8),
    ("reduce-scatter", 128 * 4, 2),
    ("collective-permute", 64 * 64 * 2, 1),
    ("all-reduce", 8 * 4, 1),
]


@pytest.mark.parametrize("n", [16, 256])
def test_collective_stats_equal_hlo_parser(n):
    got, want = collective_stats(FAKE_RECORDS, n), jcollective_stats(FAKE_HLO, n)
    assert got.counts == want.counts
    assert got.by_op == pytest.approx(want.by_op, rel=1e-12)
    assert got.per_device_bytes == pytest.approx(want.per_device_bytes, rel=1e-12)
    assert got.global_bytes == pytest.approx(want.global_bytes, rel=1e-12)
    assert got.dominant() == want.dominant()


def test_recorder_prices_dtensor_collectives():
    """On a fake 4-rank group: a Shard(0) -> Replicate redistribution is one
    all-gather of the whole [8, 8] f32 (256 bytes, 3/4 of it on the wire),
    a Partial -> Shard(0) one reduce-scatter to [2, 8] (64 bytes, times 3)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.roofline.collectives import CollectiveRecorder

    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        x = DTensor.from_local(torch.ones(2, 8), mesh, [Shard(0)], run_check=False)
        y = DTensor.from_local(torch.ones(8, 8), mesh, [Partial()], run_check=False)
        with CollectiveRecorder() as rec:
            x.redistribute(mesh, [Replicate()])
            y.redistribute(mesh, [Shard(0)])
    assert rec.records == [("all-gather", 256, 4), ("reduce-scatter", 64, 4)]
    st = rec.stats(4)
    assert st.by_op == {"all-gather": 192.0, "reduce-scatter": 192.0}
    assert st.global_bytes == 4 * 384.0


def test_roofline_report_equals_reference():
    kw = dict(arch="a", shape="train_4k", mesh="m", num_devices=256, hlo_flops=1e18,
              hlo_bytes=1e15, model_flops=5e17, compute_s=2.0, memory_s=1.5, collective_s=0.5)
    got = analysis.RooflineReport(collective=collective_stats(FAKE_RECORDS, 256), **kw)
    want = janalysis.RooflineReport(collective=jcollective_stats(FAKE_HLO, 256), **kw)
    assert got.dominant == want.dominant == "compute"
    assert got.bound_s == want.bound_s
    assert got.useful_flops_ratio == pytest.approx(want.useful_flops_ratio)
    # the headline share is against each package's own peak: the H100's here
    assert got.roofline_fraction == pytest.approx(
        want.roofline_fraction * 197e12 / constants.PEAK_FLOPS_BF16)
    g, w = got.row(), want.row()
    assert list(g) == list(w)
    for k in g:
        if k != "roofline_fraction":
            assert g[k] == pytest.approx(w[k]), k


def test_build_report_terms():
    coll = collective_stats(FAKE_RECORDS, 16)
    rep = analysis.build_report(arch="a", shape_name="decode_32k", mesh_name="m",
                                num_devices=16, flops_per_device=1e12, bytes_per_device=1e9,
                                collective=coll, model_flops=8e12)
    assert rep.hlo_flops == 16e12 and rep.hlo_bytes == 16e9
    assert rep.compute_s == pytest.approx(1e12 / constants.PEAK_FLOPS_BF16)
    assert rep.memory_s == pytest.approx(1e9 / constants.HBM_BW)
    assert rep.collective_s == pytest.approx(coll.per_device_bytes / constants.LINK_BW)
    assert isinstance(rep.collective, CollectiveStats)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_slstm_cost_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        assert analysis.model_flops_for(cfg, SHAPES[name]) == pytest.approx(
            janalysis.model_flops_for(jcfg, JSHAPES[name]), rel=1e-12)
        assert corrections.slstm_missing_cost(cfg, SHAPES[name]) == pytest.approx(
            jcorrections.slstm_missing_cost(jcfg, JSHAPES[name]), rel=1e-12)


def test_counted_slstm_steps_equal_the_analytic_matmul_term():
    """The dry run counts every sLSTM time step (a counted scan: one step
    run, its counts added for the rest): the recurrent products' FLOPs over
    the S-1 steps past the first, summed over reduced xlstm-350m's sLSTM
    blocks, equal ``slstm_missing_cost``'s matmul term (B*H*P*4P*2 a step
    and block) within 1%."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.models import ssm

    cfg = get_config("xlstm-350m").reduced()
    B, S = 2, 24
    x = cfg.xlstm
    H, P = x.num_heads, x.s_head_dim
    p = model.abstract_params(cfg)
    n_slstm = cfg.period.count("slstm") * cfg.num_periods

    def bmm_flops(seq):
        blk = next(b for b in p["stages"][0]["blocks"] if "slstm" in b)
        one = {k: v[0] for k, v in blk["slstm"].items() if not isinstance(v, dict)}
        one["norm_h"] = {k: v[0] for k, v in blk["slstm"]["norm_h"].items()}
        one["ffn"] = {k: v[0] for k, v in blk["slstm"]["ffn"].items()}
        mode = CostMode()
        with mode:
            ssm.slstm_forward(one, torch.empty(B, seq, x.d_model, dtype=torch.bfloat16,
                                               device="meta"), x)
        return mode.flops_by_op.get("bmm", 0.0)

    counted = (bmm_flops(S) - bmm_flops(1)) * n_slstm
    extra, _ = corrections.slstm_missing_cost(cfg, ShapeSpec("p", S, B, "prefill"))
    matmul_term = B * H * P * (4 * P) * 2 * (S - 1) * n_slstm
    assert counted == pytest.approx(matmul_term, rel=0.01)
    assert extra == pytest.approx(matmul_term + 24.0 * B * H * P * (S - 1) * n_slstm)


_GATE = """
import json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun
from repro_torch.configs import get_config
dryrun.make_production_mesh = lambda multi_pod=False, device_type="cpu": init_device_mesh(
    "cpu", (2, 2, 4) if multi_pod else (4, 4),
    mesh_dim_names=("pod", "data", "model") if multi_pod else ("data", "model"))
cfg = get_config("stablelm-1.6b").reduced(vocab_size=512)
dryrun.get_config = lambda name: cfg
rows = {}
with dryrun.fake_world(16):
    rows["train_4k"] = dryrun.run_cell("stablelm-1.6b", "train_4k", multi_pod=False, fit=False,
                                       save=False)
    rows["decode_32k"] = dryrun.run_cell("stablelm-1.6b", "decode_32k", multi_pod=True,
                                         fit=False, save=False)
print("ROWS " + json.dumps(rows))
"""


def _expected_arg_bytes(shape_name: str, sizes, names) -> int:
    """Bytes of one device's shards of the cell's arguments, from the specs
    (``local_shard_shape``) alone."""
    from torch.utils._pytree import tree_leaves

    from repro_torch import sharding
    from repro_torch.sharding.specs import AbstractMesh, MeshRules, local_shard_shape
    from repro_torch.training import optimizer as opt_lib

    cfg = get_config("stablelm-1.6b").reduced(vocab_size=512)
    shape = SHAPES[shape_name]
    mesh = AbstractMesh(names, sizes)
    rules = MeshRules.standard(mesh)
    ap = model.abstract_params(cfg)
    trees = []
    if shape.mode == "train":
        trees.append((ap, sharding.param_specs(ap, rules)))
        opt = opt_lib.init_opt_state(ap)
        trees.append((opt, sharding.param_specs(opt, rules)))
    else:
        sp = {k: v for k, v in ap.items()}
        from torch.utils._pytree import tree_map

        sp = tree_map(lambda a: a.to(torch.bfloat16) if a.ndim >= 2 else a, ap)
        trees.append((sp, sharding.param_specs(sp, rules.as_serving())))
        caches = model.cache_specs(cfg, shape.global_batch, shape.seq_len)
        trees.append((caches, sharding.cache_specs(caches, rules)))
        trees.append(([torch.empty(2, device="meta")], [sharding.PartitionSpec()]))
    batch = input_specs(cfg, shape)
    trees.append((batch, sharding.batch_specs(batch, rules)))
    total = 0
    for tree, specs in trees:
        for t, s in zip(tree_leaves(tree), tree_leaves(specs)):
            total += math.prod(local_shard_shape(t.shape, s, mesh.shape)) * t.element_size()
    return total


def test_dryrun_gates_reduced_cells_in_subprocess():
    """Reduced stablelm-1.6b's train_4k on a 16-rank fake (4, 4) mesh and
    decode_32k on (2, 2, 4): the gate runs, tensor parallelism issues
    collectives, and the argument bytes per device are the specs' shards."""
    out = subprocess.run([sys.executable, "-c", _GATE], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=600)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("ROWS ")), None)
    assert line is not None, out.stdout[-2000:] + out.stderr[-4000:]
    rows = json.loads(line[5:])
    for name, (sizes, names) in {"train_4k": ((4, 4), ("data", "model")),
                                 "decode_32k": ((2, 2, 4), ("pod", "data", "model"))}.items():
        row = rows[name]
        assert row["gate"] == "ok", row
        counts = row["gate_collective_counts"]
        assert counts.get("all-gather", 0) > 0 and sum(counts.values()) > 0, counts
        want = _expected_arg_bytes(name, sizes, names)
        assert row["memory"]["argument_size_gb"] * 1e9 == pytest.approx(want, rel=1e-9), name
        assert row["memory"]["peak_gb_per_device"] >= row["memory"]["argument_size_gb"]


def test_dryrun_cli_writes_the_reference_row(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape
    decode_32k`` (a fake group of 256 ranks, full size) writes an artifact
    row with every key of the reference's ``RooflineReport.row()``."""
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "stablelm-1.6b", "--shape", "decode_32k"], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    with open(tmp_path / "stablelm-1.6b__decode_32k__pod16x16.json") as f:
        row = json.load(f)
    coll = jcollective_stats("", 1)
    ref = janalysis.RooflineReport("a", "s", "m", 1, 1.0, 1.0, coll, 1.0, 1.0, 1.0, 1.0).row()
    missing = [k for k in ref if k not in row]
    assert not missing, missing
    assert row["devices"] == 256 and row["gate"] == "ok"
    assert row["hlo_gflops"] > 0 and row["coll_gbytes_global"] > 0
    assert np.isfinite(row["roofline_fraction"])
