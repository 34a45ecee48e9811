"""Multi-pod dry run: run every (arch x shape x mesh) cell's step once on
meta tensors laid out over a mesh of a "fake" process group.  The
counterpart of ``repro.launch.dryrun``.

``python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape decode_32k``
starts a "fake" process group of 256 ranks (512 with ``--multi-pod``) in its
own process (the group is process-global), builds the production mesh over
it and runs the cell.  Given several cells (``--arch all``, ``--shape all``,
``--both-meshes``, or comma-separated lists) it runs each in a process of
its own, ``--jobs`` at a time, each under ``--limit`` seconds, and prints a
table of them.  Per cell:

  GATE — the full-depth step runs once: parameters, optimizer state,
    caches and batch are meta DTensors laid out by ``repro_torch.sharding``'s
    specs, every op propagates its sharding (DTensor), every collective
    the layout needs is issued (the fake group moves nothing) and every
    local op runs on meta shards of this rank's shape.  Success shows the
    layout is coherent; the argument bytes and the peak of live bytes per
    device show whether it fits.
  MEASURE — the same run, counted.  Eager execution runs every loop
    iteration (the periods, the attention chunks, sLSTM's time steps), so
    the counts are exact at full depth and the reference's two-point depth
    fit (and its ``set_unroll``) has no counterpart.  Per device:
      * FLOPs: ``torch.utils.flop_counter``'s per-op formulas (the ones
        ``FlopCounterMode`` applies) over the LOCAL ops;
      * bytes: operand + result bytes of every local aten op that is not a
        view — eager, unfused traffic, above what a fused program moves
        (XLA's "bytes accessed" in the reference);
      * collectives: ``roofline.collectives.CollectiveRecorder``'s records.

Both come from one dispatch mode (``CostMode``) under DTensor: it defers
every DTensor op to DTensor (``NotImplemented``) and counts the local ops
DTensor then runs, skipping the fake tensors of DTensor's shape
propagation.  Live bytes are tracked by that mode too: every storage an op
creates (and every argument's) is counted from its creation until its last
reference dies (a weakref callback), and the peak is the maximum of their sum.

The kernel wrappers run their plain versions on meta tensors, so the counts
are those of the plain attention and exit head, not of the kernels.  On a
CPU mesh DTensor swaps a shard from one dim to another by all-gather and
slice where NCCL would use all-to-all.  Artifacts go to
``experiments/dryrun_torch/<cell>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import weakref

import torch
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import sharding
from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.configs.base import ShapeSpec, shape_applicable
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.models import model as model_lib
from repro_torch.roofline import analysis
from repro_torch.roofline.collectives import CollectiveRecorder, c10d_record
from repro_torch.serving.steps import make_decode_step, make_prefill_step
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training import optimizer as opt_lib

# REPRO_DRYRUN_DIR moves the artifacts elsewhere (the tests' temporary dirs)
ARTIFACT_DIR = os.environ.get("REPRO_DRYRUN_DIR") or os.path.normpath(
    os.path.join(os.path.dirname(__file__), "../../../experiments/dryrun_torch")
)

# functional-collective ops whose result is their input (on a device)
_ALIASING = {"wait_tensor", "_wrap_tensor_autograd"}
# ops that allocate without writing, or only read metadata
_NO_TRAFFIC = {
    torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
    torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided, torch.ops.aten.is_same_size,
    torch.ops.aten._local_scalar_dense,
}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CostMode(CollectiveRecorder):
    """Counts the local ops a (DTensor) program runs: FLOPs, bytes,
    collectives, and the live and peak bytes of storages (see the module
    docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_op: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it dies (once per storage)."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops, counted below
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(o, FakeTensor) for o in outs):
            return out  # DTensor's shape propagation, not the program
        rec = c10d_record(func, args, out)
        if rec is not None:
            self.records.append(rec)
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                f = float(flop_registry[packet](*args, **kwargs, out_val=out))
                self.flops += f
                name = str(packet).split(".")[-1]
                self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
            if packet not in _NO_TRAFFIC and not _is_view(func):
                self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
                self.bytes += sum(_nbytes(o) for o in outs)
        if func._opname not in _ALIASING:
            for o in outs:
                self.track(o)
        return out


def _serving_params(aparams):
    """Serving checkpoints hold bf16 matrix weights (norm vectors stay f32)."""
    return tree_map(lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 and a.ndim >= 2
                    else a, aparams)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t._local_tensor if isinstance(t, DTensor) else t) for t in _tensors(tree))


def build_step(cfg, shape: ShapeSpec, mesh, microbatches: int = 1, policy: str = "dp_tp"):
    """The cell's step and its arguments laid out over ``mesh`` (meta
    DTensors): returns ``(run, args)``, ``run()`` taking one step.  The
    counterpart of the reference's ``build_lowered``."""
    rules = sharding.set_mesh(mesh, policy)
    aparams = model_lib.abstract_params(cfg)
    serving_layout = shape.mode in ("prefill", "decode") and os.environ.get(
        "REPRO_SERVE_LAYOUT", "replicated") == "replicated"
    if serving_layout:
        # inference: bf16 weights, TP-only sharding (no per-step FSDP gathers)
        aparams = _serving_params(aparams)
        pspecs = sharding.param_specs(aparams, rules.as_serving())
    else:
        pspecs = sharding.param_specs(aparams)
    params = sharding.distribute_tree(aparams, pspecs, mesh)
    abatch = input_specs(cfg, shape)
    batch = sharding.distribute_tree(abatch, sharding.batch_specs(abatch), mesh)
    thresholds = torch.empty((len(cfg.exit_stages),), dtype=torch.float32, device="meta")

    if shape.mode == "train":
        aopt = opt_lib.init_opt_state(aparams)
        opt = sharding.distribute_tree(aopt, sharding.param_specs(aopt), mesh)
        step_fn = make_train_step(cfg, AdamWConfig(), microbatches=microbatches)
        args = (params, opt, batch)
    elif shape.mode == "prefill":
        step_fn = make_prefill_step(cfg, max_len=shape.seq_len)
        args = (params, batch, thresholds)
    else:
        acaches = model_lib.cache_specs(cfg, shape.global_batch, shape.seq_len)
        caches = sharding.distribute_tree(acaches, sharding.cache_specs(acaches), mesh)
        step_fn = make_decode_step(cfg)
        args = (params, batch, caches, thresholds)
    return (lambda: step_fn(*args)), args


def count_step(cfg, shape: ShapeSpec, mesh, microbatches: int = 1,
               policy: str = "dp_tp") -> tuple[CostMode, int, float]:
    """Run the cell's step once under ``CostMode``: ``(counts, argument
    bytes per device, seconds)``."""
    t0 = time.time()
    run, args = build_step(cfg, shape, mesh, microbatches, policy)
    mode = CostMode()
    for t in _tensors(args):
        mode.track(t)
    arg_bytes = _local_bytes(args)
    with mode:
        run()
    return mode, arg_bytes, time.time() - t0


def _num_devices(mesh) -> int:
    return math.prod(mesh.shape)


def _gate_row(mode: CostMode, arg_bytes: int, seconds: float, num_devices: int) -> dict:
    return {
        "gate": "ok",
        "run_s": round(seconds, 1),
        "memory": {
            "argument_size_gb": arg_bytes / 1e9,
            "temp_size_gb": (mode.peak - arg_bytes) / 1e9,
            "peak_gb_per_device": mode.peak / 1e9,
        },
        "gate_collective_counts": mode.stats(num_devices).counts,
        "gate_flops_per_device": mode.flops,
    }


def _measure_row(cfg, shape: ShapeSpec, arch: str, mesh_name: str, mode: CostMode,
                 num_devices: int) -> dict:
    coll = mode.stats(num_devices)
    report = analysis.build_report(
        arch=arch,
        shape_name=shape.name,
        mesh_name=mesh_name,
        num_devices=num_devices,
        flops_per_device=mode.flops,
        bytes_per_device=mode.bytes,
        collective=coll,
        model_flops=analysis.model_flops_for(cfg, shape),
    )
    row = report.row()
    row["collective_by_op_gb"] = {k: v * num_devices / 1e9 for k, v in coll.by_op.items()}
    row["collective_counts"] = coll.counts
    # sLSTM's time steps are counted, not corrected (roofline.corrections)
    row["slstm_correction_gflops"] = 0.0
    return row


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _mesh(multi_pod: bool):
    """The production mesh over the running (fake) process group."""
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def gate_cell(arch: str, shape_name: str, multi_pod: bool, microbatches: int = 1,
              policy: str = "dp_tp", cfg=None, shape: ShapeSpec | None = None) -> dict:
    """The full-depth step once on meta: the runnability gate.  ``cfg`` and
    ``shape`` stand in for the registry's config and ``SHAPES[shape_name]``."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = _mesh(multi_pod)
    mode, arg_bytes, seconds = count_step(cfg, shape, mesh, microbatches, policy)
    return _gate_row(mode, arg_bytes, seconds, _num_devices(mesh))


def measure_cell(arch: str, shape_name: str, multi_pod: bool, policy: str = "dp_tp") -> dict:
    """Exact roofline terms at production depth (one counted run)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = _mesh(multi_pod)
    mode, _, _ = count_step(cfg, shape, mesh, policy=policy)
    return _measure_row(cfg, shape, arch, _mesh_name(multi_pod), mode, _num_devices(mesh))


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    fit: bool = True,
    gate: bool = True,
    microbatches: int = 1,
    save: bool = True,
    policy: str = "dp_tp",
    tag: str = "",
) -> dict:
    """Gate and/or measure one cell (one counted run serves both) and write
    its artifact.  Needs a process group of the mesh's size (``fake_world``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    cell = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"cell": cell, "skipped": reason}
    row = {"cell": cell, "arch": arch, "shape": shape_name, "mesh": mesh_name}
    path = os.path.join(ARTIFACT_DIR, cell + ".json")
    if os.path.exists(path):  # merge into an existing artifact (re-gate etc.)
        try:
            with open(path) as f:
                row = {**json.load(f), **row}
        except (OSError, json.JSONDecodeError):
            pass
    if gate or fit:
        mesh = _mesh(multi_pod)
        mode, arg_bytes, seconds = count_step(cfg, shape, mesh, microbatches if gate else 1,
                                              policy)
        n = _num_devices(mesh)
        if gate:
            row.update(_gate_row(mode, arg_bytes, seconds, n))
        if fit:
            row.update(_measure_row(cfg, shape, arch, mesh_name, mode, n))
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        with open(path, "w") as f:
            json.dump(row, f, indent=1)
    return row


@contextlib.contextmanager
def fake_world(world_size: int):
    """A "fake" process group of ``world_size`` ranks in this process (rank
    0): collectives are accepted and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-fit", action="store_true", help="gate only")
    ap.add_argument("--no-gate", action="store_true", help="fit only")
    ap.add_argument("--policy", default="dp_tp", help="dp_tp | pure_dp")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at a time, when there are several")
    ap.add_argument("--limit", type=float, default=600.0,
                    help="seconds a cell may take, when there are several")
    args = ap.parse_args()

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]
    if len(cells) > 1:
        _sweep(cells, args)
        return
    arch, shape_name, mp = cells[0]
    shape, _ = production_mesh_shape(multi_pod=mp)
    with fake_world(math.prod(shape)):
        row = run_cell(arch, shape_name, mp, fit=not args.no_fit, gate=not args.no_gate,
                       microbatches=args.microbatches, policy=args.policy, tag=args.tag)
    _print_row(row)


def _sweep(cells: list[tuple[str, str, bool]], args) -> None:
    """Every cell in a process of its own (this CLI with one cell), ``--jobs``
    at a time, each under ``--limit`` seconds; their output is passed on, and
    a table of them (per-device GB, dominant term, roofline fraction) is
    printed and written to ``<ARTIFACT_DIR>/sweep.md``.  A cell that fails
    or runs out of time is named there; any such cell fails the sweep."""
    import concurrent.futures
    import subprocess
    import sys

    flags = [f"--microbatches={args.microbatches}", f"--policy={args.policy}"]
    flags += ["--no-fit"] * args.no_fit + ["--no-gate"] * args.no_gate
    flags += [f"--tag={args.tag}"] * bool(args.tag)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # meta tensors only

    def one(cell):
        arch, shape_name, mp = cell
        name = f"{arch}__{shape_name}__{_mesh_name(mp)}" + (f"__{args.tag}" if args.tag else "")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape_name] + ["--multi-pod"] * mp + flags
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                                  timeout=args.limit)
        except subprocess.TimeoutExpired:
            return name, f"over {args.limit:.0f} s", None
        print(proc.stdout, end="", flush=True)
        if "SKIP" in proc.stdout:
            return name, "skipped", None
        path = os.path.join(ARTIFACT_DIR, name + ".json")
        if proc.returncode != 0 or not os.path.exists(path):
            err = [ln for ln in proc.stderr.splitlines() if "Error" in ln]
            return name, "failed: " + (err[-1] if err else proc.stderr[-300:])[:300], None
        with open(path) as f:
            return name, f"{time.time() - t0:.0f} s", json.load(f)

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        results = list(pool.map(one, cells))
    lines = ["| cell | per-device GB (arguments / peak) | dominant | roofline fraction | "
             "compute / memory / collective ms | wall |", "|---|---|---|---|---|---|"]
    for name, status, row in results:
        if row is None:
            lines.append(f"| {name} | {status} | | | | |")
        elif "dominant" not in row:
            mem = row["memory"]
            lines.append(f"| {name} | {mem['argument_size_gb']:.3f} / "
                         f"{mem['peak_gb_per_device']:.3f} | | | | {status} |")
        else:
            mem = row["memory"]
            lines.append(f"| {name} | {mem['argument_size_gb']:.3f} / "
                         f"{mem['peak_gb_per_device']:.3f} | {row['dominant']} | "
                         f"{row['roofline_fraction']:.3g} | {row['compute_ms']:.3g} / "
                         f"{row['memory_ms']:.3g} / {row['collective_ms']:.3g} | {status} |")
    table = "\n".join(lines)
    print(table)
    print(f"{len(cells)} cells in {time.time() - t0:.0f} s, {args.jobs} at a time", flush=True)
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(os.path.join(ARTIFACT_DIR, "sweep.md"), "w") as f:
        f.write(table + "\n")
    bad = [name for name, status, _ in results if status.startswith(("over", "failed"))]
    if bad:
        raise SystemExit(f"{len(bad)} cells failed or ran out of time: {bad}")


def _print_row(row: dict) -> None:
    if "skipped" in row:
        print(f"SKIP {row['cell']}: {row['skipped']}", flush=True)
    elif "dominant" in row:
        print(
            f"OK   {row['cell']}: dominant={row['dominant']} "
            f"compute={row['compute_ms']:.2f}ms "
            f"memory={row['memory_ms']:.2f}ms "
            f"collective={row['collective_ms']:.2f}ms "
            f"useful={row['useful_ratio']:.2f} "
            f"roofline={row['roofline_fraction']:.3f} "
            f"mem/dev {row.get('memory', {}).get('peak_gb_per_device', '?')} GB "
            f"({row.get('run_s', '?')} s)",
            flush=True,
        )
    else:
        print(
            f"OK   {row['cell']}: gate run {row.get('run_s')}s "
            f"mem/dev {row['memory'].get('peak_gb_per_device', '?')} GB",
            flush=True,
        )


if __name__ == "__main__":
    main()
