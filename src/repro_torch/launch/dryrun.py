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
    iteration (the periods, the attention chunks), so the counts are exact
    at full depth and the reference's two-point depth fit (and its
    ``set_unroll``) has no counterpart.  A scan over time (``layers.scan``,
    sLSTM's) runs its body until a step leaves its carry's layout as it
    found it, and counts that step's ops for each step left: every later
    step runs the same ops, so the count is the loop's, exactly (see
    ``CostMode``).  Per device:
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
from repro_torch.models import layers
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


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _signature(ts) -> tuple:
    """What decides the ops a scan step runs on these tensors (a carry, or
    its gradients): kind, shape, dtype, the local shard's strides, whether
    a gradient flows, the layout."""
    return tuple(None if t is None else (
        type(t), tuple(t.shape), t.dtype, tuple(_local(t).stride()), t.requires_grad,
        tuple(getattr(t, "placements", ()))) for t in ts)


class CostMode(CollectiveRecorder):
    """Counts the local ops a (DTensor) program runs: FLOPs, bytes,
    collectives, and the live and peak bytes of storages (see the module
    docstring).

    While it is active ``layers.scan`` is counted (``_scan``): the body runs
    until a step leaves its carry's signature (``_signature``) as it found
    it (the first step or two differ: a plain initial state, a first
    layout), and that step's counts are added once for every step left.
    The outputs are meta tensors of their full shapes, stacked as the loop
    stacks them, and the storages the loop's outputs would hold are held
    meanwhile.  With gradients the scan is one autograd function
    (``_CountedScan``) whose backward counts the steps' backwards the same
    way.  ``full_scans=True`` runs the loop instead (the tests' yardstick)."""

    def __init__(self, full_scans: bool = False) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_op: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.full_scans = full_scans
        self._seen = WeakIdKeyDictionary()  # storage -> its serial number
        self._serial = 0
        self._counting = True
        self._tracking = True
        self._outer_scans: list = []

    def __enter__(self):
        self._outer_scans.append(layers.set_scan(None if self.full_scans else self._scan))
        return super().__enter__()

    def __exit__(self, *exc):
        layers.set_scan(self._outer_scans.pop())
        return super().__exit__(*exc)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it dies (once per storage)."""
        if self._tracking:
            self._track_storage(_local(t).untyped_storage())

    def _track_storage(self, st) -> None:
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = self._serial
        self._serial += 1
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
        rec = c10d_record(func, args, out) if self._counting else None
        if rec is not None:
            self.records.append(rec)
        elif self._counting:
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

    # -- counted scans --------------------------------------------------------

    @contextlib.contextmanager
    def _paused(self):
        """Ops run here are tracked but not counted (a step re-run for its
        backward: the loop's graph kept it)."""
        self._counting = False
        try:
            yield
        finally:
            self._counting = True

    def _snap(self) -> tuple:
        return self.flops, self.bytes, dict(self.flops_by_op), len(self.records)

    def _since(self, snap: tuple) -> tuple:
        """The counts added since ``snap`` (exact: the sums are integers)."""
        flops, nbytes, by_op, n = snap
        return (self.flops - flops, self.bytes - nbytes,
                {k: v - by_op.get(k, 0.0) for k, v in self.flops_by_op.items()},
                self.records[n:])

    def _repeat(self, delta: tuple, times: int) -> None:
        """Count ``delta`` (from ``_since``) ``times`` more times."""
        if times <= 0:
            return
        flops, nbytes, by_op, records = delta
        self.flops += flops * times
        self.bytes += nbytes * times
        for k, v in by_op.items():
            if v:
                self.flops_by_op[k] = self.flops_by_op.get(k, 0.0) + v * times
        self.records.extend(records * times)

    def _run_steps(self, body, carry: tuple, xs: torch.Tensor, saved: list | None = None):
        """The scan's first steps, until one leaves its carry's signature as
        it found it; that step's counts are added for every step left.
        Returns ``(last carry, ys of the steps run, each run step's carry)``.
        With ``saved`` (a list), each step's saved tensors' storages born in
        the scan go into it, one dict a step, and at least two steps run."""
        S = xs.shape[1]
        born = self._serial
        inputs, ys = [], []
        while True:
            inputs.append(carry)
            snap = self._snap()
            if saved is None:
                new, y = body(carry, xs[:, len(ys)])
            else:
                saved.append({})
                pack = _pack_into(saved[-1], self._seen, born)
                with torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
                    new, y = body(carry, xs[:, len(ys)])
            delta = self._since(snap)
            ys.append(y)
            steady = _signature(new) == _signature(carry)
            carry = new
            if len(ys) == S or (steady and (saved is None or len(ys) > 1)):
                break
        self._repeat(delta, S - len(ys))
        return carry, ys, inputs

    def _stack(self, ys: list, S: int) -> torch.Tensor:
        """The S steps' outputs stacked along dim 1 as the loop stacks them,
        the last step run standing for the steps not run, whose storages
        the loop would hold meanwhile."""
        rest = S - len(ys)
        hold = _hold(rest * _local(ys[-1]).untyped_storage().nbytes())
        out = torch.stack(ys + [ys[-1]] * rest, dim=1)
        del hold
        return out

    def _scan(self, body, carry: tuple, xs: torch.Tensor, params: tuple):
        """``layers.scan`` counted (see the class docstring)."""
        carry = tuple(carry)
        if xs.device.type != "meta" or xs.shape[1] < 2:
            return layers.loop_scan(body, carry, xs, params)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (*carry, xs, *params)):
            out = _CountedScan.apply(self, body, len(carry), params, *carry, xs, *params)
            st = self._last_hold()
            if st is not None:  # kept for the backward (not discarded by a checkpoint)
                self._track_storage(st)
            return tuple(out[:-1]), out[-1]
        carry, ys, _ = self._run_steps(body, carry, xs)
        return carry, self._stack(ys, xs.shape[1])


def _hold(nbytes: int) -> torch.Tensor:
    """A meta storage of ``nbytes``, live (tracked) while referenced."""
    return torch.empty((max(0, nbytes),), dtype=torch.uint8, device="meta")


def _pack_into(step: dict, seen, born: int):
    """A saved-tensor pack hook noting the storages born since serial
    ``born`` (a scan's) in ``step``, and saving nothing: the graph of the
    steps run in a counted forward is never differentiated."""
    def pack(t):
        st = _local(t).untyped_storage()
        if seen.get(st, -1) >= born:
            step[id(st)] = (st, st.nbytes())
    return pack


def _held_bytes(saved: list[dict], S: int) -> int:
    """Bytes a loop of ``S`` steps keeps for its backward, from the saved
    storages of the steps run (the last one steady): what each step saves
    that the step before it did not, the steady step's for the rest."""
    new = [sum(n for key, (_, n) in step.items() if key not in prev)
           for prev, step in zip([{}] + saved[:-1], saved)]
    return sum(new) + new[-1] * (S - len(saved))


class _CountedScan(torch.autograd.Function):
    """A counted ``layers.scan`` with gradients (``CostMode._scan``).

    The forward runs the steps as ``CostMode._run_steps`` does and saves a
    meta storage of the bytes the loop's graph would save over all the
    steps.  The backward re-runs each distinct step's forward uncounted
    and counts its backward, from the last step down: the last step (no
    carry gradient from a later one), one steady step, whose counts stand
    for every steady step while its carry gradients keep their signature,
    and the first steps run; the adds that sum the gradients of ``xs`` and
    of ``params`` over the steps are counted with each step, as the loop's
    autograd adds them.  It returns gradients of the full shapes."""

    @staticmethod
    def forward(ctx, mode, body, n, params, *args):
        carry, xs = args[:n], args[n]
        S = xs.shape[1]
        ctx.set_materialize_grads(False)
        saved: list[dict] = []
        with torch.enable_grad():
            final, ys, inputs = mode._run_steps(body, carry, xs, saved)
            ys = mode._stack(ys, S)
        mode._tracking = False  # tracked by ``_scan`` only if the graph keeps it
        try:
            hold = _hold(_held_bytes(saved, S))
        finally:
            mode._tracking = True
        mode._last_hold = weakref.ref(hold.untyped_storage())
        ctx.mode, ctx.body, ctx.n, ctx.S, ctx.params = mode, body, n, S, params
        ctx.flags = [[c.requires_grad for c in inp] for inp in inputs]
        ctx.xs_grad = xs.requires_grad
        ctx.save_for_backward(hold, xs, *(c.detach() for inp in inputs for c in inp))
        return (*(c.detach() for c in final), ys.detach())

    @staticmethod
    def backward(ctx, *grads):
        mode, body, n, S, params = ctx.mode, ctx.body, ctx.n, ctx.S, ctx.params
        hold, xs, *flat = ctx.saved_tensors
        del hold
        xs = xs.detach().requires_grad_(ctx.xs_grad)
        inputs = [flat[i * n:(i + 1) * n] for i in range(len(ctx.flags))]
        k = len(inputs) - 1  # the steady step (the last step run)
        g_carry, g_ys = grads[:n], grads[n]
        acc: list = [None] * (1 + len(params))  # xs's and params' gradients
        t = S - 1
        while t >= 0:
            i = min(t, k)
            snap = mode._snap()
            g_in = _step_backward(mode, body, inputs[i], ctx.flags[i], xs, t, params, g_carry,
                                  None if g_ys is None else g_ys.select(1, t), acc)
            delta = mode._since(snap)
            steady = k <= t < S - 1 and _signature(g_in) == _signature(g_carry)
            g_carry = g_in
            if steady and t > k:  # steps t-1 .. k run these ops again
                mode._repeat(delta, t - k)
                t = k
            t -= 1
        return (None, None, None, None, *g_carry, acc[0], *acc[1:])


def _step_backward(mode, body, carry, flags, xs, t, params, g_carry, g_y, acc):
    """Step ``t``'s backward: its forward re-run uncounted from ``carry``,
    then autograd from its outputs' gradients to its carry, ``xs`` and
    ``params``; the gradients of ``xs`` and ``params`` are added into
    ``acc``.  Returns the carry's gradients (None where none flows)."""
    with torch.enable_grad():
        carry = tuple(c.detach().requires_grad_(f) for c, f in zip(carry, flags))
        with mode._paused():
            new, y = body(carry, xs[:, t])
        pairs = [(o, g) for o, g in zip((*new, y), (*g_carry, g_y))
                 if g is not None and o.requires_grad]
        wrt = [c for c in carry if c.requires_grad]
        wrt += [a for a in (xs, *params) if a.requires_grad]
        got = list(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True)) if pairs else [None] * len(wrt)
    g_in = tuple(got.pop(0) if c.requires_grad else None for c in carry)
    for j, a in enumerate((xs, *params)):
        if a.requires_grad:
            g = got.pop(0)
            if g is not None:
                acc[j] = g if acc[j] is None else acc[j] + g
    return g_in


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
               policy: str = "dp_tp", full_scans: bool = False) -> tuple[CostMode, int, float]:
    """Run the cell's step once under ``CostMode``: ``(counts, argument
    bytes per device, seconds)``.  ``full_scans`` runs every scan step."""
    t0 = time.time()
    run, args = build_step(cfg, shape, mesh, microbatches, policy)
    mode = CostMode(full_scans)
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
