"""Rank bodies of ``tests/test_torch_multirank.py``: each runs in a process of
its own (spawned), joins a gloo group through a ``FileStore`` and holds the
port's sharded path to the unsharded one computed on the same rank from
the same seed.  Imports torch and the port only (no JAX)."""
import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, _batch_for_step, token_stream
from repro_torch.models import layers, model
from repro_torch.runtime import compression
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.serving.steps import make_decode_step, make_prefill_step
from repro_torch.sharding.specs import local_chunk
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_step import (
    accumulate_grads,
    make_compressed_train_step,
    make_train_step,
)

VOCAB = 128
CONF_ATOL = 1e-3
LOSS_RTOL = 1e-5
# a batch split over "data" sums the f32 partials of FSDP-split products in
# another order, and a few bf16 roundings flip by an ulp (measured on
# (2,2): 3.0e-5); held to the reference's own gap between two of its
# programs at the first step, jitted against op by op (1.6e-4, as
# tests/test_torch_training.py's five-step test records)
SHARDED_LOSS_RTOL = 1.6e-4
# the training tests' gradient tolerance (norm-wise per leaf), held by the
# first moment, which carries the clipped gradient (m = (1 - b1) g at step
# one); the second carries g^2, whose relative error is twice g's
GRAD_RTOL = 2.0**-7
MOMENT_RTOL = {"m": GRAD_RTOL, "v": 2 * GRAD_RTOL}
GRAD_NORM_RTOL = GRAD_RTOL
OPT = opt_lib.AdamWConfig(learning_rate=2e-3, warmup_steps=2, total_steps=5)
# one AdamW step moves a weight by at most ~lr (|m^ / sqrt(v^)| <= 1 at step
# one), so a gradient that parts by last bits moves it at most 2 lr apart
PARAM_ATOL = 2 * OPT.learning_rate * 0.5 + 2e-5  # lr at step 1 of a 2-step warmup
INT8_STEP_SLACK = 1.01
# the updated masters against AdamW's step computed by hand from the step's
# own moments: f32 rounding only (a thousandth of step one's lr of 1e-3)
UPDATE_ATOL = 1e-6


MESHES = {
    "1x2": ((1, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
}


def spawn(fn, mesh_key: str, tmp_path, *args):
    """Run ``fn(rank, world, store_path, shape, names, *args)`` on every
    rank of the mesh ``MESHES[mesh_key]``, one spawned process each."""
    shape, names = MESHES[mesh_key]
    world = int(np.prod(shape))
    mp.start_processes(fn, args=(world, str(tmp_path / "store"), shape, names, *args),
                       nprocs=world, join=True, start_method="spawn")


def cfg(arch: str = "stablelm-1.6b"):
    return get_config(arch).reduced(vocab_size=VOCAB)


def _init(rank: int, world: int, store_path: str, shape, names):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _params(c, master: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return model.init_params(c, g, device="cpu", master=master)


def _clone(tree):
    return tree_map(torch.clone, tree)


def _rel(got, want) -> float:
    """||got - want|| / ||want|| (the largest |got| where want is zero)."""
    got, want = _full(got).double(), want.double()
    den = float(want.norm())
    return float((got - want).norm()) / den if den > 0 else float(got.abs().max())


def check_moments(state, ref_state) -> None:
    """The AdamW moments of a step against a reference step's, leaf by
    leaf, norm-wise at ``MOMENT_RTOL``."""
    for name, tol in MOMENT_RTOL.items():
        for i, (a, b) in enumerate(zip(tree_leaves(state[name]), tree_leaves(ref_state[name]))):
            err = _rel(a, b)
            assert err <= tol, f"{name} leaf {i}: {err:.3g} > {tol:.3g}"


def check_moments_int8(state, ref_state, steps, opt=OPT) -> None:
    """The AdamW moments of an int8-compressed step against a reference
    step's, element by element: the two gradients they carry (m / (1 - b1))
    may part by one int8 step of the leaf (``steps``: a gradient at a
    rounding boundary rounds to the neighbouring step), and v by what that
    does to g^2 (|g^2 - g'^2| <= step (|g| + |g'|)); 1% above, for the two
    steps' clip scales."""
    b1, b2 = opt.beta1, opt.beta2
    for i, (m, mr, v, vr, step) in enumerate(zip(
            tree_leaves(state["m"]), tree_leaves(ref_state["m"]), tree_leaves(state["v"]),
            tree_leaves(ref_state["v"]), steps)):
        m, v = _full(m).double(), _full(v).double()
        mr, vr = mr.double(), vr.double()
        step = float(step) * INT8_STEP_SLACK
        gap = float((m - mr).abs().max()) / (1 - b1)
        assert gap <= step, f"m leaf {i}: {gap:.3g} > one int8 step {step:.3g}"
        mag = torch.sqrt(v / (1 - b2)) + torch.sqrt(vr / (1 - b2))
        over = ((v - vr).abs() / (1 - b2) - step * mag).max()
        assert float(over) <= 1e-18, f"v leaf {i}: {float(over):.3g} over"


def check_update(p0, p1, state, opt=OPT) -> None:
    """The updated masters ``p1`` against AdamW's step from ``p0`` computed
    by hand from the moments in ``state`` (bias-corrected, weight decay on
    matrices), at ``UPDATE_ATOL``: an update skipped, or applied with the
    wrong sign or scale, fails."""
    step = int(_full(state["step"]))
    lr = float(opt_lib.lr_schedule(torch.tensor(float(step)), opt))
    bc1, bc2 = 1 - opt.beta1**step, 1 - opt.beta2**step
    for i, (a, b, m, v) in enumerate(zip(tree_leaves(p0), tree_leaves(p1),
                                         tree_leaves(state["m"]), tree_leaves(state["v"]))):
        a, m, v = _full(a).double(), _full(m).double(), _full(v).double()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
        if opt.weight_decay > 0 and a.ndim >= 2:
            delta = delta + opt.weight_decay * a
        np.testing.assert_allclose(_full(b).double().numpy(), (a - lr * delta).numpy(),
                                   atol=UPDATE_ATOL, rtol=0, err_msg=f"leaf {i}")


def check_planted_faults(p0, p1, state) -> None:
    """``check_update`` refuses a step whose update was skipped or applied
    with its sign flipped."""
    skipped = tree_map(lambda a: _full(a).clone(), p0)
    flipped = tree_map(lambda a, b: 2 * _full(a) - _full(b), p0, p1)
    for fault in (skipped, flipped):
        try:
            check_update(p0, fault, state)
        except AssertionError:
            continue
        raise AssertionError("check_update passed a faulty update")


# ---------------------------------------------------------------------------
# serving: the batched prefill and decode steps
# ---------------------------------------------------------------------------


def serve_steps(rank, world, store_path, shape, names, arch="stablelm-1.6b", chained=True):
    """Prefill + 6 decode steps sharded (params by ``as_serving`` specs, the
    batch by ``batch_specs``) against the same steps unsharded: tokens and
    exit stages equal, confidences at atol 1e-3.  For an MoE config the
    unsharded prefill must overflow an expert (choices dropped at the
    capacity of the whole batch), so the sharded steps are held to the same
    drops.  ``chained=False`` starts each sharded decode step from the
    unsharded step's inputs (its token, and a copy of its caches laid out by
    ``cache_specs``) instead of from the sharded step before it: for a
    recurrence that grows a rounding without bound (reduced xlstm's, see
    ``tests/test_torch_multirank.py``), each step is held to its own."""
    mesh = _init(rank, world, store_path, shape, names)
    try:
        c = cfg(arch)
        B, S, max_len, n_dec = 4, 16, 24, 6
        params = _params(c, master=False)
        tokens = torch.from_numpy(
            np.random.default_rng(1).integers(0, VOCAB, (B, S)).astype(np.int32))
        prefill, decode = make_prefill_step(c, max_len), make_decode_step(c)

        # thresholds between two of the unsharded prefill's exit confidences,
        # so that exits are taken and declined
        conf = prefill(params, {"tokens": tokens}, torch.tensor([2.0, 2.0]))["exit_conf"]
        srt = torch.sort(conf, dim=0).values
        th = torch.stack([(srt[2, 0] + srt[3, 0]) / 2, (srt[1, 1] + srt[2, 1]) / 2])

        def run(params, place, inputs=None):
            """The steps; ``inputs`` (a list) collects each decode step's
            token and a copy of its caches, or, from a run before, gives
            them."""
            out = prefill(params, place({"tokens": tokens}), th)
            trace = [out]
            for k in range(n_dec):
                tok, caches = out["token"], out["caches"]
                if inputs is None or len(inputs) == k:
                    if inputs is not None:
                        inputs.append((tok, _clone(caches)))  # decode updates them in place
                else:
                    tok, caches = inputs[k]
                    caches = sharding.distribute_tree(
                        _clone(caches), sharding.cache_specs(caches), mesh)
                out = decode(params, place({"tokens": _as_col(tok)}), caches, th)
                trace.append(out)
            return trace

        def _as_col(tok):
            return tok[:, None]

        inputs = None if chained else []
        with _count_drops() as drops:
            ref = run(params, lambda b: b, inputs)
        if c.moe is not None:
            assert drops[0] > 0, "no expert overflowed"
        rules = sharding.set_mesh(mesh)
        sparams = sharding.distribute_tree(
            params, sharding.param_specs(params, rules.as_serving()), mesh)
        got = run(sparams, lambda b: sharding.distribute_tree(b, sharding.batch_specs(b), mesh),
                  inputs)
        for i, (r, g) in enumerate(zip(ref, got)):
            assert torch.equal(_full(g["token"]), r["token"]), (i, rank)
            assert torch.equal(_full(g["exit_stage"]), r["exit_stage"]), (i, rank)
            np.testing.assert_allclose(_full(g["exit_conf"]).numpy(), r["exit_conf"].numpy(),
                                       atol=CONF_ATOL, rtol=0)
        # the launch layout: a sharded step's outputs are DTensors
        assert type(got[-1]["token"]).__name__ == "DTensor"
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()


@contextlib.contextmanager
def _count_drops():
    """Yields a one-element list counting the MoE choices dropped at
    capacity inside the block (``moe.dispatch_slots`` wrapped)."""
    from repro_torch.models import moe

    count, inner = [0], moe.dispatch_slots

    def counted(idx, C, E):
        flat_e, slot = inner(idx, C, E)
        count[0] += int((slot == C).sum())
        return flat_e, slot

    moe.dispatch_slots = counted
    try:
        yield count
    finally:
        moe.dispatch_slots = inner


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_step(rank, world, store_path, shape, names, arch="stablelm-1.6b"):
    """One train step sharded (masters and AdamW state by ``param_specs``,
    the batch from ``token_stream(mesh=)``) against the unsharded step:
    loss at ``SHARDED_LOSS_RTOL``, grad norm at 2^-7, the AdamW moments at
    ``MOMENT_RTOL``, the updated masters AdamW's step from those moments
    (``check_update``, which refuses a skipped or sign-flipped update) and
    within ``PARAM_ATOL`` of the unsharded step's.  Also: the stream's shards
    concatenate to the host batch, and ``restore(shardings=)`` gives the
    saved tree back."""
    mesh = _init(rank, world, store_path, shape, names)
    try:
        c = cfg(arch)
        dcfg = DataConfig(batch_size=4, seq_len=16, seed=3)
        params = _params(c, master=True)
        p0 = _clone(params)
        ref_p = _clone(params)
        ref_s = opt_lib.init_opt_state(ref_p)
        ref_p, ref_s, ref_m = make_train_step(c, OPT)(
            ref_p, ref_s, next(token_stream(c, dcfg, device="cpu")))

        sharding.set_mesh(mesh)
        pspecs = sharding.param_specs(params)
        sp = sharding.distribute_tree(_clone(params), pspecs, mesh)
        ss = opt_lib.init_opt_state(params)
        ss = sharding.distribute_tree(ss, sharding.param_specs(ss), mesh)
        batch = next(token_stream(c, dcfg, mesh=mesh))
        host = _batch_for_step(c, dcfg, 0)
        for k, v in batch.items():
            assert type(v).__name__ == "DTensor"
            assert torch.equal(v.full_tensor(), torch.from_numpy(host[k])), k
        sp, ss, sm = make_train_step(c, OPT)(sp, ss, batch)
        np.testing.assert_allclose(float(_full(sm["loss"])), float(ref_m["loss"]),
                                   rtol=SHARDED_LOSS_RTOL)
        np.testing.assert_allclose(float(_full(sm["grad_norm"])), float(ref_m["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)
        assert int(_full(ss["step"])) == 1
        check_moments(ss, ref_s)
        check_update(p0, sp, ss)
        check_planted_faults(p0, sp, ss)
        for a, b in zip(tree_leaves(sp), tree_leaves(ref_p)):
            np.testing.assert_allclose(_full(a).numpy(), b.numpy(), atol=PARAM_ATOL, rtol=0)

        # checkpoint: the sharded masters saved whole, restored sharded
        full = tree_map(_full, sp)
        root = os.path.join(os.path.dirname(store_path), "ckpt")
        mgr = CheckpointManager(root)
        if rank == 0:
            mgr.save(1, full)
        dist.barrier()
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), full)
        back, _ = mgr.restore(like, shardings=sharding.named_shardings(pspecs, mesh))
        for a, b, s in zip(tree_leaves(back), tree_leaves(full), tree_leaves(pspecs)):
            assert type(a).__name__ == "DTensor"
            assert tuple(a.placements) == tuple(sharding.placements(s, mesh))
            assert torch.equal(a.full_tensor(), b)
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()


def xlstm_train(rank, world, store_path, shape, names):
    """Reduced xlstm-350m under a mesh in training, against the unsharded
    port on the same rank.

    One train step, chained as ``train_step`` runs it: loss at
    ``SHARDED_LOSS_RTOL``, grad norm at ``GRAD_NORM_RTOL``, the updated
    masters AdamW's step from the step's own moments (``check_update``,
    which refuses a skipped or sign-flipped update).  Its per-leaf moments
    are not held at ``GRAD_RTOL`` here: the random-weight model grows one
    f32 rounding of the sharded norms' sums to a few percent of every
    gradient, as the unsharded step does a 1e-6 change of one norm scale
    (``tests/test_torch_multirank.py``).  So the gradients are held block by
    block (``_xlstm_blocks``): stage 0's period on this mesh, whose "model"
    axis splits the 4 heads, and an sLSTM block of 2 heads on a (1, 4) mesh
    over the same ranks, whose "model" axis does not (each device then runs
    every head, the columns of ``rec`` all-gathered)."""
    mesh = _init(rank, world, store_path, shape, names)
    try:
        c = cfg("xlstm-350m")
        dcfg = DataConfig(batch_size=4, seq_len=16, seed=3)
        params = _params(c, master=True)
        p0 = _clone(params)
        batch = next(token_stream(c, dcfg, device="cpu"))
        ref_m = make_train_step(c, OPT)(_clone(params), opt_lib.init_opt_state(params), batch)[2]

        sharding.set_mesh(mesh)
        sp = sharding.distribute_tree(_clone(params), sharding.param_specs(params), mesh)
        ss = opt_lib.init_opt_state(params)
        ss = sharding.distribute_tree(ss, sharding.param_specs(ss), mesh)
        sp, ss, sm = make_train_step(c, OPT)(sp, ss, next(token_stream(c, dcfg, mesh=mesh)))
        np.testing.assert_allclose(float(_full(sm["loss"])), float(ref_m["loss"]),
                                   rtol=SHARDED_LOSS_RTOL)
        np.testing.assert_allclose(float(_full(sm["grad_norm"])), float(ref_m["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)
        check_update(p0, sp, ss)
        check_planted_faults(p0, sp, ss)

        period = params["stages"][0]["blocks"]
        _xlstm_blocks(mesh, c, [(kind, period[j][kind]) for j, kind in enumerate(c.period)])
        from torch.distributed.device_mesh import init_device_mesh

        wide = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
        sharding.set_mesh(wide)
        c2 = get_config("xlstm-350m").reduced(
            vocab_size=VOCAB, xlstm=dataclasses.replace(c.xlstm, num_heads=2))
        slstm = _params(c2, master=True)["stages"][0]["blocks"][1]["slstm"]
        _xlstm_blocks(wide, c2, [("slstm", slstm)])
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()


def _xlstm_blocks(mesh, c, blocks) -> None:
    """Each ``(kind, params)`` of ``blocks`` (stacked leaves: the first
    period's) fed the same input and output gradient sharded (``param_specs``,
    rows over "data") and unsharded: a prefill of B 4, S 16 through it, its
    output norm-wise at 2^-7 (two bf16 ulps), the gradients of every
    parameter and of the input at ``GRAD_RTOL``; then one decode token from
    the prefill's state, its output and state at 2^-7.  ``r_gates``'
    gradient comes out of an sLSTM block summed over its time steps on each
    device and not yet over the rows' devices (``Partial``): the step
    reduces it once."""
    from torch.distributed.tensor import Partial

    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(7)
    x = torch.randn((4, 16, c.d_model), generator=g).bfloat16()
    ct = torch.randn((4, 16, c.d_model), generator=g)
    xd = torch.randn((4, 1, c.d_model), generator=g).bfloat16()
    row = sharding.PartitionSpec("data", None, None)
    for kind, block in blocks:
        block = tree_map(lambda t: t[0].clone().requires_grad_(True), block)
        fwd, dec = getattr(ssm, f"{kind}_forward"), getattr(ssm, f"{kind}_decode")
        xr = x.clone().requires_grad_(True)
        want, state = fwd(block, xr, c.xlstm, return_state=True)
        (want.float() * ct).sum().backward()

        sblock = sharding.distribute_tree(tree_map(lambda t: t.detach(), block),
                                          sharding.param_specs(block), mesh)
        sblock = tree_map(lambda t: t.requires_grad_(True), sblock)
        sx = sharding.distribute(x, row, mesh).requires_grad_(True)
        with sharding.mesh_scope(sblock):
            got, sstate = fwd(sblock, sx, c.xlstm, return_state=True)
            (got.float() * sharding.distribute(ct, row, mesh)).sum().backward()
        assert _rel(got, want) <= 2.0**-7, (kind, _rel(got, want))
        assert _rel(sx.grad, xr.grad) <= GRAD_RTOL, (kind, "x", _rel(sx.grad, xr.grad))
        flat = torch.utils._pytree.tree_flatten_with_path(block)[0]
        for (path, a), b in zip(flat, tree_leaves(sblock)):
            err = _rel(b.grad, a.grad)
            assert err <= GRAD_RTOL, (kind, path, err)
        data = mesh.mesh_dim_names.index("data")
        if kind == "slstm" and mesh.size(data) > 1:
            assert isinstance(sblock["r_gates"].grad.placements[data], Partial), \
                sblock["r_gates"].grad.placements

        # one decode token from the prefill's state
        with torch.no_grad():
            names = ("c", "n", "h", "m") if kind == "slstm" else ("C", "n", "m")
            cache = dict(zip(names, (t.detach() for t in state)))
            scache = dict(zip(names, (t.detach() for t in sstate)))
            for cc in (cache, scache):
                cc["pos"] = torch.tensor(16, dtype=torch.int32)
            if kind == "mlstm":
                up = layers.matmul(x[:, -(c.xlstm.conv_kernel - 1):], block["up_proj"])
                cache["conv"] = torch.chunk(up, 2, dim=-1)[0].to(torch.bfloat16)
                scache["conv"] = sharding.distribute(cache["conv"], row, mesh)
            out, new = dec(block, xd, cache, c.xlstm)
            with sharding.mesh_scope(sblock):
                sout, snew = dec(sblock, sharding.distribute(xd, row, mesh), scache, c.xlstm)
        assert _rel(sout, out) <= 2.0**-7, (kind, "decode", _rel(sout, out))
        for k in names:
            assert _rel(snew[k], new[k]) <= 2.0**-7, (kind, "decode", k, _rel(snew[k], new[k]))


def compressed_step(rank, world, store_path, shape, names):
    """The int8 cross-pod step on a mesh with a "pod" axis against a hand
    computation from each pod's own gradients: quantize each pod's gradient
    tree (zero error in), sum the int8 payloads, scale by the larger scale
    over the pod count, one AdamW step.  Loss (the pods' mean) at rtol 1e-5,
    the AdamW moments at ``MOMENT_RTOL``, the updated masters AdamW's step
    from those moments (``check_update``) and within ``PARAM_ATOL`` of the
    hand step's, and this pod's error residual
    within one int8 step of the hand residual (a gradient that parts by a
    last bit may round to the neighbouring step)."""
    mesh = _init(rank, world, store_path, shape, names)
    try:
        c = cfg()
        npods = mesh.size(0)
        pod = mesh.get_coordinate()[0]
        dcfg = DataConfig(batch_size=4, seq_len=16, seed=5)
        params = _params(c, master=True)
        host = next(token_stream(c, dcfg, device="cpu"))
        loss_fn = lambda p, b: model.loss_fn(p, b, c)  # noqa: E731
        rows = host["tokens"].shape[0] // npods
        per_pod = []
        for p in range(npods):
            b = {k: v[p * rows:(p + 1) * rows] for k, v in host.items()}
            loss, grads, _ = accumulate_grads(loss_fn, params, b, 1)
            q, s, e = compression.compress_tree(grads, compression.init_error(params))
            per_pod.append((loss, q, s, e))
        q_sum = tree_map(lambda *qs: sum(x.to(torch.int32) for x in qs), *[t[1] for t in per_pod])
        s_max = tree_map(lambda *ss: torch.stack(ss).max(), *[t[2] for t in per_pod])
        grads = tree_map(lambda qi, si: qi.float() * si / npods, q_sum, s_max)
        p0, ref_p = _clone(params), _clone(params)
        ref_p, ref_s, _ = opt_lib.adamw_update(ref_p, grads, opt_lib.init_opt_state(ref_p), OPT)
        ref_loss = sum(float(t[0]) for t in per_pod) / npods

        sharding.set_mesh(mesh)
        pspecs = sharding.param_specs(params)
        sp = sharding.distribute_tree(_clone(params), pspecs, mesh)
        state = opt_lib.init_opt_state(params)
        state["error"] = compression.init_error(params)
        state = sharding.distribute_tree(state, sharding.param_specs(state), mesh)
        batch = next(token_stream(c, dcfg, mesh=mesh))
        sp, state, sm = make_compressed_train_step(c, mesh, OPT)(sp, state, batch)
        np.testing.assert_allclose(float(_full(sm["loss"])), ref_loss, rtol=LOSS_RTOL)
        check_moments_int8(state, ref_s, tree_leaves(s_max))
        check_update(p0, sp, state)
        for a, b in zip(tree_leaves(sp), tree_leaves(ref_p)):
            np.testing.assert_allclose(_full(a).numpy(), b.numpy(), atol=PARAM_ATOL, rtol=0)
        # this pod's residual: each rank's shards are its own pod's
        for e, want, s in zip(tree_leaves(state["error"]), tree_leaves(per_pod[pod][3]),
                              tree_leaves(per_pod[pod][2])):
            local = e.to_local()
            ref = local_chunk(want, _spec_of(e, mesh), mesh)
            np.testing.assert_allclose(local.numpy(), ref.numpy(), atol=float(s) * 1.001, rtol=0)
        assert int(_full(state["step"])) == 1
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()


def _spec_of(t, mesh):
    """The ``PartitionSpec`` of a DTensor's placements (no dim split over
    two axes here)."""
    from torch.distributed.tensor import Shard

    parts = [None] * t.ndim
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            parts[p.dim] = name
    return sharding.PartitionSpec(*parts)


# ---------------------------------------------------------------------------
# split-KV decode: caches laid out by ``cache_specs`` (sequence split)
# ---------------------------------------------------------------------------

# no single collective of a decode step over a split cache moves more: the
# gathers of a whole layer's K or V (megabytes at full width) are gone
RECORD_MAX_BYTES = 16 * 1024


def _cache_split_dims(caches) -> set:
    """The mesh dims that split a cache leaf along its sequence (``k``,
    ``v``, ``c_kv``, ``k_pe``: the dim after the batch)."""
    from torch.distributed.tensor import Shard

    out = set()
    flat = torch.utils._pytree.tree_flatten_with_path(caches)[0]
    for path, leaf in flat:
        name = getattr(path[-1], "key", None)
        if name in ("k", "v", "c_kv", "k_pe"):
            seq = leaf.ndim - (3 if name in ("c_kv", "k_pe") else 4) + 1
            out |= {i for i, p in enumerate(leaf.placements)
                    if isinstance(p, Shard) and p.dim == seq}
    return out


def split_decode(rank, world, store_path, shape, names, arch="stablelm-1.6b", B=4, S=16,
                 max_len=32, n_dec=4, record=False):
    """Prefill unsharded, then ``n_dec`` decode steps twice: unsharded, and
    sharded (parameters by the ``as_serving`` specs, the batch by
    ``batch_specs``, the prefill's caches laid out by ``cache_specs``, their
    sequence split).  Tokens and exit stages equal, confidences at atol
    1e-3.  With ``record``, the sharded steps run under
    ``CollectiveRecorder`` and no record may exceed ``RECORD_MAX_BYTES``;
    the kernel wrappers' split paths (``ops.decode_attention`` on a
    sequence-split cache, ``ops.exit_confidence`` on a vocab-split head) are
    also held to their unsharded calls."""
    from repro_torch.roofline.collectives import CollectiveRecorder

    mesh = _init(rank, world, store_path, shape, names)
    try:
        c = cfg(arch)
        params = _params(c, master=False)
        tokens = torch.from_numpy(
            np.random.default_rng(2).integers(0, VOCAB, (B, S)).astype(np.int32))
        prefill, decode = make_prefill_step(c, max_len), make_decode_step(c)
        out = prefill(params, {"tokens": tokens}, torch.full((len(c.exit_stages),), 2.0))
        srt = torch.sort(out["exit_conf"], dim=0).values
        th = (srt[B // 2 - 1] + srt[B // 2]) / 2 if B > 1 else srt[0] * 1.0001
        first = _as_col(out["token"])
        caches0 = out["caches"]

        def run(params, caches, place):
            tok, trace = first, []
            for _ in range(n_dec):
                o = decode(params, place({"tokens": tok}), caches, th)
                caches = o["caches"]
                tok = _as_col(_full(o["token"]))
                trace.append(o)
            return trace

        ref = run(params, tree_map(torch.clone, caches0), lambda b: b)
        rules = sharding.set_mesh(mesh)
        sparams = sharding.distribute_tree(
            params, sharding.param_specs(params, rules.as_serving()), mesh)
        scaches = sharding.distribute_tree(tree_map(torch.clone, caches0),
                                           sharding.cache_specs(caches0), mesh)
        assert _cache_split_dims(scaches), "no cache leaf is split along its sequence"
        with CollectiveRecorder() as rec:
            got = run(sparams, scaches,
                      lambda b: sharding.distribute_tree(b, sharding.batch_specs(b), mesh))
        for i, (r, g) in enumerate(zip(ref, got)):
            assert torch.equal(_full(g["token"]), r["token"]), (i, rank)
            assert torch.equal(_full(g["exit_stage"]), r["exit_stage"]), (i, rank)
            np.testing.assert_allclose(_full(g["exit_conf"]).numpy(), r["exit_conf"].numpy(),
                                       atol=CONF_ATOL, rtol=0)
        if record:
            biggest = max(nbytes for _, nbytes, _ in rec.records)
            assert biggest <= RECORD_MAX_BYTES, (biggest, sorted(set(rec.records))[-5:])
            _kernel_paths(mesh, c)
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()


def _as_col(tok):
    return tok[:, None]


def _kernel_paths(mesh, c):
    """``ops.decode_attention`` on a sequence-split cache and
    ``ops.exit_confidence`` on a vocab-split head against their unsharded
    calls (the plain versions on the CPU; the kernels on the card)."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(4)
    B, S, H, hd = 4, 32, c.num_heads, c.head_dim
    q = torch.randn((B, H, hd), generator=g).bfloat16()
    k = torch.randn((B, S, c.num_kv_heads, hd), generator=g).bfloat16()
    v = torch.randn((B, S, c.num_kv_heads, hd), generator=g).bfloat16()
    ln = torch.tensor([32, 5, 17, 1], dtype=torch.int32)
    P = sharding.PartitionSpec
    batch = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    sk = sharding.distribute(k, P(batch, "model", None, None), mesh)
    sv = sharding.distribute(v, P(batch, "model", None, None), mesh)
    got = ops.decode_attention(sharding.distribute(q, P(batch, None, None), mesh), sk, sv,
                               sharding.distribute(ln, P(batch), mesh))
    np.testing.assert_allclose(_full(got).float().numpy(),
                               ops.decode_attention(q, k, v, ln).float().numpy(), atol=2e-2)
    d, V = c.d_model, VOCAB
    h = torch.randn((B, d), generator=g)
    w = torch.randn((d, V), generator=g) / d**0.5
    w[:, [3, 70, 100, 127]] += 6.0 * (h / h.norm(dim=1, keepdim=True) ** 2).T
    h, w = h.bfloat16(), w.bfloat16()
    conf, idx = ops.exit_confidence(sharding.distribute(h, P(batch, None), mesh),
                                    sharding.distribute(w, P(None, "model"), mesh))
    cr, ir = ops.exit_confidence(h, w)
    np.testing.assert_allclose(_full(conf).numpy(), cr.numpy(), atol=CONF_ATOL)
    assert torch.equal(_full(idx), ir) and ir.tolist() == [3, 70, 100, 127]


def unaligned_vocab_head(rank, world, store_path, shape, names, V=500):
    """``ops.exit_confidence`` on an LM head of ``V`` columns split over the
    "model" axis into shards whose rows are no whole number of 16-byte
    units (V 500 over 2 or 4: 250 or 125 columns), against the unsharded
    head on the same rank: the split is kept (no collective record holds a
    shard of the head or more), conf at atol 1e-3, argmax exact.  Row 0's
    top column is the first shard's last, row 1's the last shard's first."""
    from repro_torch.kernels import ops
    from repro_torch.roofline.collectives import CollectiveRecorder

    mesh = _init(rank, world, store_path, shape, names)
    try:
        c = get_config("stablelm-1.6b").reduced(vocab_size=V)
        n = mesh.size(names.index("model"))
        g = torch.Generator().manual_seed(5)
        B, d = 4, c.d_model
        h = torch.randn((B, d), generator=g)
        w = torch.randn((d, V), generator=g) / d**0.5
        top = [V // n - 1, V - V // n, 7, V - 1]
        w[:, top] += 6.0 * (h / h.norm(dim=1, keepdim=True) ** 2).T
        h, w = h.bfloat16(), w.bfloat16()
        P = sharding.PartitionSpec
        sw = sharding.distribute(w, P(None, "model"), mesh)
        assert ops._vocab_splits(sw), "the head's vocab split is not kept"
        with CollectiveRecorder() as rec:
            conf, idx = ops.exit_confidence(sharding.distribute(h, P("data", None), mesh), sw)
        shard_bytes = d * (V // n) * 2
        biggest = max(nbytes for _, nbytes, _ in rec.records)
        assert biggest < shard_bytes, (biggest, shard_bytes, sorted(set(rec.records))[-3:])
        cr, ir = ops.exit_confidence(h, w)
        np.testing.assert_allclose(_full(conf).numpy(), cr.numpy(), atol=CONF_ATOL, rtol=0)
        assert torch.equal(_full(idx), ir) and ir.tolist() == top, (ir.tolist(), top)
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()
