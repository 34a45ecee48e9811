"""The port's multi-device path across real ranks: 2 and 4 gloo processes
on the CPU (spawned, joined through a ``FileStore`` under ``tmp_path``, so
parallel test workers cannot collide), on reduced stablelm-1.6b over
meshes (1,2), (2,2) and (2,1,2).  The rank bodies and their tolerances are
in ``tests/torch_multirank_workers.py``; each holds the sharded path to the
unsharded one computed on the same rank.  The compressed step at one pod
is held to the JAX package's here, in this process (a world of one).

The serve and train steps run here on (1,2) and (2,2), and the compressed
step on (2,1,2); ``tests/test_torch_multirank_moe_pods.py`` runs the serve
and train steps on (2,1,2) and reduced mixtral-8x7b's MoE on (2,2), so that
each file stays near 90 s on one test worker."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_multirank_workers as workers

@pytest.mark.parametrize("mesh_key", ["1x2", "2x2"])
def test_sharded_serve_steps_equal_unsharded(mesh_key, tmp_path):
    workers.spawn(workers.serve_steps, mesh_key, tmp_path)


@pytest.mark.parametrize("mesh_key", ["1x2", "2x2"])
def test_sharded_train_step_stream_and_restore(mesh_key, tmp_path):
    workers.spawn(workers.train_step, mesh_key, tmp_path)


def test_compressed_step_two_pods_equals_hand_computation(tmp_path):
    workers.spawn(workers.compressed_step, "2x1x2", tmp_path)


def test_compressed_step_one_pod_equals_reference(tmp_path):
    """At one pod the int8 step equals the JAX ``make_compressed_train_step``
    on a one-device ("pod", "data", "model") mesh from the same f32 masters
    and batch: grad norm at 2^-7, the AdamW moments at ``MOMENT_RTOL``, the
    updated masters AdamW's step from the port's moments and within
    ``PARAM_ATOL`` of the reference's, and the error residual within one
    int8 step.  The reference step runs
    jitted only (op by op, its ``shard_map`` refuses the out_specs), so the
    loss is held at rtol 1e-5 to the reference's loss run op by op, and the
    jitted step's loss to that one at its own gap (up to 4.1e-4 between
    the two, as ``tests/test_torch_training.py``'s five-step test records)."""
    import jax

    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import token_stream as jtoken_stream
    from repro.models import model as jmodel
    from repro.runtime import compression as jcompression
    from repro.training import AdamWConfig as JAdamW
    from repro.training import optimizer as jopt
    from repro.training.train_step import make_compressed_train_step as jmake
    from repro_torch import sharding
    from repro_torch.data.pipeline import DataConfig, token_stream
    from repro_torch.runtime import compression
    from repro_torch.runtime.checkpoint import _leaf_paths
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train_step import make_compressed_train_step
    from torch_train_common import master_params

    from torch.distributed.device_mesh import init_device_mesh

    def as_f64(t):
        return (t.full_tensor() if hasattr(t, "full_tensor")
                else torch.from_numpy(np.asarray(t, np.float32))).double()

    def sorted_leaves(tree):
        """The leaves in JAX's order (dict keys sorted)."""
        return [v for _, v in _leaf_paths(tree)]

    jp, tp, jcfg, tcfg = master_params("stablelm-1.6b")
    opt = dict(learning_rate=2e-3, warmup_steps=2, total_steps=5)
    jmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    js = jopt.init_opt_state(jp)
    js["error"] = jcompression.init_error(jp)
    batch = next(jtoken_stream(jcfg, JDataConfig(batch_size=4, seq_len=16, seed=3)))
    jp2, js2, jm = jax.jit(jmake(jcfg, jmesh, JAdamW(**opt)))(jp, js, batch)
    with jax.disable_jit():
        j_loss = float(jmodel.loss_fn(jp, batch, jcfg)[0])
    np.testing.assert_allclose(float(jm["loss"]), j_loss, rtol=5e-4)

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        sharding.set_mesh(mesh)
        tp0 = workers._clone(tp)
        sp = sharding.distribute_tree(tp, sharding.param_specs(tp), mesh)
        state = topt.init_opt_state(tp)
        state["error"] = compression.init_error(tp)
        state = sharding.distribute_tree(state, sharding.param_specs(state), mesh)
        tbatch = next(token_stream(tcfg, DataConfig(batch_size=4, seq_len=16, seed=3), mesh=mesh))
        sp, state, tm = make_compressed_train_step(tcfg, mesh, topt.AdamWConfig(**opt))(
            sp, state, tbatch)
        np.testing.assert_allclose(float(tm["loss"].full_tensor()), j_loss,
                                   rtol=workers.LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=workers.GRAD_NORM_RTOL)
        # at one pod, from zero error, a leaf's gradient is what the int8
        # payload dequantizes to plus the residual: g = m / ((1 - b1) c) + e,
        # c the clip scale of the dequantized gradients' norm.  Each step's g
        # is held to the reference's gradient run op by op, the port's within
        # twice the jitted step's gap on the leaf or 2^-7, whichever is
        # larger (the whole-model rule of tests/torch_train_grads.py)
        def grads(m_leaves, e_leaves, gnorm):
            c = min(1.0, 1.0 / max(gnorm, 1e-9))
            return [as_f64(m) / ((1 - 0.9) * c) + as_f64(e) for m, e in zip(m_leaves, e_leaves)]

        with jax.disable_jit():
            want = jax.tree.leaves(jax.grad(lambda p: jmodel.loss_fn(p, batch, jcfg)[0])(jp))
        want = [as_f64(w) for w in want]
        got = grads(sorted_leaves(state["m"]), sorted_leaves(state["error"]),
                    float(tm["grad_norm"]))
        jitted = grads(jax.tree.leaves(js2["m"]), jax.tree.leaves(js2["error"]),
                       float(jm["grad_norm"]))
        for i, (w, g, j) in enumerate(zip(want, got, jitted)):
            bound = max(workers.GRAD_RTOL, min(2 * workers._rel(j, w), 0.5))
            assert workers._rel(g, w) <= bound, (i, workers._rel(g, w), bound)
        workers.check_update(tp0, sp, state, topt.AdamWConfig(**opt))
        for a, b in zip(sorted_leaves(sp), jax.tree.leaves(jp2)):
            np.testing.assert_allclose(a.full_tensor().numpy(), np.asarray(b),
                                       atol=workers.PARAM_ATOL, rtol=0)
        for a, b in zip(sorted_leaves(state["error"]), jax.tree.leaves(js2["error"])):
            # |residual| <= step / 2, so twice the larger is one int8 step
            step = 2 * max(float(np.abs(np.asarray(b)).max()),
                           float(a.full_tensor().abs().max())) + 1e-12
            np.testing.assert_allclose(a.full_tensor().numpy(), np.asarray(b), atol=step, rtol=0)
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()
