"""The port's optimizer and train step (``repro_torch.training``) against
the JAX package's (``repro.training``), and the reference's own training
tests (``tests/test_training.py``) run on the port: AdamW's math against a
hand-computed step, the warmup/cosine schedule, clipping, microbatch
accumulation, five train steps against the JAX step, the loss decreasing
over 30 steps, the metrics' keys and ``REPRO_BF16_PARAMS``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import DataConfig as JDataConfig
from repro.data import token_stream as jtoken_stream
from repro.training import AdamWConfig as JAdamW
from repro.training import make_train_step as jmake_train_step
from repro.training import optimizer as jopt
from repro_torch.data import DataConfig, token_stream
from repro_torch.models import model as tmodel
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import accumulate_grads

from torch_train_common import master_params, torch_leaves_like

F32_ATOL = 2e-5


def _pair(rng):
    """One tree for both packages: a matrix, a vector and a stacked
    ``[n_periods, d]`` leaf (a block's norm scale), with grads."""
    shapes = {"w": (6, 5), "b": (5,), "stacked": {"scale": (3, 5)}}
    p = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    g = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    to_t = lambda t: jax.tree.map(lambda a: torch.from_numpy(a.copy()), t)  # noqa: E731
    return jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g), to_t(p), to_t(g)


def test_adamw_matches_reference_scalar():
    """One AdamW step on a 2-vector vs the hand-computed update (the
    reference's test)."""
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.1]])}
    cfg = AdamWConfig(learning_rate=0.1, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                      grad_clip_norm=0.0, warmup_steps=0, total_steps=10**9)
    state = topt.init_opt_state(p)
    p2, state2, _ = topt.adamw_update(p, g, state, cfg)
    m = 0.1 * np.array([0.5, 0.1])
    v = 0.001 * np.array([0.5, 0.1]) ** 2
    mh, vh = m / 0.1, v / 0.001
    expect = np.array([1.0, -2.0]) - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy()[0], expect, rtol=1e-5)
    assert int(state2["step"]) == 1 and state2["step"].dtype == torch.int32


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """Three steps on the same numpy params and grads in both packages:
    params, m, v at f32 atol 2e-5, the step counter, grad_norm and lr."""
    rng = np.random.default_rng(0)
    jp, jg, tp, tg = _pair(rng)
    jcfg = JAdamW(grad_clip_norm=clip, warmup_steps=2, total_steps=5, learning_rate=1e-2)
    tcfg = AdamWConfig(grad_clip_norm=clip, warmup_steps=2, total_steps=5, learning_rate=1e-2)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    for _ in range(3):
        jp, js, jm = jopt.adamw_update(jp, jg, js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, tg, ts, tcfg)
        for tree_j, tree_t in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
            for a, b in zip(jax.tree.leaves(tree_j), torch.utils._pytree.tree_leaves(tree_t)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32_ATOL, rtol=0)
        assert int(ts["step"]) == int(js["step"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)


def test_adamw_decays_stacked_norm_scales_as_the_reference():
    """The reference decays every leaf with ``ndim >= 2``, so a block's
    stacked norm scale ``[n_periods, d]`` is decayed and a 1-D one is not;
    the port keeps that rule.  With zero grads only the decay moves a leaf."""
    p = {"w": torch.ones(4, 3), "scale": torch.ones(3), "stacked": torch.ones(2, 3)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    cfg = AdamWConfig(learning_rate=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10**9)
    p2, _, _ = topt.adamw_update({k: v.clone() for k, v in p.items()}, g,
                                 topt.init_opt_state(p), cfg)
    jp2, _, _ = jopt.adamw_update({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                  {k: jnp.asarray(v.numpy()) for k, v in g.items()},
                                  jopt.init_opt_state({k: jnp.asarray(v.numpy()) for k, v in p.items()}),
                                  JAdamW(learning_rate=0.1, weight_decay=0.5, warmup_steps=0,
                                         total_steps=10**9))
    for k in p:
        np.testing.assert_allclose(p2[k].numpy(), np.asarray(jp2[k]), atol=F32_ATOL)
    np.testing.assert_allclose(p2["stacked"].numpy(), 1 - 0.1 * 0.5, rtol=1e-6)
    np.testing.assert_array_equal(p2["scale"].numpy(), 1.0)


@pytest.mark.parametrize("step", [0, 1, 7, 50, 100, 4000, 10_000, 20_000])
def test_lr_schedule_matches_reference(step):
    cfg = AdamWConfig()
    want = jopt.lr_schedule(jnp.asarray(step, jnp.int32), JAdamW())
    got = topt.lr_schedule(torch.tensor(step, dtype=torch.int32), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_grad_clip_norm():
    """The reference's test, and the clipped tree against the reference's."""
    g = {"a": torch.ones(10) * 3.0}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 3.0 * np.sqrt(10), rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0, rtol=1e-5)
    rng = np.random.default_rng(1)
    _, jg, _, tg = _pair(rng)
    jc, jn = jopt.clip_by_global_norm(jg, 2.5)
    tc, tn = topt.clip_by_global_norm(tg, 2.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), torch.utils._pytree.tree_leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32_ATOL)


@pytest.fixture(scope="module")
def tiny():
    return master_params("stablelm-1.6b")


def test_microbatch_grads_equal_full_batch(tiny):
    """The reference's test on the port: k=2 against k=1, atol 3e-3."""
    _, params, _, cfg = tiny
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)),
    }
    loss = lambda p, b: tmodel.loss_fn(p, b, cfg)  # noqa: E731
    l1, g1, m1 = accumulate_grads(loss, params, batch, 1)
    l2, g2, m2 = accumulate_grads(loss, params, batch, 2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-4)
    assert set(m2) == set(m1)
    for a, b in zip(torch.utils._pytree.tree_leaves(g1), torch.utils._pytree.tree_leaves(g2)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-3)


def _update(after, before) -> np.ndarray:
    """The change of a parameter tree (JAX's or the port's) as one f64 vector."""
    if isinstance(jax.tree.leaves(after)[0], torch.Tensor):
        pairs = zip(torch_leaves_like(after), torch_leaves_like(before))
        return np.concatenate([(a - b).double().numpy().ravel() for a, b in pairs])
    pairs = zip(jax.tree.leaves(after), jax.tree.leaves(before))
    return np.concatenate([np.asarray(a - b, np.float64).ravel() for a, b in pairs])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(tiny, microbatches):
    """Five steps of ``make_train_step`` from the same f32 masters on the
    same stream against the JAX train step run op by op, held to the
    reference's own gap: the same JAX step jitted, from the same state on
    the same batches.  Grad norms at 2^-7 and the lr exactly at every step;
    the first loss at rtol 1e-5.

    From the second step on the port's loss parts from the op-by-op one by up
    to 5.9e-4 (measured), and no fixed rtol of 1e-4 holds: the jitted
    reference parts from it by 1.6e-4 to 4.1e-4 at every step, its first
    included.  AdamW's first steps move every weight by about +-lr whatever
    the size of its gradient, so a weight whose gradient is near zero, and
    whose sign the programs' last-bit gaps decide, moves the other way.  So
    every loss is held within twice the jitted reference's worst gap over
    the five steps (the triangle inequality's bound), and the five steps'
    update of the parameters norm-wise no farther from the op-by-op one than
    the jitted reference's update is (measured: the port 3.8%, the jitted
    reference 5.9%; sign flips 0.40% and 0.60% of the weights)."""
    jp, tp, jcfg, tcfg = tiny
    j0, t0 = jp, tp
    tp = torch.utils._pytree.tree_map(torch.clone, tp)  # the update is in place
    opt = dict(learning_rate=2e-3, total_steps=5, warmup_steps=2)
    jstep = jmake_train_step(jcfg, JAdamW(**opt), microbatches=microbatches)
    tstep = make_train_step(tcfg, AdamWConfig(**opt), microbatches=microbatches)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    kp, ks, jitted = jp, js, jax.jit(jstep)
    jstream = jtoken_stream(jcfg, JDataConfig(batch_size=4, seq_len=16, seed=3))
    tstream = token_stream(tcfg, DataConfig(batch_size=4, seq_len=16, seed=3), device="cpu")
    port_gap, own_gap = [], []
    for _ in range(5):
        batch = next(jstream)
        with jax.disable_jit():
            jp, js, jm = jstep(jp, js, batch)
        kp, ks, km = jitted(kp, ks, batch)
        tp, ts, tm = tstep(tp, ts, next(tstream))
        want = float(jm["loss"])
        port_gap.append(abs(float(tm["loss"]) - want) / want)
        own_gap.append(abs(float(km["loss"]) - want) / want)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2**-7)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts["step"]) == 5
    print("loss gaps from the op-by-op reference, the port: " + ", ".join(f"{g:.3g}" for g in port_gap)
          + "; the jitted reference: " + ", ".join(f"{g:.3g}" for g in own_gap))
    assert port_gap[0] <= 1e-5
    assert max(own_gap) > 1e-4  # the reference itself does not hold 1e-4
    assert max(port_gap) <= 2 * max(own_gap)
    d_ref = _update(jp, j0)
    d_port, d_own = (np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref)
                     for d in (_update(tp, t0), _update(kp, j0)))
    print(f"the five steps' update, norm-wise from the op-by-op reference's: the port "
          f"{d_port:.3g}, the jitted reference {d_own:.3g}")
    assert d_port <= d_own


def test_loss_decreases(tiny):
    """The reference's test on the port: 30 steps at lr 2e-3."""
    _, params, _, cfg = tiny
    params = torch.utils._pytree.tree_map(torch.clone, params)
    step_fn = make_train_step(cfg, AdamWConfig(learning_rate=2e-3, total_steps=30, warmup_steps=5))
    opt_state = topt.init_opt_state(params)
    stream = token_stream(cfg, DataConfig(batch_size=4, seq_len=32, seed=0), device="cpu")
    losses = []
    for _ in range(30):
        params, opt_state, metrics = step_fn(params, opt_state, next(stream))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert np.isfinite(losses).all()


def test_train_step_metrics_keys(tiny):
    _, params, _, cfg = tiny
    params = torch.utils._pytree.tree_map(torch.clone, params)
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=5))
    stream = token_stream(cfg, DataConfig(batch_size=2, seq_len=16), device="cpu")
    p2, s2, metrics = step_fn(params, topt.init_opt_state(params), next(stream))
    for key in ("loss", "grad_norm", "lr", "final_loss", "moe_aux", "exit_2_loss", "exit_3_loss"):
        assert key in metrics
    assert p2 is params and int(s2["step"]) == 1
    assert all(not t.requires_grad for t in torch.utils._pytree.tree_leaves(p2))


def test_bf16_params_env_matches_reference(tiny, monkeypatch):
    """``REPRO_BF16_PARAMS=1``: the loss runs on a bf16 copy of every
    ``ndim >= 2`` f32 leaf (stacked norm scales and biases included), in
    both packages; one step's loss at rtol 1e-5 and grad norm at 2^-7, and
    the f32 masters stay f32."""
    jp, tp, jcfg, tcfg = tiny
    tp = torch.utils._pytree.tree_map(torch.clone, tp)
    monkeypatch.setenv("REPRO_BF16_PARAMS", "1")
    jstep = jmake_train_step(jcfg, JAdamW(total_steps=5))
    tstep = make_train_step(tcfg, AdamWConfig(total_steps=5))
    jb = next(jtoken_stream(jcfg, JDataConfig(batch_size=2, seq_len=16, seed=5)))
    tb = next(token_stream(tcfg, DataConfig(batch_size=2, seq_len=16, seed=5), device="cpu"))
    with jax.disable_jit():
        _, _, jm = jstep(jp, jopt.init_opt_state(jp), jb)
    tp2, _, tm = tstep(tp, topt.init_opt_state(tp), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2**-7)
    assert all(t.dtype == torch.float32 for t in torch.utils._pytree.tree_leaves(tp2))
