"""Recurrent (DRQN) train steps against plain references.

* the grouped step (one shared window draw, U sequential sub-updates)
  against U sequential ``make_drqn_train_step`` calls on the same windows;
* gradients against ``jax.grad`` of the loss written as a Python loop of
  single-step cell calls (``reference_impl.recurrent_loss``) — the train
  step runs ``apply_sequence``, whose input projection is hoisted out of the
  ``lax.scan``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from deepqlearning_tpu import (
    Chain,
    Dense,
    EpisodeReplayBuffer,
    Flatten,
    create_dueling_network,
)
from deepqlearning_tpu.learner.train_step import (
    make_drqn_train_step,
    make_grouped_drqn_train_step,
)
from deepqlearning_tpu.models.chain import GRU, LSTM
from reference_impl import adam_grads, random_transitions, recurrent_loss

GAMMA = 0.95
KINDS = ["plain", "deep", "dueling", "gru", "gru_dueling"]


def _net(obs_dim, A, kind):
    if kind == "plain":
        return Chain(LSTM(obs_dim, 12), Dense(12, A))
    if kind == "deep":
        return Chain(Flatten(), Dense(obs_dim, 10, jnp.tanh),
                     LSTM(10, 12), Dense(12, 8, jax.nn.relu), Dense(8, A))
    if kind == "dueling":
        return create_dueling_network(
            Chain(LSTM(obs_dim, 12), Dense(12, 8, jnp.tanh), Dense(8, A)))
    if kind == "gru":
        return Chain(GRU(obs_dim, 12), Dense(12, A))
    if kind == "gru_dueling":
        return create_dueling_network(
            Chain(Dense(obs_dim, 10, jnp.tanh), GRU(10, 12),
                  Dense(12, 8, jnp.tanh), Dense(8, A)))
    raise ValueError(kind)


def _episode_buffer(obs_dim, B, T, key, num_envs=8, steps=40):
    """Stream random lockstep transitions; episodes end at random."""
    buf = EpisodeReplayBuffer((obs_dim,), max_size=64, batch_size=B,
                              trace_length=T, max_episode_length=16,
                              num_envs=num_envs)
    st = buf.init()
    for i in range(steps):
        tr = random_transitions(jax.random.fold_in(key, i), num_envs, obs_dim)
        done = jax.random.uniform(jax.random.fold_in(key, 10_000 + i),
                                  (num_envs,)) < 0.25
        st = buf.add_step(st, tr._replace(done=done.astype(jnp.float32)),
                          done)
    return buf, buf.reset_in_progress(st)


class PreDrawn:
    """Stands in for the buffer of ``make_drqn_train_step``: call ``u`` gets
    sub-batch ``u`` of the grouped step's window draw."""

    def __init__(self, buf, batch, U):
        self.batch_size, self.trace_length = buf.batch_size, buf.trace_length
        self.batches = jax.tree_util.tree_map(
            lambda x: x.reshape((U, buf.batch_size) + x.shape[1:]), batch)

    def sample(self, state, u):
        return jax.tree_util.tree_map(lambda x: x[u], self.batches)


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_drqn_equals_sequential_single_steps(kind, double_q):
    obs_dim, A, B, T, U = 5, 4, 8, 6, 3
    net = _net(obs_dim, A, kind)
    buf, st = _episode_buffer(obs_dim, B, T, jax.random.PRNGKey(0))
    params = net.init(jax.random.PRNGKey(1))
    tparams = net.init(jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(3)

    grouped, opt = make_grouped_drqn_train_step(net, buf, GAMMA, double_q,
                                                1e-2, U)
    g = grouped(params, tparams, opt.init(params), st, key)

    fake = PreDrawn(buf, buf.sample_n(st, key, U), U)
    single, _ = make_drqn_train_step(net, fake, GAMMA, double_q, 1e-2)
    p, o = params, opt.init(params)
    for u in range(U):
        r = single(p, tparams, o, None, u)
        p, o = r.params, r.opt_state
    np.testing.assert_allclose(float(g.loss), float(r.loss), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ravel_pytree(g.params)[0],
                               ravel_pytree(p)[0], rtol=1e-5, atol=1e-6)
    assert int(g.opt_state[0].count) == U


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_drqn_gradients_match_python_loop_unroll(kind, double_q):
    obs_dim, A, B, T = 5, 4, 8, 6
    net = _net(obs_dim, A, kind)
    buf, st = _episode_buffer(obs_dim, B, T, jax.random.PRNGKey(4))
    params = net.init(jax.random.PRNGKey(5))
    tparams = net.init(jax.random.PRNGKey(6))
    key = jax.random.PRNGKey(7)
    step, opt = make_drqn_train_step(net, buf, GAMMA, double_q, 1e-3)
    res = step(params, tparams, opt.init(params), st, key)

    batch = buf.sample(st, key)
    assert float(batch.mask.sum()) > 0
    ref_loss, ref_grads = jax.value_and_grad(recurrent_loss, argnums=1)(
        net, params, tparams, batch, GAMMA, double_q)
    np.testing.assert_allclose(float(res.loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(adam_grads(res.opt_state),
                               ravel_pytree(ref_grads)[0], rtol=1e-4,
                               atol=1e-7)
