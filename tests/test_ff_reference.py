"""Feed-forward train steps against plain references.

* the grouped step (one shared draw, U sequential sub-updates, one merged
  priority update) against U sequential ``make_dqn_train_step`` calls on the
  same sub-batches;
* gradients against central finite differences of a float64 numpy loss;
* TD loss, TD errors, IS weights and priorities against numpy;
* the gradient of a linear Q-net against its closed form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from deepqlearning_tpu import (
    Chain,
    Dense,
    Flatten,
    PrioritizedReplayBuffer,
    create_dueling_network,
)
from deepqlearning_tpu.learner.train_step import (
    make_dqn_train_step,
    make_grouped_dqn_train_step,
)
from deepqlearning_tpu.ops import sumtree
from reference_impl import adam_grads, np_td, random_transitions

GAMMA, ALPHA, EPS = 0.95, 0.6, 1e-3


def _net(obs_dim, A, dueling):
    chain = Chain(Flatten(), Dense(obs_dim, 12, jnp.tanh),
                  Dense(12, 12, jax.nn.relu), Dense(12, A))
    return create_dueling_network(chain) if dueling else chain


def _buffer(obs_dim, B, A, n=64, beta=0.4, key=0):
    buf = PrioritizedReplayBuffer((obs_dim,), n, B, alpha=ALPHA, beta=beta,
                                  eps=EPS, prioritized=True)
    st = buf.insert(buf.init(),
                    random_transitions(jax.random.PRNGKey(key), n, obs_dim, A))
    return buf, st


class PreDrawn:
    """Stands in for the buffer of ``make_dqn_train_step``: call ``u`` gets
    sub-batch ``u`` of the grouped step's draw, and the priorities it would
    write are collected instead of applied."""

    def __init__(self, buf, batch, idx, w, U):
        self.batch_size, self.no = buf.batch_size, buf.no
        de = lambda x: x.reshape((U, buf.batch_size) + x.shape[1:])
        self.batches = jax.tree_util.tree_map(de, batch)
        self.idx, self.w = de(idx), de(w)

    def sample(self, state, u):
        return (jax.tree_util.tree_map(lambda x: x[u], self.batches),
                self.idx[u], self.w[u])

    def update_priorities(self, state, idx, td):
        return state + ((jnp.abs(td) + EPS) ** ALPHA,)


@pytest.mark.parametrize("U", [1, 4])
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("dueling", [True, False])
def test_grouped_step_equals_sequential_single_steps(dueling, double_q, U):
    obs_dim, A, B = 5, 4, 8
    net = _net(obs_dim, A, dueling)
    buf, st = _buffer(obs_dim, B, A)
    params = net.init(jax.random.PRNGKey(1))
    tparams = net.init(jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(3)

    grouped, opt = make_grouped_dqn_train_step(net, buf, GAMMA, double_q,
                                               1e-2, U)
    g = grouped(params, tparams, opt.init(params), st, key)

    batch, idx, w = buf.sample_n(st, key, U)
    fake = PreDrawn(buf, batch, idx, w, U)
    single, _ = make_dqn_train_step(net, fake, GAMMA, double_q, 1e-2)
    p, o, prios = params, opt.init(params), ()
    for u in range(U):
        r = single(p, tparams, o, prios, u)
        p, o, prios = r.params, r.opt_state, r.replay_state

    np.testing.assert_allclose(float(g.loss), float(r.loss), rtol=1e-5)
    np.testing.assert_allclose(ravel_pytree(g.params)[0],
                               ravel_pytree(p)[0], rtol=1e-5, atol=1e-6)
    assert int(g.opt_state[0].count) == U
    # merged priority update == the sequential writes, last write winning
    want = sumtree.set_priorities(st.tree, idx, jnp.concatenate(prios))
    np.testing.assert_allclose(np.asarray(g.replay_state.tree[0]),
                               np.asarray(want[0]), rtol=1e-5)


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("dueling", [True, False])
def test_gradients_match_finite_differences(dueling, double_q):
    obs_dim, A, B = 3, 3, 16
    net = _net(obs_dim, A, dueling)
    buf, st = _buffer(obs_dim, B, A, key=4)
    params = net.init(jax.random.PRNGKey(5))
    tparams = net.init(jax.random.PRNGKey(6))
    key = jax.random.PRNGKey(7)
    step, opt = make_dqn_train_step(net, buf, GAMMA, double_q, 1e-3)
    res = step(params, tparams, opt.init(params), st, key)
    grads = adam_grads(res.opt_state)

    batch, _, w = buf.sample(st, key)
    theta = np.asarray(ravel_pytree(params)[0], np.float64)
    leaves, tdef = jax.tree_util.tree_flatten(params)   # ravel_pytree order

    def loss(t):
        out, off = [], 0
        for leaf in leaves:
            out.append(t[off:off + leaf.size].reshape(leaf.shape))
            off += leaf.size
        return np_td(net, jax.tree_util.tree_unflatten(tdef, out), tparams,
                     batch, w, GAMMA, double_q)[0]

    h = 1e-6
    fd = np.array([(loss(theta + h * e) - loss(theta - h * e)) / (2 * h)
                   for e in np.eye(theta.size)])
    np.testing.assert_allclose(grads, fd, rtol=1e-3, atol=2e-5)


def test_adam_count_drives_bias_correction():
    obs_dim, A, B, U = 3, 2, 8, 3
    net = Chain(Dense(obs_dim, 8, jnp.tanh), Dense(8, A))
    buf, st = _buffer(obs_dim, B, A, n=32, key=8)
    params = net.init(jax.random.PRNGKey(9))
    step, opt = make_grouped_dqn_train_step(net, buf, 0.9, True, 1e-2, U)
    r1 = step(params, params, opt.init(params), st, jax.random.PRNGKey(10))
    assert int(r1.opt_state[0].count) == U
    r2 = step(r1.params, params, r1.opt_state, r1.replay_state,
              jax.random.PRNGKey(11))
    assert int(r2.opt_state[0].count) == 2 * U
    # the count persists across calls: a reset count changes the update
    reset = r1.opt_state[0]._replace(count=jnp.zeros_like(
        r1.opt_state[0].count))
    r2b = step(r1.params, params, (reset,) + tuple(r1.opt_state[1:]),
               r1.replay_state, jax.random.PRNGKey(11))
    assert not np.allclose(ravel_pytree(r2.params)[0],
                           ravel_pytree(r2b.params)[0])


@pytest.mark.parametrize("is_weights", [True, False])
@pytest.mark.parametrize("double_q", [True, False])
def test_td_loss_errors_weights_priorities_match_numpy(double_q, is_weights):
    obs_dim, A, B, n = 4, 3, 32, 64
    net = _net(obs_dim, A, dueling=True)
    # beta = 0 turns the IS weights into ones while priorities still update
    buf, st = _buffer(obs_dim, B, A, n=n, beta=0.4 if is_weights else 0.0,
                      key=12)
    params = net.init(jax.random.PRNGKey(13))
    tparams = net.init(jax.random.PRNGKey(14))
    key = jax.random.PRNGKey(15)
    step, opt = make_dqn_train_step(net, buf, GAMMA, double_q, 1e-3)
    res = step(params, tparams, opt.init(params), st, key)

    batch, idx, w = buf.sample(st, key)
    leaves = np.asarray(st.tree[0], np.float64)
    want_w = (n * leaves[np.asarray(idx)] / leaves.sum()) ** (
        -buf.beta)
    np.testing.assert_allclose(np.asarray(w), want_w, rtol=1e-5)
    if not is_weights:
        np.testing.assert_array_equal(np.asarray(w), 1.0)

    loss, td = np_td(net, params, tparams, batch, w, GAMMA, double_q)
    np.testing.assert_allclose(float(res.loss), loss, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(res.replay_state.tree[0])[np.asarray(idx)],
        (np.abs(td) + EPS) ** ALPHA, rtol=1e-5)


def test_linear_q_gradient_matches_closed_form():
    # Q = x W + b, max target: dL/dW = sum_i clip(w_i td_i, -1, 1) w_i
    # x_i e_{a_i}^T / B (targets are constants), likewise for b
    obs_dim, A, B = 4, 3, 16
    net = Chain(Dense(obs_dim, A))
    buf, st = _buffer(obs_dim, B, A, key=16)
    params = net.init(jax.random.PRNGKey(17))
    tparams = net.init(jax.random.PRNGKey(18))
    key = jax.random.PRNGKey(19)
    step, opt = make_dqn_train_step(net, buf, GAMMA, False, 1e-3)
    res = step(params, tparams, opt.init(params), st, key)

    batch, _, w = buf.sample(st, key)
    _, td = np_td(net, params, tparams, batch, w, GAMMA, False)
    w = np.asarray(w, np.float64)
    coef = np.clip(w * td, -1.0, 1.0) * w / B
    onehot = np.eye(A)[np.asarray(batch.action)]
    x = np.asarray(batch.obs, np.float64)
    gW = x.T @ (coef[:, None] * onehot)
    gb = (coef[:, None] * onehot).sum(0)
    g = ravel_pytree(params)[1](
        jnp.asarray(adam_grads(res.opt_state), jnp.float32))
    np.testing.assert_allclose(np.asarray(g[0]["w"]), gW, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(g[0]["b"]), gb, rtol=1e-4,
                               atol=1e-6)
