"""The grouped train steps under a 4-device ``data`` axis against a plain
reference: per sub-update, the mean over shards of each shard's own
gradient, then one Adam step. Runs on 4 of the session's virtual CPU
devices (``tests/conftest.py``)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from deepqlearning_tpu import (
    Chain,
    Dense,
    EpisodeReplayBuffer,
    Flatten,
    PrioritizedReplayBuffer,
    create_dueling_network,
)
from deepqlearning_tpu.learner.train_step import (
    make_grouped_dqn_train_step,
    make_grouped_drqn_train_step,
    make_optimizer,
)
from deepqlearning_tpu.models.chain import LSTM
from reference_impl import random_transitions, recurrent_loss, td_loss

D, U, GAMMA, LR = 4, 2, 0.95, 1e-2


def _run_dp(step, params, tparams, opt_state, states, keys):
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("d",))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P("d"), P("d")), out_specs=P("d"),
             check_vma=False)
    def one(p, tp, o, s, k):
        s = jax.tree_util.tree_map(lambda x: x[0], s)
        res = step(p, tp, o, s, k[0])
        return jax.tree_util.tree_map(lambda x: x[None], res.params)

    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    return one(params, tparams, opt_state, stacked, keys)


def _reference(grad_fn, params, draws):
    """``draws[d][u]`` is shard d's sub-batch u; mean grads, Adam."""
    opt = make_optimizer(LR)
    o = opt.init(params)
    for u in range(U):
        grads = [grad_fn(params, draws[d][u]) for d in range(D)]
        g = jax.tree_util.tree_map(lambda *gs: sum(gs) / D, *grads)
        upd, o = opt.update(g, o, params)
        params = optax.apply_updates(params, upd)
    return params


def _check(dp_params, ref_params):
    for got, want in zip(jax.tree_util.tree_leaves(dp_params),
                         jax.tree_util.tree_leaves(ref_params)):
        for d in range(D):   # every device applied the same averaged update
            np.testing.assert_allclose(np.asarray(got[d]), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_grouped_ff_dp_step_is_mean_of_shard_grads():
    obs_dim, A, B, n = 5, 4, 8, 64
    net = create_dueling_network(Chain(Flatten(), Dense(obs_dim, 16, jnp.tanh),
                                       Dense(16, A)))
    buf = PrioritizedReplayBuffer((obs_dim,), n, B)
    states = [buf.insert(buf.init(), random_transitions(
        jax.random.PRNGKey(10 + d), n, obs_dim, A)) for d in range(D)]
    keys = jax.random.split(jax.random.PRNGKey(7), D)
    params = net.init(jax.random.PRNGKey(1))
    tparams = net.init(jax.random.PRNGKey(2))
    step, opt = make_grouped_dqn_train_step(net, buf, GAMMA, True, LR, U,
                                            axis_name="d")
    dp = _run_dp(step, params, tparams, opt.init(params), states, keys)

    draws = []
    for d in range(D):
        batch, _, w = buf.sample_n(states[d], keys[d], U)
        de = lambda x: x.reshape((U, B) + x.shape[1:])
        bu, wu = jax.tree_util.tree_map(de, batch), de(w)
        draws.append([(jax.tree_util.tree_map(lambda x: x[u], bu), wu[u])
                      for u in range(U)])
    grad_fn = lambda p, bw: jax.grad(td_loss, argnums=1)(
        net, p, tparams, bw[0], bw[1], GAMMA, True)
    _check(dp, _reference(grad_fn, params, draws))


def test_grouped_drqn_dp_step_is_mean_of_shard_grads():
    obs_dim, A, B, T = 3, 4, 4, 5
    net = Chain(LSTM(obs_dim, 8), Dense(8, A))
    buf = EpisodeReplayBuffer((obs_dim,), max_size=32, batch_size=B,
                              trace_length=T, max_episode_length=8,
                              num_envs=4)
    states = []
    for d in range(D):
        st = buf.init()
        for i in range(20):
            k = jax.random.fold_in(jax.random.PRNGKey(100 + d), i)
            tr = random_transitions(k, 4, obs_dim, A)
            done = tr.done > 0
            st = buf.add_step(st, tr, done)
        states.append(buf.reset_in_progress(st))
    keys = jax.random.split(jax.random.PRNGKey(8), D)
    params = net.init(jax.random.PRNGKey(3))
    tparams = net.init(jax.random.PRNGKey(4))
    step, opt = make_grouped_drqn_train_step(net, buf, GAMMA, True, LR, U,
                                             axis_name="d")
    dp = _run_dp(step, params, tparams, opt.init(params), states, keys)

    draws = []
    for d in range(D):
        bu = jax.tree_util.tree_map(
            lambda x: x.reshape((U, B) + x.shape[1:]),
            buf.sample_n(states[d], keys[d], U))
        draws.append([jax.tree_util.tree_map(lambda x: x[u], bu)
                      for u in range(U)])
    grad_fn = lambda p, b: jax.grad(recurrent_loss, argnums=1)(
        net, p, tparams, b, GAMMA, True)
    _check(dp, _reference(grad_fn, params, draws))
