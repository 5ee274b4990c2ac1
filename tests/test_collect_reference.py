"""The XLA collect step and the env dynamics against step-by-step references.

The collect step (act, env step, replay insert, episode bookkeeping) is
replayed by hand from the same keys: numpy ε-greedy over the network's
Q-values, the env's own step, and the replay rows decoded afterwards. The
env dynamics are checked against numpy transcriptions of their laws."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepqlearning_tpu import (
    CartPole,
    Chain,
    Dense,
    MountainCar,
    PrioritizedReplayBuffer,
    SimpleGridWorld,
)
from deepqlearning_tpu.learner.actor import init_actor, make_collect_step
from deepqlearning_tpu.models.chain import GRU, LSTM

EPS, MAX_LEN = 0.5, 4


def _nets(kind, A):
    if kind == "ff":
        return Chain(Dense(2, 8, jnp.tanh), Dense(8, A))
    cell = LSTM(2, 6) if kind == "lstm" else GRU(2, 6)
    return Chain(cell, Dense(6, A))


@pytest.mark.parametrize("kind", ["ff", "lstm", "gru"])
def test_collect_step_matches_step_by_step_reference(kind):
    env = SimpleGridWorld()
    E, A = 16, env.num_actions
    net = _nets(kind, A)
    params = net.init(jax.random.PRNGKey(0))
    buf = PrioritizedReplayBuffer(env.obs_shape, 64, 8)
    collect = make_collect_step(env, net, MAX_LEN, lambda t: jnp.asarray(EPS),
                                lambda r, tr, e: buf.insert(r, tr))
    actor = init_actor(env, net, E, jax.random.PRNGKey(1))
    replay = buf.init()
    ep_ref = np.zeros(E, np.int32)
    for step in range(MAX_LEN + 2):       # crosses a truncation
        key, k_sel, k_step, k_reset = jax.random.split(actor.key, 4)
        q, ns = net.apply(params, actor.obs, actor.net_state)
        k_u, k_a = jax.random.split(k_sel)
        explore = np.asarray(jax.random.uniform(k_u, (E,))) < EPS
        rand = np.asarray(jax.random.randint(k_a, (E,), 0, A))
        a = np.where(explore, rand, np.argmax(np.asarray(q), -1))
        _, next_obs, r, done = env.step_batch(actor.env_state,
                                              jnp.asarray(a, jnp.int32),
                                              k_step)
        ended = np.asarray(done) | (ep_ref + 1 >= MAX_LEN)
        pos = int(replay.insert_pos)
        obs0 = np.asarray(actor.obs)

        (actor, replay, _), _ = collect((actor, replay, params), None)

        rows = np.asarray(replay.rows[pos:pos + E])
        sc = np.asarray(buf.peek_scalars(replay))[pos:pos + E]
        np.testing.assert_array_equal(rows[:, :2], obs0)
        np.testing.assert_array_equal(rows[:, 2:4], np.asarray(next_obs))
        np.testing.assert_array_equal(sc[:, 0], a)
        np.testing.assert_array_equal(sc[:, 1], np.asarray(r))
        np.testing.assert_array_equal(sc[:, 2], np.asarray(done, np.float32))
        # bookkeeping: ended streams restart, others count on
        ep_ref = np.where(ended, 0, ep_ref + 1)
        np.testing.assert_array_equal(np.asarray(actor.ep_step), ep_ref)
        # recurrent state: the cell's new state, zeroed where episodes ended
        for got, want in zip(jax.tree_util.tree_leaves(actor.net_state),
                             jax.tree_util.tree_leaves(ns)):
            want = np.where(ended[:, None], 0.0, np.asarray(want))
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)
        assert int(actor.t) == E * (step + 1)


def test_gridworld_step_matches_numpy():
    env = SimpleGridWorld()
    cells = {(4, 3): -10.0, (4, 6): -5.0, (9, 3): 10.0, (8, 8): 3.0}
    dirs = [(0, 1), (0, -1), (-1, 0), (1, 0)]
    rng = np.random.default_rng(0)
    n = 512
    pos = rng.integers(1, 11, size=(n, 2)).astype(np.int32)
    pos[:8] = [(4, 3), (4, 6), (9, 3), (8, 8), (1, 1), (10, 10), (1, 10),
               (10, 1)]
    term = rng.random(n) < 0.1
    act = rng.integers(0, 4, size=n).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    from deepqlearning_tpu.envs.gridworld import GridWorldState

    st, obs, r, done = jax.vmap(env.step)(
        GridWorldState(jnp.asarray(pos), jnp.asarray(term)),
        jnp.asarray(act), keys)
    for i in range(n):
        ku, kd = jax.random.split(keys[i])
        u = float(jax.random.uniform(ku))
        other = int(jax.random.randint(kd, (), 0, 3))
        other = other + 1 if other >= act[i] else other
        d = act[i] if u < env.tprob else other
        cell_r = cells.get(tuple(pos[i]), 0.0)
        want_r = 0.0 if term[i] else cell_r
        absorbed = term[i] or cell_r != 0.0
        new = pos[i] if absorbed else np.clip(pos[i] + dirs[d], 1, 10)
        want_obs = (-1.0, -1.0) if absorbed else tuple(new)
        assert float(r[i]) == want_r
        assert bool(done[i]) == absorbed
        np.testing.assert_array_equal(np.asarray(st.pos[i]), new)
        np.testing.assert_array_equal(np.asarray(obs[i]), want_obs)


def test_cartpole_step_matches_numpy():
    env = CartPole()
    rng = np.random.default_rng(1)
    n = 256
    s = rng.uniform(-0.3, 0.3, size=(n, 4))
    s[:4, 0] = [2.39, -2.39, 0.0, 0.0]
    s[:4, 1] = [1.0, -1.0, 0.0, 0.0]
    s[:4, 2] = [0.0, 0.0, 0.2, -0.2]
    act = rng.integers(0, 2, size=n)
    from deepqlearning_tpu.envs.cartpole import CartPoleState

    st32 = CartPoleState(*[jnp.asarray(s[:, j], jnp.float32)
                           for j in range(4)])
    new, obs, r, done = jax.vmap(env.step)(
        st32, jnp.asarray(act), jax.random.split(jax.random.PRNGKey(0), n))
    x, xd, th, thd = (np.asarray(c, np.float64) for c in st32)
    g, mc, mp, l, fm, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    f = np.where(act == 1, fm, -fm)
    c, sn = np.cos(th), np.sin(th)
    temp = (f + mp * l * thd ** 2 * sn) / (mc + mp)
    tha = (g * sn - c * temp) / (l * (4.0 / 3.0 - mp * c ** 2 / (mc + mp)))
    xa = temp - mp * l * tha * c / (mc + mp)
    want = np.stack([x + tau * xd, xd + tau * xa, th + tau * thd,
                     thd + tau * tha], 1)
    np.testing.assert_allclose(np.asarray(obs), want, rtol=1e-5, atol=1e-6)
    want_done = (np.abs(want[:, 0]) > 2.4) | (np.abs(want[:, 2]) >
                                              12 * 2 * math.pi / 360)
    np.testing.assert_array_equal(np.asarray(done), want_done)
    assert want_done.any() and not want_done.all()
    np.testing.assert_array_equal(np.asarray(r), 1.0)


def test_mountain_car_step_matches_numpy():
    env = MountainCar()
    rng = np.random.default_rng(2)
    n = 256
    pos = rng.uniform(-1.2, 0.6, size=n)
    vel = rng.uniform(-0.07, 0.07, size=n)
    pos[:3], vel[:3] = [-1.2, 0.49, 0.0], [-0.05, 0.07, 0.07]
    act = rng.integers(0, 3, size=n)
    from deepqlearning_tpu.envs.mountain_car import MountainCarState

    st32 = MountainCarState(jnp.asarray(pos, jnp.float32),
                            jnp.asarray(vel, jnp.float32))
    new, obs, r, done = jax.vmap(env.step)(
        st32, jnp.asarray(act), jax.random.split(jax.random.PRNGKey(0), n))
    p0, v0 = (np.asarray(c, np.float64) for c in st32)
    v = np.clip(v0 + (act - 1.0) * 0.001 - np.cos(3.0 * p0) * 0.0025,
                -0.07, 0.07)
    p = np.clip(p0 + v, -1.2, 0.6)
    v = np.where((p <= -1.2) & (v < 0.0), 0.0, v)
    np.testing.assert_allclose(np.asarray(obs), np.stack([p, v], 1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(done), p >= 0.5)
    assert (p >= 0.5).any()
    np.testing.assert_array_equal(np.asarray(r), -1.0)
