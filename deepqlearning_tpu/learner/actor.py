"""Vectorized actor: lockstep env stepping + replay insertion under jit.

Replaces the reference's single-threaded host loop body
(``src/solver.jl:82-99``: ε-greedy act → env step → DQExperience →
``add_exp!`` → episode bookkeeping) with a ``lax.scan`` over E vmapped envs.
Episode-return accounting for the "avg of last ~100 episodes" log metric
(``src/solver.jl:134``) is kept device-side in a small ring.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..envs.base import auto_reset
from ..replay.transition import TransitionBatch

# Ring of per-lockstep-step episode-completion aggregates for the recent-
# average log metric (the reference's "mean of last ~100 episodes",
# src/solver.jl:134). Aggregating per step instead of per episode keeps the
# bookkeeping one 1-element update per ring instead of an [E]-wide scatter
# into per-episode slots.
RETURN_RING = 512


class ActorState(NamedTuple):
    env_state: any
    obs: jnp.ndarray        # [E, *obs_shape]
    net_state: any          # recurrent net state for the E actor streams
    ep_step: jnp.ndarray    # [E] int32 — steps in current episode
    ep_ret: jnp.ndarray     # [E] float32 — return of current episode
    ret_ring: jnp.ndarray   # [RETURN_RING] f32 — per-step sums of ended-episode returns
    ep_count: jnp.ndarray   # int32 — total completed episodes
    step_ring: jnp.ndarray  # [RETURN_RING] f32 — per-step sums of ended-episode lengths
    cnt_ring: jnp.ndarray   # [RETURN_RING] f32 — per-step counts of ended episodes
    tick: jnp.ndarray       # int32 — lockstep step index mod RETURN_RING
    t: jnp.ndarray          # int32 — aggregate env steps so far
    key: jnp.ndarray


def init_actor(env, network, num_envs: int, key) -> ActorState:
    k_env, k_run = jax.random.split(key)
    env_state, obs = env.reset_batch(k_env, num_envs)
    return ActorState(
        env_state=env_state,
        obs=obs,
        net_state=network.init_state(num_envs),
        ep_step=jnp.zeros((num_envs,), jnp.int32),
        ep_ret=jnp.zeros((num_envs,), jnp.float32),
        ret_ring=jnp.zeros((RETURN_RING,), jnp.float32),
        ep_count=jnp.asarray(0, jnp.int32),
        step_ring=jnp.zeros((RETURN_RING,), jnp.float32),
        cnt_ring=jnp.zeros((RETURN_RING,), jnp.float32),
        tick=jnp.asarray(0, jnp.int32),
        t=jnp.asarray(0, jnp.int32),
        key=k_run,
    )


def make_collect_step(env, network, max_episode_length: int, eps_fn,
                      insert_fn, select_fn=None):
    """Build one lockstep env-step:

    ``eps_fn(t) -> eps`` is the exploration schedule (jit-friendly);
    ``select_fn(q [E, A], t, key) -> (actions [E], eps)`` is the exploration
    strategy (the jit-traceable vectorized-strategy protocol,
    ``solver/exploration.py``) — defaults to ε-greedy over ``eps_fn``;
    ``insert_fn(replay_state, transition_batch, ended) -> replay_state``
    commits transitions (feed-forward ring insert or episode accumulate).
    Returns ``step((actor, replay, params), None) -> ((actor, replay, params), None)``
    suitable for ``lax.scan``.
    """
    if select_fn is None:
        from ..solver.exploration import epsilon_greedy_select

        select_fn = epsilon_greedy_select(eps_fn)

    def step(carry, _):
        actor, replay, params = carry
        num_envs = actor.obs.shape[0]
        key, k_sel, k_step, k_reset = jax.random.split(actor.key, 4)

        # exploration action from the online net's Q-values
        # (src/solver.jl:83, policy.jl:38-46)
        q, net_state = network.apply(params, actor.obs, actor.net_state)
        action, _eps = select_fn(q, actor.t, k_sel)
        action = action.astype(jnp.int32)

        env_state, next_obs, reward, done = env.step_batch(
            actor.env_state, action, k_step
        )
        done_f = done.astype(jnp.float32)
        truncate = (actor.ep_step + 1) >= max_episode_length
        ended = jnp.logical_or(done, truncate)

        transition = TransitionBatch(
            obs=actor.obs, action=action, reward=reward,
            next_obs=next_obs, done=done_f,
        )
        replay = insert_fn(replay, transition, ended)

        # episode bookkeeping (src/solver.jl:99-134): write this step's
        # completion aggregates into one ring slot (a 1-element update each)
        ep_ret = actor.ep_ret + reward
        ep_step = actor.ep_step + 1
        ended_f = ended.astype(jnp.float32)
        n_end = jnp.sum(ended.astype(jnp.int32))
        slot = actor.tick

        def put1(ring, val):
            return jax.lax.dynamic_update_slice(
                ring, val.reshape((1,)).astype(jnp.float32), (slot,)
            )

        ret_ring = put1(actor.ret_ring, jnp.sum(ep_ret * ended_f))
        step_ring = put1(actor.step_ring,
                         jnp.sum(ep_step.astype(jnp.float32) * ended_f))
        cnt_ring = put1(actor.cnt_ring, n_end.astype(jnp.float32))

        # reset ended streams: env, episode stats, and recurrent state
        # (resetstate! parity, src/solver.jl:128)
        env_state, obs, _ = auto_reset(env, env_state, next_obs, done, truncate, k_reset)
        net_state = jax.tree_util.tree_map(
            lambda s: jnp.where(
                ended.reshape((-1,) + (1,) * (s.ndim - 1)), jnp.zeros_like(s), s
            ),
            net_state,
        )
        actor = ActorState(
            env_state=env_state,
            obs=obs,
            net_state=net_state,
            ep_step=jnp.where(ended, 0, ep_step),
            ep_ret=jnp.where(ended, 0.0, ep_ret),
            ret_ring=ret_ring,
            ep_count=actor.ep_count + n_end,
            step_ring=step_ring,
            cnt_ring=cnt_ring,
            tick=(actor.tick + 1) % RETURN_RING,
            # saturating counter: t only feeds the ε schedule (which is flat
            # past its horizon), so cap it instead of overflowing int32 —
            # at headline throughput 2^31 steps is minutes of wall time
            t=jnp.minimum(actor.t + num_envs, jnp.asarray(1 << 30, jnp.int32)),
            key=key,
        )
        return (actor, replay, params), None

    return step


def avg_recent(ret_ring: jnp.ndarray, cnt_ring: jnp.ndarray) -> jnp.ndarray:
    """Mean return over episodes completed in the last RETURN_RING lockstep
    steps (the recent-average analog of the reference's mean-of-last-~100-
    episodes log metric, src/solver.jl:134)."""
    return jnp.sum(ret_ring) / jnp.maximum(jnp.sum(cnt_ring), 1.0)
