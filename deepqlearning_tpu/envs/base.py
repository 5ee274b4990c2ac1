"""Functional environment protocol.

The reference consumes environments through CommonRLInterface's mutable
``reset!/observe/act!/terminated/actions`` (``src/DeepQLearning.jl:15``) and
adapts POMDPs.jl problems onto it (``src/solver.jl:31,36``). Here
environments are instead *pure functions over pytrees* so thousands of
instances step in lockstep under ``vmap`` inside one jitted program:

    env.reset(key)               -> (state, obs)
    env.step(state, action, key) -> (state, obs, reward, done)

``state`` is any pytree of fixed-shape arrays; ``obs`` is a float array of
shape ``env.obs_shape``; ``action`` is an int32 index into
``env.action_map``. No method mutates anything.

For arbitrary host-side (non-jittable) environments, see
``deepqlearning_tpu.envs.compat.HostEnv`` — the analog of the reference's
raw ``CommonRLInterface.AbstractEnv`` path (``test/runtests.jl:199-234``).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp


class Env:
    """Base class for pure-functional environments.

    Subclasses must be immutable (static config only) and define:
      * ``num_actions: int``
      * ``obs_shape: tuple``
      * ``discount: float``  (reference ``default_discount``, ``src/helpers.jl:83-85``)
      * ``reset(key) -> (state, obs)``
      * ``step(state, action, key) -> (state, obs, reward, done)``
    Optionally ``action_map`` — the user-facing action objects, mirroring the
    reference's ``action_map`` built from ``actions(env)`` (``src/solver.jl:41``).
    """

    num_actions: int
    obs_shape: Tuple[int, ...]
    discount: float = 1.0

    @property
    def action_map(self) -> Sequence[Any]:
        return list(range(self.num_actions))

    def reset(self, key):
        raise NotImplementedError

    def step(self, state, action, key):
        raise NotImplementedError

    # --- vectorized conveniences -------------------------------------
    def reset_batch(self, key, num: int):
        """Reset ``num`` independent instances (vmapped)."""
        keys = jax.random.split(key, num)
        return jax.vmap(self.reset)(keys)

    def step_batch(self, states, actions, key):
        keys = jax.random.split(key, actions.shape[0])
        return jax.vmap(self.step)(states, actions, keys)

    def observe(self, state):
        """Observation of a state, when derivable without stepping.

        Default: subclasses that return obs from reset/step only may omit it.
        """
        raise NotImplementedError


def auto_reset(env: Env, state, obs, done, truncate, key):
    """Where an episode ended, replace (state, obs) with a fresh reset.

    The reference resets the single env on ``done || step >= max_episode_length``
    (``src/solver.jl:99-132``). Under vmap we select per-row: re-init every row
    and keep the old one where the episode continues (XLA fuses the select;
    re-init of cheap envs is negligible and keeps shapes static).
    """
    ended = jnp.logical_or(done, truncate)
    keys = jax.random.split(key, done.shape[0])
    fresh_state, fresh_obs = jax.vmap(env.reset)(keys)

    def pick(a, b):
        mask = ended.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(mask, a, b)

    new_state = jax.tree_util.tree_map(pick, fresh_state, state)
    new_obs = pick(fresh_obs, obs)
    return new_state, new_obs, ended
