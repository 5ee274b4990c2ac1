"""MDP/POMDP problem adapters.

The reference accepts POMDPs.jl problems and wraps them into envs
(``MDPCommonRLEnv``/``POMDPCommonRLEnv``, ``src/solver.jl:30-38``), converting
states/observations to float arrays via ``convert_s``/``convert_o``
(``src/policy.jl:66-76``). The functional analog: a *problem* is a small
object of pure functions, and ``MDPEnv``/``POMDPEnv`` adapt it onto the
functional ``Env`` protocol so it runs vectorized under jit like any other
env.

A FunctionalMDP must provide:
  * ``initial_state(key) -> state``            (pytree)
  * ``gen(state, action, key) -> next_state``  (transition sample)
  * ``reward(state, action, next_state) -> float``
  * ``isterminal(state) -> bool``
  * ``convert_s(state) -> float array``        (NN input)
  * ``num_actions``, ``discount``; optionally ``action_map``.

A FunctionalPOMDP additionally provides
  * ``observation(state, action, next_state, key) -> obs_pytree``
  * ``convert_o(obs) -> float array``
and the env observes ``convert_o(obs)`` instead of the state.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Env


def check_requirements(problem, pomdp: bool = False):
    """Requirements linter — the analog of the reference's
    ``@POMDP_require`` block (``src/solver.jl:320-335``): verify the problem
    implements the interface ``solve`` needs, and raise a readable error
    listing anything missing.
    """
    required = ["initial_state", "gen", "reward", "isterminal"]
    required.append("convert_o" if pomdp else "convert_s")
    if pomdp:
        required.append("observation")
    attrs = ["num_actions", "discount"]
    missing = [m for m in required if not callable(getattr(problem, m, None))]
    missing += [a for a in attrs if not hasattr(problem, a)]
    if missing:
        raise TypeError(
            f"{type(problem).__name__} does not satisfy the "
            f"{'POMDP' if pomdp else 'MDP'} interface; missing: "
            + ", ".join(missing)
        )


class MDPEnv(Env):
    """Adapter: FunctionalMDP problem → Env (``MDPCommonRLEnv`` analog)."""

    def __init__(self, problem):
        self.problem = problem
        self.num_actions = int(problem.num_actions)
        self.discount = float(problem.discount)
        dummy_state = problem.initial_state(jax.random.PRNGKey(0))
        self.obs_shape = tuple(jnp.shape(problem.convert_s(dummy_state)))

    @property
    def action_map(self):
        if hasattr(self.problem, "action_map"):
            return list(self.problem.action_map)
        return list(range(self.num_actions))

    def observe(self, state):
        return jnp.asarray(self.problem.convert_s(state), jnp.float32)

    def reset(self, key):
        state = self.problem.initial_state(key)
        return state, self.observe(state)

    def step(self, state, action, key):
        sp = self.problem.gen(state, action, key)
        r = jnp.asarray(self.problem.reward(state, action, sp), jnp.float32)
        done = self.problem.isterminal(sp)
        return sp, self.observe(sp), r, done


class POMDPEnv(Env):
    """Adapter: FunctionalPOMDP problem → Env (``POMDPCommonRLEnv`` analog).

    Env state is ``(hidden_state, last_obs_array)``; the agent sees only
    ``convert_o`` of the sampled observation.
    """

    def __init__(self, problem):
        self.problem = problem
        self.num_actions = int(problem.num_actions)
        self.discount = float(problem.discount)
        k = jax.random.PRNGKey(0)
        s0 = problem.initial_state(k)
        o0 = problem.initial_obs(s0) if hasattr(problem, "initial_obs") else (
            problem.observation(s0, jnp.asarray(0), s0, k)
        )
        self.obs_shape = tuple(jnp.shape(problem.convert_o(o0)))

    @property
    def action_map(self):
        if hasattr(self.problem, "action_map"):
            return list(self.problem.action_map)
        return list(range(self.num_actions))

    def observe(self, state):
        return state[1]

    def reset(self, key):
        ks, ko = jax.random.split(key)
        s = self.problem.initial_state(ks)
        o = self.problem.initial_obs(s) if hasattr(self.problem, "initial_obs") else (
            self.problem.observation(s, jnp.asarray(0), s, ko)
        )
        obs = jnp.asarray(self.problem.convert_o(o), jnp.float32)
        return (s, obs), obs

    def step(self, state, action, key):
        s, _ = state
        kg, ko = jax.random.split(key)
        sp = self.problem.gen(s, action, kg)
        o = self.problem.observation(s, action, sp, ko)
        obs = jnp.asarray(self.problem.convert_o(o), jnp.float32)
        r = jnp.asarray(self.problem.reward(s, action, sp), jnp.float32)
        done = self.problem.isterminal(sp)
        return (sp, obs), obs, r, done
