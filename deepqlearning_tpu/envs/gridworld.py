"""SimpleGridWorld — functional port of POMDPModels.SimpleGridWorld semantics.

This is the reference README headline problem (``README.md:34-50``) and the
DRQN test env (``test/runtests.jl:131-147``). Semantics (POMDPModels):
10x10 grid, actions up/down/left/right, intended move with prob ``tprob=0.7``
else uniformly one of the other three directions, off-grid moves stay put.
Reward cells {(4,3):-10, (4,6):-5, (9,3):+10, (8,8):+3} (1-indexed); taking
any action in a reward cell yields its reward and transitions to an
absorbing terminal state. Discount 0.95. Observation = the (x, y)
coordinates as float32, matching ``convert_s`` for the README's
``Dense(2, 32)`` input layer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.lookup import take0
from .base import Env

# (dx, dy) for up, down, left, right
_DIRS = np.asarray([[0, 1], [0, -1], [-1, 0], [1, 0]], np.int32)


class GridWorldState(NamedTuple):
    pos: jnp.ndarray       # int32 [2], 1-indexed coordinates
    terminal: jnp.ndarray  # bool scalar


class SimpleGridWorld(Env):
    def __init__(
        self,
        size=(10, 10),
        rewards={(4, 3): -10.0, (4, 6): -5.0, (9, 3): 10.0, (8, 8): 3.0},
        tprob: float = 0.7,
        discount: float = 0.95,
    ):
        self.size = tuple(size)
        self.tprob = float(tprob)
        self.discount = float(discount)
        self.num_actions = 4
        self.obs_shape = (2,)
        cells = [(x, y) for (x, y), r in rewards.items() if r != 0.0]
        self._reward_cells = jnp.asarray(
            np.asarray(cells, np.int32).reshape(len(cells), 2)
        )  # [K, 2]
        self._reward_vals = jnp.asarray(
            [rewards[c] for c in cells], jnp.float32
        )  # [K]
        self._dirs = jnp.asarray(_DIRS)

    @property
    def action_map(self):
        return ["up", "down", "left", "right"]

    def observe(self, state: GridWorldState) -> jnp.ndarray:
        # terminal state is (-1,-1) as in POMDPModels' GWPos(-1,-1)
        return jnp.where(
            state.terminal,
            jnp.asarray([-1.0, -1.0], jnp.float32),
            state.pos.astype(jnp.float32),
        )

    def reset(self, key):
        pos = jax.random.randint(
            key, (2,), jnp.asarray([1, 1]), jnp.asarray([self.size[0] + 1, self.size[1] + 1])
        ).astype(jnp.int32)
        state = GridWorldState(pos=pos, terminal=jnp.asarray(False))
        return state, self.observe(state)

    def step(self, state: GridWorldState, action, key):
        # reward lookup by comparing against the (few) reward cells: an
        # elementwise compare+sum instead of a gather from a reward grid
        at_cell = jnp.all(state.pos[None, :] == self._reward_cells, axis=1)
        cell_r = jnp.sum(at_cell * self._reward_vals)
        in_reward_cell = cell_r != 0.0
        r = jnp.where(state.terminal, 0.0, cell_r)
        # stochastic direction: intended with prob tprob, else one of other 3
        ku, kd = jax.random.split(key)
        u = jax.random.uniform(ku)
        other = jax.random.randint(kd, (), 0, 3)
        other = jnp.where(other >= action, other + 1, other)  # skip intended
        direction = jnp.where(u < self.tprob, action.astype(jnp.int32), other)
        delta = take0(self._dirs, direction)
        new_pos = jnp.clip(
            state.pos + delta,
            jnp.asarray([1, 1], jnp.int32),
            jnp.asarray(self.size, jnp.int32),
        )
        becomes_terminal = jnp.logical_or(state.terminal, in_reward_cell)
        new_state = GridWorldState(
            pos=jnp.where(becomes_terminal, state.pos, new_pos),
            terminal=becomes_terminal,
        )
        done = becomes_terminal
        return new_state, self.observe(new_state), r.astype(jnp.float32), done
