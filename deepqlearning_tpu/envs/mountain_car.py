"""MountainCar — classic-control benchmark env, pure-functional.

Not in the reference's test set, but a standard sparse-reward control
problem (Moore 1990 formulation, same constants as Gym's MountainCar-v0):
an under-powered car must rock back and forth to escape a valley. Reward
-1 per step; episode ends at the goal position. Vmappable / jittable like
every `Env` (envs/base.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .base import Env


class MountainCarState(NamedTuple):
    position: jnp.ndarray
    velocity: jnp.ndarray


class MountainCar(Env):
    def __init__(self, discount: float = 0.99):
        self.discount = float(discount)
        self.num_actions = 3  # push left / no push / push right
        self.obs_shape = (2,)
        self.min_position = -1.2
        self.max_position = 0.6
        self.max_speed = 0.07
        self.goal_position = 0.5
        self.force = 0.001
        self.gravity = 0.0025

    @property
    def action_map(self):
        return ["left", "none", "right"]

    def observe(self, state: MountainCarState) -> jnp.ndarray:
        return jnp.stack([state.position, state.velocity])

    def reset(self, key):
        pos = jax.random.uniform(key, (), minval=-0.6, maxval=-0.4)
        state = MountainCarState(position=pos, velocity=jnp.zeros(()))
        return state, self.observe(state)

    def step(self, state: MountainCarState, action, key):
        vel = (
            state.velocity
            + (action.astype(jnp.float32) - 1.0) * self.force
            - jnp.cos(3.0 * state.position) * self.gravity
        )
        vel = jnp.clip(vel, -self.max_speed, self.max_speed)
        pos = jnp.clip(state.position + vel, self.min_position, self.max_position)
        # inelastic left wall, as in the classic formulation
        vel = jnp.where((pos <= self.min_position) & (vel < 0.0), 0.0, vel)
        new = MountainCarState(position=pos, velocity=vel)
        done = pos >= self.goal_position
        return new, self.observe(new), jnp.asarray(-1.0, jnp.float32), done
