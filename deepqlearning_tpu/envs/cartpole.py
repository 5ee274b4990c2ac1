"""CartPole — classic-control benchmark env, pure-functional.

Not in the reference's test set, but the standard sanity problem for DQN
frameworks; physics follow the classic Barto-Sutton-Anderson formulation
(the same constants as Gym's CartPole-v1). Episode ends when the pole falls
past ±12° or the cart leaves ±2.4; reward 1 per step.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .base import Env


class CartPoleState(NamedTuple):
    x: jnp.ndarray
    x_dot: jnp.ndarray
    theta: jnp.ndarray
    theta_dot: jnp.ndarray


class CartPole(Env):
    def __init__(self, discount: float = 0.99):
        self.discount = float(discount)
        self.num_actions = 2
        self.obs_shape = (4,)
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5  # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4

    @property
    def action_map(self):
        return ["left", "right"]

    def observe(self, state: CartPoleState) -> jnp.ndarray:
        return jnp.stack([state.x, state.x_dot, state.theta, state.theta_dot])

    def reset(self, key):
        vals = jax.random.uniform(key, (4,), minval=-0.05, maxval=0.05)
        state = CartPoleState(*[vals[i] for i in range(4)])
        return state, self.observe(state)

    def step(self, state: CartPoleState, action, key):
        force = jnp.where(action == 1, self.force_mag, -self.force_mag)
        costh = jnp.cos(state.theta)
        sinth = jnp.sin(state.theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * state.theta_dot**2 * sinth) / total_mass
        theta_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh**2 / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * costh / total_mass
        new = CartPoleState(
            x=state.x + self.tau * state.x_dot,
            x_dot=state.x_dot + self.tau * x_acc,
            theta=state.theta + self.tau * state.theta_dot,
            theta_dot=state.theta_dot + self.tau * theta_acc,
        )
        done = (
            (jnp.abs(new.x) > self.x_threshold)
            | (jnp.abs(new.theta) > self.theta_threshold)
        )
        return new, self.observe(new), jnp.asarray(1.0, jnp.float32), done
