"""Pure-functional layer stack ("Chain") for Q-networks.

The reference builds Q-networks as Flux ``Chain``s of ``Dense``/``LSTM``
layers (``test/runtests.jl:47,117``). Here a layer is a *static* frozen
dataclass describing shapes; parameters and recurrent state are explicit
pytrees threaded through pure ``apply`` functions — the idiomatic JAX design
(everything jit/vmap/scan-able, nothing stateful).

Conventions:
  * batch-first: inputs are ``[batch, features...]``.
  * ``apply(params, x, state) -> (y, new_state)`` where ``state`` is a tuple
    with one entry per layer — ``()`` for stateless layers, ``(h, c)`` for
    LSTM. This replaces Flux's hidden mutable ``Recur`` state
    (``src/helpers.jl:61-79``) with explicit state the caller carries, so
    there is nothing to save/restore around train updates
    (cf. reference ``src/solver.jl:137-139``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp


def _glorot_uniform(key, shape, dtype):
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


@dataclasses.dataclass(frozen=True)
class Dense:
    """Affine layer with optional fused activation.

    Mirrors Flux ``Dense(in, out, act)``. Matmuls accumulate in float32
    (``preferred_element_type``), then cast back to the input dtype so bf16
    activations stay bf16 end-to-end. No ``precision`` is passed: float32
    matmuls run at the backend's default matmul precision.
    """

    in_dim: int
    out_dim: int
    activation: Optional[Callable] = None
    use_bias: bool = True

    def init(self, key, dtype=jnp.float32):
        kw, kb = jax.random.split(key)
        params = {"w": _glorot_uniform(kw, (self.in_dim, self.out_dim), dtype)}
        if self.use_bias:
            params["b"] = jnp.zeros((self.out_dim,), dtype)
        return params

    def apply(self, params, x):
        y = jnp.dot(x, params["w"], preferred_element_type=jnp.float32)
        if self.use_bias:
            y = y + params["b"].astype(jnp.float32)
        if self.activation is not None:
            y = self.activation(y)
        return y.astype(x.dtype)

    @property
    def recurrent(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class Flatten:
    """Flatten all but the leading batch axis (``flattenbatch`` as a layer).

    Reference nets start with ``x -> flattenbatch(x)`` (``test/runtests.jl:47``).
    """

    def init(self, key, dtype=jnp.float32):
        return {}

    def apply(self, params, x):
        return x.reshape((x.shape[0], -1))

    @property
    def recurrent(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class Activation:
    """Standalone elementwise activation layer."""

    fn: Callable

    def init(self, key, dtype=jnp.float32):
        return {}

    def apply(self, params, x):
        return self.fn(x)

    @property
    def recurrent(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class LSTM:
    """Single-step LSTM cell (the recurrent unit behind reference DRQN,
    ``test/runtests.jl:117``).

    One fused ``[in+hidden, 4H]`` matmul per step; XLA fuses the gate math
    into the elementwise work around it.
    State is ``(h, c)`` each ``[batch, hidden]``; unrolling over time is the
    caller's ``lax.scan``.
    """

    in_dim: int
    hidden: int

    def init(self, key, dtype=jnp.float32):
        ki, kh = jax.random.split(key)
        b = jnp.zeros((4 * self.hidden,), dtype)
        # forget-gate bias 1.0 (standard; helps early gradient flow)
        b = b.at[self.hidden : 2 * self.hidden].set(1.0)
        return {
            "wi": _glorot_uniform(ki, (self.in_dim, 4 * self.hidden), dtype),
            "wh": _glorot_uniform(kh, (self.hidden, 4 * self.hidden), dtype),
            "b": b,
        }

    def init_state(self, batch_size: int, dtype=jnp.float32):
        return (
            jnp.zeros((batch_size, self.hidden), dtype),
            jnp.zeros((batch_size, self.hidden), dtype),
        )

    def _cell(self, params, xi, state):
        """One step given the precomputed input projection ``xi = x @ wi``."""
        h, c = state
        gates = (
            xi
            + jnp.dot(h, params["wh"], preferred_element_type=jnp.float32)
            + params["b"].astype(jnp.float32)
        )
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        new_c = jax.nn.sigmoid(f) * c.astype(jnp.float32) + jax.nn.sigmoid(i) * jnp.tanh(g)
        new_h = jax.nn.sigmoid(o) * jnp.tanh(new_c)
        return new_h.astype(h.dtype), (new_h.astype(h.dtype), new_c.astype(h.dtype))

    def apply(self, params, x, state):
        xi = jnp.dot(x, params["wi"], preferred_element_type=jnp.float32)
        return self._cell(params, xi, state)

    def apply_sequence(self, params, xs, state):
        """Unroll over a ``[T, B, in]`` sequence.

        The input projection for ALL timesteps is one fat ``[T*B, 4H]``
        matmul; only the ``h @ wh`` recurrence stays inside the
        ``lax.scan`` — the standard RNN restructuring that removes T-1
        sequential input matmuls from the critical path.
        """
        T, B, _ = xs.shape
        xi_all = jnp.dot(
            xs.reshape(T * B, -1), params["wi"],
            preferred_element_type=jnp.float32,
        ).reshape(T, B, -1)

        def step(carry, xi):
            y, carry = self._cell(params, xi, carry)
            return carry, y

        state, ys = jax.lax.scan(step, state, xi_all)
        return ys, state

    @property
    def recurrent(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Conv2D:
    """2-D convolution over NHWC inputs (the Flux ``Conv`` analog).

    The reference's user nets are Dense/LSTM only (``test/runtests.jl``), but
    image-observation DQN (Atari-style) needs convs; XLA lowers these to the
    backend's convolution library. ``stride``/``padding`` follow lax.conv semantics.
    """

    in_channels: int
    out_channels: int
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    activation: Optional[Callable] = None

    def init(self, key, dtype=jnp.float32):
        kh, kw = self.kernel
        fan_in = kh * kw * self.in_channels
        fan_out = kh * kw * self.out_channels
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w = jax.random.uniform(
            key, (kh, kw, self.in_channels, self.out_channels), dtype,
            -limit, limit,
        )
        return {"w": w, "b": jnp.zeros((self.out_channels,), dtype)}

    def apply(self, params, x):
        # low-precision inputs keep the conv OUTPUT in the input dtype (the
        # accumulation is f32 internally regardless), and a forced f32
        # output breaks the backward (the transpose-conv cotangent
        # arrives f32 while w is bf16, and lax.conv rejects mixed dtypes)
        pet = jnp.float32 if x.dtype == jnp.float32 else None
        y = jax.lax.conv_general_dilated(
            x, params["w"].astype(x.dtype), window_strides=self.stride,
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=pet,
        )
        y = y.astype(jnp.float32) + params["b"].astype(jnp.float32)
        if self.activation is not None:
            y = self.activation(y)
        return y.astype(x.dtype)

    @property
    def recurrent(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class GRU:
    """Single-step GRU cell — a second recurrent unit beside LSTM.

    State is ``(h,)``; same explicit-state contract as :class:`LSTM`.
    """

    in_dim: int
    hidden: int

    def init(self, key, dtype=jnp.float32):
        ki, kh = jax.random.split(key)
        return {
            "wi": _glorot_uniform(ki, (self.in_dim, 3 * self.hidden), dtype),
            "wh": _glorot_uniform(kh, (self.hidden, 3 * self.hidden), dtype),
            "b": jnp.zeros((3 * self.hidden,), dtype),
        }

    def init_state(self, batch_size: int, dtype=jnp.float32):
        return (jnp.zeros((batch_size, self.hidden), dtype),)

    def _cell(self, params, xi, state):
        (h,) = state
        hh = jnp.dot(h, params["wh"], preferred_element_type=jnp.float32)
        b = params["b"].astype(jnp.float32)
        H = self.hidden
        r = jax.nn.sigmoid(xi[..., :H] + hh[..., :H] + b[:H])
        z = jax.nn.sigmoid(xi[..., H:2 * H] + hh[..., H:2 * H] + b[H:2 * H])
        n = jnp.tanh(xi[..., 2 * H:] + r * hh[..., 2 * H:] + b[2 * H:])
        new_h = ((1.0 - z) * n + z * h.astype(jnp.float32)).astype(h.dtype)
        return new_h, (new_h,)

    def apply(self, params, x, state):
        xi = jnp.dot(x, params["wi"], preferred_element_type=jnp.float32)
        return self._cell(params, xi, state)

    def apply_sequence(self, params, xs, state):
        """Unroll over ``[T, B, in]`` with the input projection hoisted into
        one fat matmul (see ``LSTM.apply_sequence``)."""
        T, B, _ = xs.shape
        xi_all = jnp.dot(
            xs.reshape(T * B, -1), params["wi"],
            preferred_element_type=jnp.float32,
        ).reshape(T, B, -1)

        def step(carry, xi):
            y, carry = self._cell(params, xi, carry)
            return carry, y

        state, ys = jax.lax.scan(step, state, xi_all)
        return ys, state

    @property
    def recurrent(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Chain:
    """Sequential container; the JAX analog of a Flux ``Chain``.

    ``apply(params, x, state)`` threads per-layer recurrent state explicitly.
    An empty chain is the identity (used as the base of an all-Dense dueling
    split, cf. reference ``src/dueling.jl:55``).
    """

    layers: Tuple = ()

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], tuple):
            layers = layers[0]
        object.__setattr__(self, "layers", tuple(layers))

    def init(self, key, dtype=jnp.float32):
        keys = jax.random.split(key, max(1, len(self.layers)))
        return tuple(l.init(k, dtype) for l, k in zip(self.layers, keys))

    def init_state(self, batch_size: int, dtype=jnp.float32):
        return tuple(
            l.init_state(batch_size, dtype) if l.recurrent else ()
            for l in self.layers
        )

    def apply(self, params, x, state=None):
        if state is None:
            if self.recurrent:
                raise ValueError(
                    "recurrent Chain requires explicit state; call init_state()"
                )
            state = self.init_state(x.shape[0])
        new_state = []
        for layer, p, s in zip(self.layers, params, state):
            if layer.recurrent:
                x, s = layer.apply(p, x, s)
            else:
                x = layer.apply(p, x)
            new_state.append(s)
        return x, tuple(new_state)

    def apply_sequence(self, params, xs, state):
        """Apply over a time-major ``[T, B, ...]`` sequence.

        Stateless layers are applied to all timesteps at once (one fat op);
        recurrent layers use their hoisted-input ``apply_sequence``. This is
        the fast path for the DRQN train step (``learner/train_step.py``) —
        only the recurrences themselves stay sequential.
        """
        T, B = xs.shape[0], xs.shape[1]
        new_state = []
        for layer, p, s in zip(self.layers, params, state):
            if layer.recurrent:
                xs, s = layer.apply_sequence(p, xs, s)
            elif isinstance(layer, Flatten):
                xs = xs.reshape(T, B, -1)
            elif isinstance(layer, Conv2D):
                xs = layer.apply(p, xs.reshape((T * B,) + xs.shape[2:]))
                xs = xs.reshape((T, B) + xs.shape[1:])
            else:
                xs = layer.apply(p, xs)
            new_state.append(s)
        return xs, tuple(new_state)

    @property
    def recurrent(self) -> bool:
        return any(l.recurrent for l in self.layers)

    @property
    def out_dim(self) -> Optional[int]:
        for l in reversed(self.layers):
            if isinstance(l, Dense):
                return l.out_dim
            if isinstance(l, LSTM):
                return l.hidden
        return None


def isrecurrent(network) -> bool:
    """True if the network contains a recurrent layer.

    Parity with reference ``isrecurrent`` (``src/helpers.jl:25-32``).
    """
    return bool(network.recurrent)
