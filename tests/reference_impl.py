"""Plain reference implementations the train-step tests compare against.

Written without the repository's train-step code: a float64 numpy forward
for Flatten/Dense chains (and their dueling split), the TD loss of the
reference (``src/solver.jl:191-236``) in numpy, and the recurrent loss
(``src/solver.jl:239-287``) as a Python loop over single-step cell calls.
"""
import jax
import jax.numpy as jnp
import numpy as np

from deepqlearning_tpu import Chain, Dense, Flatten, TransitionBatch
from deepqlearning_tpu.models.dueling import DuelingNetwork
from deepqlearning_tpu.ops.helpers import huber_loss

_ACTS = {None: lambda x: x, jnp.tanh: np.tanh,
         jax.nn.relu: lambda x: np.maximum(x, 0.0)}


def np_chain(chain: Chain, params, x):
    x = np.asarray(x, np.float64)
    for layer, p in zip(chain.layers, params):
        if isinstance(layer, Flatten):
            x = x.reshape(x.shape[0], -1)
        elif isinstance(layer, Dense):
            x = _ACTS[layer.activation](
                x @ np.asarray(p["w"], np.float64)
                + np.asarray(p["b"], np.float64))
        else:
            raise TypeError(layer)
    return x


def np_forward(net, params, x):
    """Q-values of a feed-forward Chain or DuelingNetwork, in float64."""
    if isinstance(net, DuelingNetwork):
        h = np_chain(net.base, params["base"], x)
        v = np_chain(net.val, params["val"], h)
        a = np_chain(net.adv, params["adv"], h)
        return v + a - a.mean(-1, keepdims=True)
    return np_chain(net, params, x)


def np_huber(x):
    a = np.abs(x)
    q = np.minimum(a, 1.0)
    return 0.5 * q ** 2 + (a - q)


def np_td(net, params, target_params, batch, weights, gamma, double_q):
    """``(loss, td)`` of one batch, as ``batch_train!`` computes them."""
    obs, nobs = np.asarray(batch.obs), np.asarray(batch.next_obs)
    a = np.asarray(batch.action)
    r = np.asarray(batch.reward, np.float64)
    d = np.asarray(batch.done, np.float64)
    w = np.asarray(weights, np.float64)
    q_tgt = np_forward(net, target_params, nobs)
    if double_q:
        best = np.argmax(np_forward(net, params, nobs), -1)
        q_next = q_tgt[np.arange(len(a)), best]
    else:
        q_next = q_tgt.max(-1)
    td = (np_forward(net, params, obs)[np.arange(len(a)), a]
          - (r + (1.0 - d) * gamma * q_next))
    return np_huber(w * td).sum() / len(a), td


def random_transitions(key, n, obs_dim, num_actions=4):
    ks = jax.random.split(key, 5)
    return TransitionBatch(
        obs=jax.random.normal(ks[0], (n, obs_dim)),
        action=jax.random.randint(ks[1], (n,), 0, num_actions),
        reward=jax.random.normal(ks[2], (n,)),
        next_obs=jax.random.normal(ks[3], (n, obs_dim)),
        done=(jax.random.uniform(ks[4], (n,)) < 0.1).astype(jnp.float32),
    )


def adam_grads(opt_state):
    """The gradient of a FIRST Adam step, read back from its moment:
    ``mu = (1 - b1) * g`` with b1 = 0.9 (``make_optimizer``)."""
    return np.asarray(opt_state[0].mu, np.float64) / 0.1


def recurrent_loss(net, params, target_params, batch, gamma, double_q):
    """Masked time-summed DRQN loss with a Python loop over the trace, one
    ``net.apply`` per step from zero state (``src/solver.jl:249-282``)."""
    B, T = batch.action.shape

    def unroll(p, xs):
        state = net.init_state(B)
        qs = []
        for t in range(T):
            q, state = net.apply(p, xs[:, t], state)
            qs.append(q)
        return jnp.stack(qs, axis=1)                      # [B, T, A]

    q_tgt = unroll(target_params, batch.next_obs)
    if double_q:
        best = jnp.argmax(unroll(params, batch.next_obs), -1)
        q_next = jnp.take_along_axis(q_tgt, best[..., None], -1)[..., 0]
    else:
        q_next = q_tgt.max(-1)
    targets = jax.lax.stop_gradient(
        batch.reward + (1.0 - batch.done) * gamma * q_next)
    q = unroll(params, batch.obs)
    q_sa = jnp.take_along_axis(q, batch.action[..., None], -1)[..., 0]
    return jnp.sum(huber_loss(batch.mask * (q_sa - targets))) / B / T


def td_loss(net, params, target_params, batch, weights, gamma, double_q):
    """The feed-forward TD loss in plain jnp (differentiable, for grads)."""
    q_tgt, _ = net.apply(target_params, batch.next_obs)
    if double_q:
        q_onl, _ = net.apply(jax.lax.stop_gradient(params), batch.next_obs)
        best = jnp.argmax(q_onl, -1)
        q_next = jnp.take_along_axis(q_tgt, best[:, None], -1)[:, 0]
    else:
        q_next = q_tgt.max(-1)
    q, _ = net.apply(params, batch.obs)
    q_sa = jnp.take_along_axis(q, batch.action[:, None], -1)[:, 0]
    td = q_sa - (batch.reward + (1.0 - batch.done) * gamma * q_next)
    return jnp.sum(huber_loss(weights * td)) / batch.action.shape[0]
