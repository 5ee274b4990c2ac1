"""Fused TD train steps (feed-forward DQN and recurrent DRQN).

One jitted function does what the reference spreads across
``batch_train!`` + Flux/Zygote + the priority update
(``src/solver.jl:191-287``): sample → Bellman targets (double-Q or max) →
importance-weighted Huber loss → grad (+ optional ``pmean`` over the data
axis) → Adam → PER priority update. XLA fuses the whole thing; no host
round-trips.

Math parity notes:
  * targets are computed outside the gradient tape (stop-gradient semantics
    of ``src/solver.jl:209-217``);
  * IS weights multiply the TD error *before* the Huber, and are not
    max-normalized (``src/solver.jl:223``);
  * loss = sum(huber(w*td)) / batch_size (``src/solver.jl:223-224``); the
    recurrent loss additionally divides by trace_length
    (``src/solver.jl:273-282``) and masks invalid steps;
  * grad metric = max-abs entry (``globalnorm``, ``src/helpers.jl:38-46``);
  * optimizer = Adam with Flux defaults (β=(0.9, 0.999), ε=1e-8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from ..ops.helpers import globalnorm, huber_loss


class TrainResult(NamedTuple):
    params: any
    opt_state: any
    replay_state: any
    loss: jnp.ndarray
    grad_norm: jnp.ndarray


def make_optimizer(learning_rate: float):
    # flatten: run Adam on one concatenated vector instead of per-leaf —
    # the per-leaf version is ~10 extra tiny kernels in an already
    # latency-bound serial update chain; elementwise Adam is bit-identical
    # either way
    return optax.flatten(optax.adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8))


def pmean_flat(grads, axis_name):
    """``pmean`` the whole grads pytree as ONE flat vector.

    A per-leaf ``jax.lax.pmean`` lowers to one all-reduce per leaf (or a few
    after XLA's combiner), and the U sub-updates run them one after another;
    a single flat all-reduce per sub-update keeps that to U collectives. The
    concat/split is a few tens of KB at the headline net. Numerics: the
    reduction runs in f32 regardless of leaf dtype (more precise than a bf16
    tree reduce), values identical per leaf otherwise.

    ``axis_name`` may be a TUPLE of mesh axes, innermost first: the
    reduction is then explicitly hierarchical — ``psum`` per axis in order
    (within each group first, then the already-reduced vector once across
    groups).
    """
    leaves, treedef = jax.tree_util.tree_flatten(grads)
    flat = jnp.concatenate([l.ravel().astype(jnp.float32) for l in leaves])
    if isinstance(axis_name, (tuple, list)):
        n = 1
        for ax in axis_name:            # innermost (ICI) first
            flat = jax.lax.psum(flat, ax)
            n *= jax.lax.axis_size(ax)
        flat = flat / n
    else:
        flat = jax.lax.pmean(flat, axis_name)
    out, off = [], 0
    for l in leaves:
        out.append(flat[off:off + l.size].reshape(l.shape).astype(l.dtype))
        off += l.size
    return jax.tree_util.tree_unflatten(treedef, out)


def _bellman_targets(network, params, target_params, next_obs, reward, done,
                     gamma, double_q, net_state=None, target_net_state=None):
    """r + (1-done) * gamma * Q_target(s', a*) with a* from the online net
    (double-Q, ``src/solver.jl:209-213``) or plain max (``:215``)."""
    q_tgt, _ = network.apply(target_params, next_obs, target_net_state)
    if double_q:
        q_onl, _ = network.apply(params, next_obs, net_state)
        best = jnp.argmax(q_onl, axis=-1)
        q_sp_max = jnp.take_along_axis(q_tgt, best[..., None], axis=-1)[..., 0]
    else:
        q_sp_max = jnp.max(q_tgt, axis=-1)
    return reward + (1.0 - done) * gamma * q_sp_max


def _make_batch_update(network, buffer, gamma, double_q, optimizer,
                       axis_name):
    """Shared inner update: one (batch, weights) → grads → Adam.

    Returns ``update(params, target_params, opt_state, batch, weights) ->
    (params, opt_state, td, loss, grad_norm)``.
    """
    B = buffer.batch_size
    # double-Q needs the online net on s' for the argmax only (stop-grad,
    # src/solver.jl:209-213). Two regimes:
    #  * small models (tiny obs): CONCAT s and s' into one traversal inside
    #    the tape — halves the number of latency-bound small-matmul launches
    #    in the serial update chain; the extra backward rows are noise.
    #  * big models (conv/image obs): the concat would run the BACKWARD over
    #    2B rows (the s' rows carry zero cotangent but XLA still computes
    #    them), nearly doubling the backward of a conv stack. Run the s'
    #    forward OUTSIDE the tape instead (grad-free by construction), so
    #    backward cost stays at B rows.
    concat_sp = double_q and getattr(buffer, "no", 1 << 30) <= 256

    def _q_pair(p, batch):
        """Online-net Q(s) and stop-grad Q(s') in ONE chain traversal."""
        if not double_q:
            q, _ = network.apply(p, batch.obs)
            return q, None
        q_cat, _ = network.apply(
            p, jnp.concatenate([batch.obs, batch.next_obs], axis=0)
        )
        return q_cat[:B], jax.lax.stop_gradient(q_cat[B:])

    def update(params, target_params, opt_state, batch, weights,
               q_sp_tgt=None):
        if q_sp_tgt is None:
            q_sp_tgt, _ = network.apply(target_params, batch.next_obs)
        q_sp_out = None
        if double_q and not concat_sp:
            # outside-the-tape online s' forward (stop-gradient semantics
            # exactly: computed from `params`, constant w.r.t. loss_fn's p)
            q_sp_out, _ = network.apply(params, batch.next_obs)

        def loss_fn(p):
            if q_sp_out is not None:
                q, _ = network.apply(p, batch.obs)
                q_sp_onl = q_sp_out
            else:
                q, q_sp_onl = _q_pair(p, batch)
            if double_q:
                best = jnp.argmax(q_sp_onl, axis=-1)
                q_sp_max = jnp.take_along_axis(
                    q_sp_tgt, best[..., None], axis=-1
                )[..., 0]
            else:
                q_sp_max = jnp.max(q_sp_tgt, axis=-1)
            q_targets = batch.reward + (1.0 - batch.done) * gamma * q_sp_max
            q_sa = jnp.take_along_axis(q, batch.action[:, None], axis=-1)[:, 0]
            td = q_sa - q_targets
            loss = jnp.sum(huber_loss(weights * td)) / B
            return loss, td

        (loss, td), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        if axis_name is not None:
            grads = pmean_flat(grads, axis_name)
        grad_norm = globalnorm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, td, loss, grad_norm

    return update


def make_dqn_train_step(network, buffer, gamma: float, double_q: bool,
                        learning_rate: float, axis_name: Optional[str] = None):
    """Feed-forward path. Returns
    ``step(params, target_params, opt_state, replay_state, key) -> TrainResult``.
    """
    optimizer = make_optimizer(learning_rate)
    update = _make_batch_update(network, buffer, gamma, double_q, optimizer,
                                axis_name)

    def step(params, target_params, opt_state, replay_state, key):
        batch, idx, weights = buffer.sample(replay_state, key)
        params, opt_state, td, loss, grad_norm = update(
            params, target_params, opt_state, batch, weights
        )
        replay_state = buffer.update_priorities(replay_state, idx, td)
        return TrainResult(params, opt_state, replay_state, loss, grad_norm)

    return step, optimizer


def make_grouped_dqn_train_step(network, buffer, gamma: float, double_q: bool,
                                learning_rate: float, n_updates: int,
                                axis_name: Optional[str] = None):
    """``n_updates`` sequential Adam updates sharing ONE replay sample.

    At high env counts the loop runs several train updates back-to-back per
    iteration (``updates_per_iter``); the sum-tree descent, row gather, and
    priority scatter+rebuild are latency-bound and dominate each update. This
    step draws all ``n_updates * batch_size`` transitions in one stratified
    descent, de-interleaves them stride-``n_updates`` so every sub-batch
    still spans the full priority mass, scans the grad/Adam updates over the
    sub-batches (parameters advance between sub-batches exactly as in the
    sequential form), and commits one merged priority update at the end.

    Documented deviation (docs/DEVIATIONS.md): within one grouped step the
    sub-batches are drawn against the tree state at the start of the step
    rather than after each sub-update — the same data/update ratio as the
    reference (``train_freq``, ``src/solver.jl:7``), with priorities up to
    ``n_updates - 1`` sub-updates stale. ``n_updates=1`` matches
    ``make_dqn_train_step`` (up to float reassociation).
    """
    optimizer = make_optimizer(learning_rate)
    B, U = buffer.batch_size, int(n_updates)
    update = _make_batch_update(network, buffer, gamma, double_q, optimizer,
                                axis_name)

    def step(params, target_params, opt_state, replay_state, key):
        batch, idx, weights = buffer.sample_n(replay_state, key, U)

        # target net is frozen within the step, so its forward runs ONCE on
        # the whole [U*B] draw instead of once per sub-update inside the
        # serial scan chain (exact: sequential form uses the same params)
        q_sp_tgt_all, _ = network.apply(target_params, batch.next_obs)

        # [U*B] → [U, B]: stride-U de-interleave so consecutive strata go to
        # different sub-batches (sub-batch u takes draws u, u+U, u+2U, …)
        de = lambda x: x.reshape((U, B) + x.shape[1:])  # u-major sample_n
        batches = jax.tree_util.tree_map(de, batch)
        w_u = de(weights)
        q_sp_tgt_u = de(q_sp_tgt_all)

        def body(carry, xs):
            params, opt_state = carry
            b, w, q_sp_tgt = xs
            params, opt_state, td, loss, grad_norm = update(
                params, target_params, opt_state, b, w, q_sp_tgt=q_sp_tgt
            )
            return (params, opt_state), (td, loss, grad_norm)

        (params, opt_state), (tds, losses, gnorms) = jax.lax.scan(
            body, (params, opt_state), (batches, w_u, q_sp_tgt_u)
        )

        # merged priority update: re-interleave back to draw order
        re = lambda x: x.reshape((U * B,) + x.shape[2:])  # u-major flat order
        replay_state = buffer.update_priorities(replay_state, idx, re(tds))
        # report the last sub-update's loss/grad (the "latest" the host logs)
        return TrainResult(params, opt_state, replay_state,
                           losses[-1], gnorms[-1])

    return step, optimizer


def _make_drqn_update(network, buffer, gamma, double_q, optimizer, axis_name):
    """Shared recurrent inner update: one EpisodeBatch → grads → Adam."""
    B, T = buffer.batch_size, buffer.trace_length

    def update(params, target_params, opt_state, batch):
        # time-major [T, B, ...]
        tm = lambda x: jnp.swapaxes(x, 0, 1)
        obs_t, a_t = tm(batch.obs), tm(batch.action)
        r_t, d_t, m_t = tm(batch.reward), tm(batch.done), tm(batch.mask)
        nobs_t = tm(batch.next_obs)
        init_state = network.init_state(B)

        # --- targets: unroll online+target nets over s' from zero state
        # (Flux.reset! then stateful loop, src/solver.jl:249-269); input
        # projections are hoisted out of the recurrence (apply_sequence).
        # The two nets share one structure, so stacking their params and
        # vmapping gives ONE unroll with doubled matmul width instead of two
        # sequential unrolls — the recurrence is latency-bound, not
        # FLOP-bound, so this halves the target phase's serial chain ---
        pstack = jax.tree_util.tree_map(
            lambda a, b: jnp.stack([a, b]), params, target_params
        )
        q_both, _ = jax.vmap(
            lambda p: network.apply_sequence(p, nobs_t, init_state)
        )(pstack)
        q_onl_seq, q_tgt_seq = q_both[0], q_both[1]
        if double_q:
            best = jnp.argmax(q_onl_seq, axis=-1)
            q_sp_max = jnp.take_along_axis(q_tgt_seq, best[..., None], -1)[..., 0]
        else:
            q_sp_max = jnp.max(q_tgt_seq, axis=-1)
        q_targets = r_t + (1.0 - d_t) * gamma * q_sp_max  # [T, B]

        # --- masked time-summed loss (src/solver.jl:273-282) ---
        def loss_fn(p):
            q_seq, _ = network.apply_sequence(p, obs_t, init_state)  # [T, B, A]
            q_sa = jnp.take_along_axis(q_seq, a_t[..., None], -1)[..., 0]
            td = q_sa - q_targets
            return jnp.sum(huber_loss(m_t * td)) / B / T

        loss, grads = jax.value_and_grad(loss_fn)(params)
        if axis_name is not None:
            grads = pmean_flat(grads, axis_name)
        grad_norm = globalnorm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grad_norm

    return update


def make_drqn_train_step(network, buffer, gamma: float, double_q: bool,
                         learning_rate: float, axis_name: Optional[str] = None):
    """Recurrent path: ``lax.scan`` over the trace axis replaces the
    reference's stateful per-timestep unroll (``src/solver.jl:258-281``).
    No PER on this path, as in the reference (``src/solver.jl:285``).
    """
    optimizer = make_optimizer(learning_rate)
    update = _make_drqn_update(network, buffer, gamma, double_q, optimizer,
                               axis_name)

    def step(params, target_params, opt_state, replay_state, key):
        batch = buffer.sample(replay_state, key)
        params, opt_state, loss, grad_norm = update(
            params, target_params, opt_state, batch
        )
        return TrainResult(params, opt_state, replay_state, loss, grad_norm)

    return step, optimizer


def make_grouped_drqn_train_step(network, buffer, gamma: float,
                                 double_q: bool, learning_rate: float,
                                 n_updates: int,
                                 axis_name: Optional[str] = None):
    """``n_updates`` sequential recurrent updates sharing ONE window gather.

    The DRQN analog of ``make_grouped_dqn_train_step``: at high env counts
    several updates run back-to-back per iteration, and the [U*B, T, obs]
    window gather (the latency-bound part of episode sampling) is shared
    across them; grads/Adam still advance sequentially per sub-update.
    Uniform episode sampling means no priority bookkeeping, so — unlike the
    PER grouped step — this grouping is exactly equivalent to U sequential
    ``make_drqn_train_step`` calls on pre-drawn batches.
    """
    optimizer = make_optimizer(learning_rate)
    B, U = buffer.batch_size, int(n_updates)
    update = _make_drqn_update(network, buffer, gamma, double_q, optimizer,
                               axis_name)

    def step(params, target_params, opt_state, replay_state, key):
        batch = buffer.sample_n(replay_state, key, U)
        # [U*B, T, ...] → [U, B, T, ...] stride-U de-interleave
        de = lambda x: x.reshape((U, B) + x.shape[1:])  # u-major sample_n
        batches = jax.tree_util.tree_map(de, batch)

        def body(carry, b):
            params, opt_state = carry
            params, opt_state, loss, grad_norm = update(
                params, target_params, opt_state, b
            )
            return (params, opt_state), (loss, grad_norm)

        (params, opt_state), (losses, gnorms) = jax.lax.scan(
            body, (params, opt_state), batches
        )
        return TrainResult(params, opt_state, replay_state,
                           losses[-1], gnorms[-1])

    return step, optimizer


def sync_target(params, target_params, do_sync):
    """Hard target copy when ``do_sync`` (``Flux.loadparams!`` at
    ``src/solver.jl:142-145``), as a fused select so it stays inside jit."""
    return jax.tree_util.tree_map(
        lambda p, t: jnp.where(do_sync, p, t), params, target_params
    )
