"""The jitted (collect → train → maybe-sync-target) iteration, shared by the
single-chip solver and the data-parallel mesh runner.

One iteration = ``steps_per_iter`` lockstep env steps (scan) feeding the
replay, then ``updates_per_iter`` fused train updates, then a conditional
hard target sync on crossing a ``target_update_freq`` boundary — the body of
the reference's ``dqn_train!`` loop (``src/solver.jl:82-169``) as a pure
function. Under shard_map, grads are ``pmean``-reduced over ``axis_name``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import DQNConfig
from .actor import ActorState, make_collect_step
from .train_step import (
    make_dqn_train_step,
    make_drqn_train_step,
    make_grouped_dqn_train_step,
    make_grouped_drqn_train_step,
    sync_target,
)


class LoopCarry(NamedTuple):
    actor: ActorState
    replay: any
    params: any
    target_params: any
    opt_state: any
    lkey: jnp.ndarray
    loss: jnp.ndarray
    gnorm: jnp.ndarray
    # env steps accumulated since the last hard target sync; wrap-free
    # replacement for the t//freq crossing test (int32 t overflows in
    # minutes at headline throughput). Default is a plain int, NOT
    # jnp.asarray — a jnp default would initialize the XLA backend at import
    # time, which breaks jax.distributed.initialize in multi-process runs.
    sync_acc: jnp.ndarray = 0


def build_loop(env, network, buffer, cfg: DQNConfig, eps_fn, gamma: float,
               axis_name: Optional[str] = None, select_fn=None):
    """Returns ``(iteration, populate_step, optimizer)``.

    ``iteration(carry, _) -> (carry, None)`` is scan-able; ``populate_step``
    is the ε=1 collect step used to pre-fill replay
    (``initialize_replay_buffer``, ``src/solver.jl:180-189``).
    ``select_fn`` optionally overrides the exploration strategy with a
    jit-traceable ``(q, t, key) -> (actions, eps)`` protocol function
    (``solver/exploration.py``); populate always uses ε=1 random actions.
    """
    grouped = cfg.grouped_updates and cfg.updates_per_iter > 1
    if cfg.recurrence and grouped:
        train_step, optimizer = make_grouped_drqn_train_step(
            network, buffer, gamma, cfg.double_q, cfg.learning_rate,
            cfg.updates_per_iter, axis_name=axis_name,
        )
    elif cfg.recurrence:
        train_step, optimizer = make_drqn_train_step(
            network, buffer, gamma, cfg.double_q, cfg.learning_rate,
            axis_name=axis_name,
        )
    elif grouped:
        train_step, optimizer = make_grouped_dqn_train_step(
            network, buffer, gamma, cfg.double_q, cfg.learning_rate,
            cfg.updates_per_iter, axis_name=axis_name,
        )
    else:
        train_step, optimizer = make_dqn_train_step(
            network, buffer, gamma, cfg.double_q, cfg.learning_rate,
            axis_name=axis_name,
        )
    if cfg.recurrence:
        insert_fn = lambda replay, tr, ended: buffer.add_step(replay, tr, ended)
    else:
        insert_fn = lambda replay, tr, ended: buffer.insert(replay, tr)

    collect_step = make_collect_step(
        env, network, cfg.max_episode_length, eps_fn, insert_fn,
        select_fn=select_fn,
    )
    populate_step = make_collect_step(
        env, network, cfg.max_episode_length, lambda t: jnp.asarray(1.0),
        insert_fn,
    )
    tuf = cfg.target_update_freq

    def iteration(carry: LoopCarry, _):
        actor, replay, params = carry.actor, carry.replay, carry.params
        target_params, opt_state = carry.target_params, carry.opt_state
        lkey, loss, gnorm = carry.lkey, carry.loss, carry.gnorm
        sync_acc = carry.sync_acc
        if cfg.steps_per_iter <= 4:
            # unroll short collect phases — a nested lax.scan of tiny length
            # forces carry copies of the full replay state per level
            cc = (actor, replay, params)
            for _ in range(cfg.steps_per_iter):
                cc, _ = collect_step(cc, None)
            actor, replay, params = cc
        else:
            (actor, replay, params), _ = jax.lax.scan(
                collect_step, (actor, replay, params), None,
                length=cfg.steps_per_iter,
            )
        n_calls = 1 if grouped else cfg.updates_per_iter
        for _ in range(n_calls):
            lkey, k = jax.random.split(lkey)
            res = train_step(params, target_params, opt_state, replay, k)
            params, opt_state, replay = res.params, res.opt_state, res.replay_state
            loss, gnorm = res.loss, res.grad_norm
        sync_acc = sync_acc + cfg.env_steps_per_iter
        do_sync = sync_acc >= tuf
        sync_acc = jnp.where(do_sync, sync_acc % tuf, sync_acc)
        target_params = sync_target(params, target_params, do_sync)
        return LoopCarry(actor, replay, params, target_params, opt_state,
                         lkey, loss, gnorm, sync_acc), None

    return iteration, populate_step, optimizer
