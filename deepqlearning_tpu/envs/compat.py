"""Host-environment compatibility path.

The reference trains on *any* object speaking CommonRLInterface —
including user classes that are not vectorizable (``test/runtests.jl:199-234``
"Common RL Env", ``:165-197`` "Static Array Env"). The analog here:
``HostEnv`` is the same mutable ``reset/observe/act/terminated/actions``
protocol stepped on the host, while action selection and the train step stay
jitted on device. Throughput is host-bound by construction — this path exists
for genericity parity; the fast path is the functional ``Env``.
"""
from __future__ import annotations

import math
from typing import Any, List, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..replay.transition import DQExperience, batch_from_experience


class HostEnv:
    """CommonRLInterface-style mutable env (``src/DeepQLearning.jl:15``).

    Subclass and implement: ``reset()``, ``observe() -> np.ndarray``,
    ``act(action) -> float``, ``terminated() -> bool``, ``actions() -> list``.
    ``discount`` defaults to 1.0 (``default_discount``, ``src/helpers.jl:83``).
    """

    discount: float = 1.0

    def reset(self):
        raise NotImplementedError

    def observe(self) -> np.ndarray:
        raise NotImplementedError

    def act(self, action) -> float:
        raise NotImplementedError

    def terminated(self) -> bool:
        raise NotImplementedError

    def actions(self) -> Sequence[Any]:
        raise NotImplementedError


def _host_eval(policy, env: HostEnv, n_eval: int, max_episode_length: int):
    """Serial greedy rollouts (``basic_evaluation``, ``src/evaluation_policy.jl:17-42``)."""
    avg_r, avg_steps = 0.0, 0.0
    for _ in range(n_eval):
        env.reset()
        policy.reset_state()
        obs = np.asarray(env.observe(), np.float32)
        r_tot, step = 0.0, 0
        while not env.terminated() and step <= max_episode_length:
            a = policy.action(obs)
            r_tot += float(env.act(a))
            obs = np.asarray(env.observe(), np.float32)
            step += 1
        avg_r += r_tot
        avg_steps += step
    return avg_r / n_eval, avg_steps / n_eval, {}


def _run_eval(solver, policy, env: HostEnv, cfg):
    """Dispatch evaluation: the default jitted ``basic_evaluation`` cannot
    drive a host env, so it maps to the serial rollout; custom strategies
    (reference parity, ``src/solver.jl:101``) are called with the standard
    signature and may drive the env however they like."""
    from ..solver.evaluation import basic_evaluation

    if solver.evaluation_policy is basic_evaluation:
        return _host_eval(policy, env, cfg.num_ep_eval, cfg.max_episode_length)
    key = jax.random.PRNGKey(cfg.seed + 1)
    return solver.evaluation_policy(
        policy.network, policy.params, env, cfg.num_ep_eval,
        cfg.max_episode_length, key, cfg.verbose,
    )


def solve_host(solver, env: HostEnv):
    """Reference-shaped serial training loop (``dqn_train!``,
    ``src/solver.jl:59-178``) over a host env, with the jitted device train
    step. Feed-forward and recurrent paths both supported.
    """
    from ..learner.train_step import (
        make_dqn_train_step,
        make_drqn_train_step,
        sync_target,
    )
    from ..solver import checkpoint
    from ..solver.policy import NNPolicy

    cfg = solver.config
    action_map = list(env.actions())
    network = solver._build_network()
    env.reset()
    obs = np.asarray(env.observe(), np.float32)
    obs_shape = obs.shape
    buffer = _make_host_buffer(solver, obs_shape)
    gamma = float(getattr(env, "discount", 1.0))

    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_learn = jax.random.split(key)
    params = network.init(k_init)
    target_params = params

    if cfg.recurrence:
        train_step, optimizer = make_drqn_train_step(
            network, buffer, gamma, cfg.double_q, cfg.learning_rate
        )
    else:
        train_step, optimizer = make_dqn_train_step(
            network, buffer, gamma, cfg.double_q, cfg.learning_rate
        )
    train_step = jax.jit(train_step)
    opt_state = optimizer.init(params)
    replay = buffer.init()

    policy = NNPolicy(env, network, params, action_map, len(obs_shape))
    rng = np.random.RandomState(cfg.seed)
    logger = None
    if solver.logdir is not None:
        from ..utils.tb_writer import TBWriter

        logger = TBWriter(solver.logdir)
        solver.logdir = logger.logdir

    # schedule-based strategies expose .eps (or are ε(t) schedules); any
    # other callable is a reference-style 5-arg action-choosing strategy
    # f(policy, env, obs, t, rng) -> (action, eps)
    # (``src/exploration_policy.jl:10-12``)
    from ..solver.exploration import ConstantEpsilon, LinearDecaySchedule

    if hasattr(solver.exploration_policy, "eps"):
        eps_fn = solver.exploration_policy.eps
    elif isinstance(solver.exploration_policy,
                    (LinearDecaySchedule, ConstantEpsilon)):
        eps_fn = solver.exploration_policy
    else:
        eps_fn = None  # custom strategy, dispatched in the loop

    insert_one = jax.jit(
        lambda replay, tr, ended: buffer.add_step(replay, tr, ended)
        if cfg.recurrence
        else buffer.insert(replay, tr)
    )

    def push(replay, o, a, r, op, done, ended):
        # per-step DQExperience record, exactly the reference's insert unit
        # (DQExperience + add_exp!, src/solver.jl:88-95)
        exp = DQExperience(s=o, a=a, r=r, sp=op, done=done)
        return insert_one(replay, batch_from_experience(exp),
                          jnp.asarray([ended]))

    # --- populate with a random policy (src/solver.jl:180-189) ---
    env.reset()
    obs = np.asarray(env.observe(), np.float32)
    step = 0
    for _ in range(cfg.train_start):
        ai = rng.randint(len(action_map))
        r = float(env.act(action_map[ai]))
        op = np.asarray(env.observe(), np.float32)
        done = bool(env.terminated())
        step += 1
        ended = done or step >= cfg.max_episode_length
        replay = push(replay, obs, ai, r, op, done, ended)
        obs = op
        if ended:
            env.reset()
            obs = np.asarray(env.observe(), np.float32)
            step = 0
    if cfg.recurrence:
        # drop partial populate episodes so training episodes don't
        # concatenate onto them (same guard as the functional path)
        replay = buffer.reset_in_progress(replay)

    # --- training loop ---
    env.reset()
    policy.reset_state()
    obs = np.asarray(env.observe(), np.float32)
    step = 0
    saved_mean_reward = -math.inf
    scores_eval = -math.inf
    model_saved = eval_next = save_next = False
    loss_val = grad_val = 0.0
    a_index = {a: i for i, a in enumerate(action_map)}

    custom_explore = eps_fn is None
    for t in range(1, cfg.max_steps + 1):
        if custom_explore:
            # reference-style function-valued strategy
            # (src/exploration_policy.jl:10-12): f(policy, env, obs, t, rng)
            act, _eps = solver.exploration_policy(policy, env, obs, t, rng)
            ai = a_index[act]
        else:
            eps = float(jnp.asarray(eps_fn(jnp.asarray(t))))
            if rng.rand() < eps:
                ai = rng.randint(len(action_map))
            else:
                ai = a_index[policy.action(obs)]
        r = float(env.act(action_map[ai]))
        op = np.asarray(env.observe(), np.float32)
        done = bool(env.terminated())
        step += 1
        ended = done or step >= cfg.max_episode_length
        replay = push(replay, obs, ai, r, op, done, ended)
        obs = op

        if ended:
            if eval_next:
                scores_eval, _steps, _info = _run_eval(
                    solver, policy, env, cfg
                )
                eval_next = False
                if save_next:
                    model_saved, saved_mean_reward = checkpoint.save_model(
                        solver.logdir, policy.params, scores_eval,
                        saved_mean_reward, model_saved, cfg.verbose,
                    )
                    save_next = False
            env.reset()
            policy.reset_state()
            obs = np.asarray(env.observe(), np.float32)
            step = 0

        if t % cfg.train_freq == 0:
            k_learn, k = jax.random.split(k_learn)
            res = train_step(params, target_params, opt_state, replay, k)
            params, opt_state, replay = res.params, res.opt_state, res.replay_state
            loss_val, grad_val = float(res.loss), float(res.grad_norm)
            policy.params = params
        if t % cfg.target_update_freq == 0:
            target_params = params
        if t % cfg.eval_freq == 0:
            eval_next = True
        if t % cfg.save_freq == 0:
            save_next = True
        if t % cfg.log_freq == 0:
            if logger is not None:
                logger.log_value("loss", loss_val, step=t)
                logger.log_value("grad_val", grad_val, step=t)
                logger.log_value("eval_reward", scores_eval, step=t)
            if cfg.verbose:
                print(
                    f"{t:5d} / {cfg.max_steps:5d} | Loss {loss_val:2.3e} | "
                    f"Grad {grad_val:2.3e} | EvalR {scores_eval:1.3f}"
                )

    if model_saved and solver.logdir is not None:
        if cfg.verbose:
            print(f"Restore model with eval reward {saved_mean_reward:1.3f}")
        policy.params = checkpoint.load_params(solver.logdir, params)
    return policy


def _make_host_buffer(solver, obs_shape):
    from ..replay.episode import EpisodeReplayBuffer
    from ..replay.prioritized import PrioritizedReplayBuffer

    cfg = solver.config
    if cfg.recurrence:
        return EpisodeReplayBuffer(
            obs_shape, cfg.buffer_size, cfg.batch_size, cfg.trace_length,
            cfg.max_episode_length, num_envs=1,
        )
    return PrioritizedReplayBuffer(
        obs_shape, cfg.buffer_size, cfg.batch_size,
        alpha=cfg.prioritized_replay_alpha, beta=cfg.prioritized_replay_beta,
        eps=cfg.prioritized_replay_epsilon, prioritized=cfg.prioritized_replay,
    )
