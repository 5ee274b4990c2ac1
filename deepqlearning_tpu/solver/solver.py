"""DeepQLearningSolver — training orchestrator.

The vectorized reshape of the reference solver (``src/solver.jl``): the
mutable single-env step loop (``dqn_train!``, ``src/solver.jl:59-178``)
becomes a pure jitted *iteration* = (scan of E lockstep env steps → replay
insert → K fused train updates → conditional target sync), scanned into
*segments* between host boundaries. The host loop only evaluates, logs,
checkpoints — exactly the reference's orchestration points, at segment
boundaries instead of episode boundaries (documented deviation, SURVEY.md
§7(d): "at next megastep boundary after eval_freq").

Config parity: every ``DeepQLearningSolver`` field of the reference
(``src/solver.jl:1-28``) exists on ``DQNConfig`` with the same default.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..config import DQNConfig
from ..envs.base import Env
from ..learner.actor import ActorState, avg_recent, init_actor
from ..learner.loop import LoopCarry, build_loop
from ..models.chain import isrecurrent
from ..models.dueling import create_dueling_network
from ..replay.episode import EpisodeReplayBuffer
from ..replay.prioritized import PrioritizedReplayBuffer
from . import checkpoint
from .evaluation import basic_evaluation, evaluation
from .exploration import ConstantEpsilon, EpsGreedyPolicy, LinearDecaySchedule
from .policy import NNPolicy


class DeepQLearningSolver:
    """Config + strategy container; ``solve(env)`` returns an ``NNPolicy``.

    ``qnetwork`` is a ``Chain`` (or ``DuelingNetwork``); ``exploration_policy``
    is an ``EpsGreedyPolicy`` (or any object with a jit-traceable
    ``eps(t)``); ``evaluation_policy`` follows the reference's pluggable
    signature (``src/evaluation_policy.jl:10-12``).
    """

    def __init__(
        self,
        qnetwork=None,
        exploration_policy=None,
        evaluation_policy=basic_evaluation,
        **config_kwargs,
    ):
        self.config = DQNConfig(**config_kwargs)
        self.qnetwork = qnetwork
        if exploration_policy is None:
            exploration_policy = EpsGreedyPolicy(
                LinearDecaySchedule(1.0, 0.01, max(1, self.config.max_steps // 2))
            )
        self.exploration_policy = exploration_policy
        self.evaluation_policy = evaluation_policy
        self.logdir = self.config.logdir
        self.metrics: dict = {"t": [], "loss": [], "grad": [], "avg100": [], "eval": []}

    # ------------------------------------------------------------------
    def _build_network(self):
        network = self.qnetwork
        if isrecurrent(network) and not self.config.recurrence:
            raise ValueError(
                "DeepQLearningError: you passed in a recurrent model but "
                "recurrence is set to false"
            )
        if self.config.dueling:
            network = create_dueling_network(network)
        return network

    def _build_buffer(self, env: Env):
        cfg = self.config
        if cfg.recurrence:
            return EpisodeReplayBuffer(
                env.obs_shape,
                cfg.buffer_size,
                cfg.batch_size,
                cfg.trace_length,
                cfg.max_episode_length,
                num_envs=cfg.num_envs,
                obs_dtype=cfg.dtype,
            )
        return PrioritizedReplayBuffer(
            env.obs_shape,
            cfg.buffer_size,
            cfg.batch_size,
            alpha=cfg.prioritized_replay_alpha,
            beta=cfg.prioritized_replay_beta,
            eps=cfg.prioritized_replay_epsilon,
            prioritized=cfg.prioritized_replay,
            obs_dtype=cfg.dtype,
            sample_mode=cfg.prioritized_sample_mode,
        )

    # ------------------------------------------------------------------
    def solve(self, env, resume: bool = False) -> NNPolicy:
        """Train and return the greedy policy.

        ``resume=True`` restores the full training state (params, target,
        optimizer, replay, actor) saved in ``logdir`` by a previous solve and
        continues for another ``max_steps`` — a true-resume extension the
        reference lacks (its checkpoints are best-model params only,
        SURVEY.md §5.4).
        """
        from ..envs.compat import HostEnv, solve_host  # circular-safe import

        if isinstance(env, HostEnv):
            return solve_host(self, env)
        if not isinstance(env, Env):
            # auto-wrap raw FunctionalMDP/POMDP problems, matching the
            # reference's POMDPs.solve dispatch which accepts an MDP/POMDP
            # directly and wraps it (src/solver.jl:30-38)
            from ..envs.adapters import MDPEnv, POMDPEnv, check_requirements

            if callable(getattr(env, "observation", None)) and callable(
                getattr(env, "convert_o", None)
            ):
                check_requirements(env, pomdp=True)
                env = POMDPEnv(env)
            elif callable(getattr(env, "initial_state", None)) and callable(
                getattr(env, "gen", None)
            ):
                check_requirements(env, pomdp=False)
                env = MDPEnv(env)
            else:
                raise TypeError(
                    "solve expects a functional Env, a HostEnv, or a "
                    "FunctionalMDP/POMDP problem object; got "
                    f"{type(env).__name__}"
                )
        return self._solve_functional(env, resume=resume)

    # ------------------------------------------------------------------
    def _solve_functional(self, env: Env, resume: bool = False) -> NNPolicy:
        cfg = self.config
        network = self._build_network()
        buffer = self._build_buffer(env)
        gamma = float(env.discount)

        key = jax.random.PRNGKey(cfg.seed)
        k_init, k_pop, k_actor, k_eval, k_learn = jax.random.split(key, 5)
        # cfg.dtype reaches BOTH the replay storage (_build_buffer) and the
        # network parameters — bf16 params run conv stacks as bf16 x bf16
        # products with f32 accumulation (scripts/conv_bench.py)
        params = network.init(k_init, cfg.dtype)
        target_params = params

        ep = self.exploration_policy
        select_fn = ep.select if hasattr(ep, "select") else None
        if callable(getattr(ep, "eps", None)):
            # EpsGreedyPolicy / VectorizedStrategy expose eps(t) as a method;
            # ConstantEpsilon's `eps` is a float *field* and must fall through
            # to the schedule-object branch below (callable() gates that)
            eps_fn = ep.eps
        elif isinstance(ep, (LinearDecaySchedule, ConstantEpsilon)):
            eps_fn = ep
        elif select_fn is not None:
            # custom strategy without an ε schedule: log ε as 0
            eps_fn = lambda t: jnp.asarray(0.0, jnp.float32)
        else:
            raise TypeError(
                "the jitted vectorized path needs a schedule-based "
                "exploration policy (EpsGreedyPolicy / LinearDecaySchedule / "
                "ConstantEpsilon) or a VectorizedStrategy with the "
                "jit-traceable select(q_values, t, key) -> (actions, eps) "
                "protocol; bare function-valued strategies "
                "f(policy, env, obs, t, rng) are supported on the HostEnv "
                "path (src/exploration_policy.jl:10-12 parity)"
            )
        iteration, populate_step, optimizer = build_loop(
            env, network, buffer, cfg, eps_fn, gamma, select_fn=select_fn
        )
        opt_state = optimizer.init(params)

        # --- pre-fill replay with a random policy
        # (initialize_replay_buffer, src/solver.jl:180-189) ---
        replay = buffer.init()
        pop_actor = init_actor(env, network, cfg.num_envs, k_pop)
        n_pop = -(-cfg.train_start // cfg.num_envs)
        if cfg.recurrence:
            # every env must commit at least one episode before sampling; the
            # random policy commits on done or truncation, so run each env
            # for at least max_episode_length+1 lockstep steps
            n_pop = max(n_pop, cfg.max_episode_length + 1)

        @jax.jit
        def populate(actor, replay, params):
            (actor, replay, params), _ = jax.lax.scan(
                populate_step, (actor, replay, params), None, length=n_pop
            )
            return actor, replay

        _, replay = populate(pop_actor, replay, params)
        if cfg.recurrence:
            replay = buffer.reset_in_progress(replay)

        @functools.partial(jax.jit, static_argnums=(1,))
        def run_segment(carry, n_iters):
            carry, _ = jax.lax.scan(iteration, carry, None, length=n_iters)
            return carry

        # --- host loop: segments between log/eval/save boundaries ---
        actor = init_actor(env, network, cfg.num_envs, k_actor)
        carry = LoopCarry(
            actor, replay, params, target_params, opt_state, k_learn,
            jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0, jnp.int32),
        )
        if resume:
            # true resume: params + target + optimizer + replay + actor state
            # (extension over the reference, which can only restore best
            # weights — SURVEY.md §5.4)
            carry = checkpoint.load_train_state(self.logdir, carry)
        spi = cfg.env_steps_per_iter
        seg_env_steps = max(spi, min(cfg.log_freq, cfg.eval_freq, cfg.save_freq))
        seg_iters = max(1, seg_env_steps // spi)
        total_iters = max(1, -(-cfg.max_steps // spi))

        logger = None
        if self.logdir is not None:
            from ..utils.tb_writer import TBWriter

            logger = TBWriter(self.logdir)
            self.logdir = logger.logdir

        saved_mean_reward = -math.inf
        scores_eval = -math.inf
        model_saved = False
        eval_next = False
        save_next = False
        eval_key = k_eval

        import time as _time

        def crossed(freq, t0, t1):
            return t1 // freq > t0 // freq

        done_iters = 0
        seg_s = None
        while done_iters < total_iters:
            n = min(seg_iters, total_iters - done_iters)
            _seg_t0 = _time.perf_counter()
            carry = run_segment(carry, n)
            jax.block_until_ready(carry.loss)
            seg_s = _time.perf_counter() - _seg_t0
            done_iters += n
            actor = carry.actor
            t0 = (done_iters - n) * spi
            t1 = done_iters * spi

            if crossed(cfg.eval_freq, t0, t1):
                eval_next = True
            if crossed(cfg.save_freq, t0, t1):
                save_next = True

            if eval_next:  # deferred-eval semantics (src/solver.jl:101-122)
                eval_key, k = jax.random.split(eval_key)
                scores_eval, steps_eval, info_eval = evaluation(
                    self.evaluation_policy, network, carry.params, env,
                    cfg.num_ep_eval, cfg.max_episode_length, k, cfg.verbose,
                )
                eval_next = False
                if save_next:
                    model_saved, saved_mean_reward = checkpoint.save_model(
                        self.logdir, carry.params, scores_eval, saved_mean_reward,
                        model_saved, cfg.verbose,
                    )
                    save_next = False
                if logger is not None:
                    logger.log_value("eval_reward", scores_eval, step=t1)
                    logger.log_value("eval_steps", steps_eval, step=t1)
                    for mk, mv in info_eval.items():
                        logger.log_value(mk, mv, step=t1)
                self.metrics["eval"].append((t1, scores_eval))

            if crossed(cfg.log_freq, t0, t1):
                sps = (n * spi / seg_s) if seg_s else 0.0
                loss_val = float(carry.loss)
                grad_val = float(carry.gnorm)
                avg100 = float(avg_recent(actor.ret_ring, actor.cnt_ring))
                eps_val = float(jnp.asarray(eps_fn(jnp.asarray(t1))))
                self.metrics["t"].append(t1)
                self.metrics["loss"].append(loss_val)
                self.metrics["grad"].append(grad_val)
                self.metrics["avg100"].append(avg100)
                if logger is not None:
                    logger.log_value("eps", eps_val, step=t1)
                    logger.log_value("avg_reward", avg100, step=t1)
                    logger.log_value("loss", loss_val, step=t1)
                    logger.log_value("grad_val", grad_val, step=t1)
                    logger.log_value("env_steps_per_s", sps, step=t1)
                if cfg.verbose:
                    print(
                        f"{t1:5d} / {cfg.max_steps:5d} eps {eps_val:0.3f} | "
                        f"avgR {avg100:1.3f} | Loss {loss_val:2.3e} | "
                        f"Grad {grad_val:2.3e} | EvalR {scores_eval:1.3f} | "
                        f"{sps:,.0f} steps/s"
                    )

        if self.logdir is not None:
            checkpoint.save_train_state(self.logdir, carry)

        params = carry.params
        if model_saved and self.logdir is not None:
            if cfg.verbose:
                print(f"Restore model with eval reward {saved_mean_reward:1.3f}")
            params = checkpoint.load_params(self.logdir, params)

        return NNPolicy(
            env, network, params, env.action_map, len(env.obs_shape)
        )

    # ------------------------------------------------------------------
    def restore_best_model(self, env) -> NNPolicy:
        """Rebuild the policy and load the best saved weights
        (``restore_best_model``, ``src/solver.jl:302-318``)."""
        network = self._build_network()
        params = network.init(jax.random.PRNGKey(self.config.seed))
        params = checkpoint.load_params(self.logdir, params)
        return NNPolicy(env, network, params, env.action_map, len(env.obs_shape))


def solve(solver: DeepQLearningSolver, env) -> NNPolicy:
    """Functional entry point, parity with ``POMDPs.solve`` (``src/solver.jl:30-57``)."""
    return solver.solve(env)


def restore_best_model(solver: DeepQLearningSolver, env) -> NNPolicy:
    return solver.restore_best_model(env)
