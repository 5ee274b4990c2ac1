"""Smoke test of the actor-learner on NVIDIA GPUs.

Drives the main path through the entry points a user calls
(``DeepQLearningSolver.solve`` and ``build_loop``) at the full width of each
model the repository supports, compares the card's numerics with the same
step at ``highest`` precision and on the host CPU, times XLA's code for each
phase of the loop, and checks that the agent learns on the card.

    python chip_smoke.py            # one card: phases 0-6
    python chip_smoke.py --gpus 4   # four cards: the data-parallel path only

Phases (one card):
  0  device, driver and compiler settings
  1  feed-forward dueling double-DQN with PER on SimpleGridWorld, 131072 envs
  2  DRQN (LSTM 32) with episode replay, 65536 envs
  3  image conv net in bf16 on TestMDP (20, 20, 4), 4096 envs
  4  numerics: card default precision vs card ``highest`` vs CPU ``highest``
  5  XLA's time for each phase of the loop (collect, sample, train steps)
  6  learning on the card: the reference's return thresholds

Every phase runs in this one process: a second JAX process on the card would
fail for want of memory. No failure is caught, so any failure exits nonzero.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
without a GPU the script exits nonzero before printing it.
"""
from __future__ import annotations

import os

# phase 4 runs the same step on the host CPU inside this process, so keep
# the CPU backend available when the environment names the platforms
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"]:
    os.environ["JAX_PLATFORMS"] += ",cpu"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from deepqlearning_tpu import (  # noqa: E402
    Activation,
    Chain,
    Conv2D,
    DeepQLearningSolver,
    Dense,
    DQNConfig,
    EpsGreedyPolicy,
    Flatten,
    LinearDecaySchedule,
    LSTM,
    SimpleGridWorld,
    TestMDP,
)
from deepqlearning_tpu.learner.actor import init_actor, make_collect_step  # noqa: E402
from deepqlearning_tpu.learner.loop import LoopCarry, build_loop  # noqa: E402
from deepqlearning_tpu.learner.train_step import (  # noqa: E402
    make_grouped_dqn_train_step,
    make_grouped_drqn_train_step,
)
from deepqlearning_tpu.ops import sumtree  # noqa: E402
from deepqlearning_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from deepqlearning_tpu.utils.profiling import (  # noqa: E402
    gpu_name_and_power_limit,
    require_gpu,
    time_calls,
)


@dataclasses.dataclass(frozen=True)
class Widths:
    """Model and loop sizes. ``FULL`` is what the script runs on the card;
    ``TINY`` rehearses the same code on the CPU in the tests."""

    ff_envs: int = 131072
    ff_hidden: int = 64
    ff_batch: int = 512
    ff_train_freq: int = 4096
    ff_buffer: int = 1 << 20
    drqn_envs: int = 65536
    drqn_hidden: int = 32
    drqn_batch: int = 512
    drqn_trace: int = 8
    drqn_train_freq: int = 4096
    drqn_buffer: int = 4096
    conv_envs: int = 4096
    conv_obs: tuple = (20, 20)
    conv_frames: int = 4
    conv_channels: tuple = (32, 64, 128)
    conv_dense: int = 512
    conv_batch: int = 1024
    conv_train_freq: int = 512
    conv_buffer: int = 32768
    solve_iters: int = 4        # loop iterations per solve() in phases 1-3
    dp_iters: int = 2           # loop iterations compared in the --gpus path
    reps: int = 20              # timed calls per phase-5 measurement
    learn_envs: int = 512
    learn_ff_steps: int = 100_000
    learn_drqn_steps: int = 150_000
    learn_big_envs: int = 32768
    learn_big_train_freq: int = 4096
    learn_big_updates: int = 1500


FULL = Widths()
TINY = Widths(
    ff_envs=64, ff_hidden=8, ff_batch=16, ff_train_freq=16, ff_buffer=1024,
    drqn_envs=32, drqn_hidden=8, drqn_batch=8, drqn_trace=4,
    drqn_train_freq=16, drqn_buffer=64,
    conv_envs=16, conv_obs=(8, 8), conv_channels=(4, 8, 8), conv_dense=16,
    conv_batch=8, conv_train_freq=4, conv_buffer=256,
    reps=2, learn_envs=32, learn_ff_steps=640, learn_drqn_steps=640,
    learn_big_envs=64, learn_big_train_freq=8, learn_big_updates=16,
)

# Phase-4 tolerances. Each compares two runs of one grouped train step from
# identical inputs; "rel" is the L2 norm of the difference over the L2 norm
# of the reference, for the loss, the parameter change the step made, and
# the new priorities of the rows it sampled.
#  * card default vs card highest: the models pass no matmul precision, so on
#    this card float32 matmuls run in TF32 (10-bit mantissa, relative error
#    about 2^-11 per product). Q-values then carry ~1e-3 relative error; TD
#    errors are differences of Q-values and lose a further factor where they
#    cancel; Adam's normalisation passes the gradient's relative error on to
#    the update. Bounds: 5e-2 on the loss and the priorities, 1e-1 on the
#    parameter change.
#  * card highest vs CPU highest: both float32; only the order of
#    summation differs (about 1e-7 per reduction, grown by depth and U
#    sequential updates). Bounds: 1e-4 on loss and priorities, 1e-3 on the
#    parameter change (Adam divides by sqrt(v), which enlarges the relative
#    error of small gradient components).
TOL_TF32 = {"loss": 5e-2, "dparams": 1e-1, "prio": 5e-2}
TOL_F32 = {"loss": 1e-4, "dparams": 1e-3, "prio": 1e-4}
# --gpus path: the data-parallel grouped step (all-reduce of the gradients
# across the cards) against the same step on one card over four stacked
# shards (the same pmean under vmap), both at highest precision from
# identical inputs: float32 summation order only, as card vs CPU above.
TOL_DP = {"loss": 1e-4, "dparams": 1e-3, "prio": 1e-4}


def _to_bf16(x):
    return x.astype(jnp.bfloat16)


def spec(kind: str, w: Widths):
    """``(env, qnetwork, solver keyword arguments)`` of one model."""
    relu = jax.nn.relu
    if kind == "ff":
        env = SimpleGridWorld()
        h = w.ff_hidden
        chain = Chain(Flatten(), Dense(2, h, jnp.tanh), Dense(h, h, jnp.tanh),
                      Dense(h, env.num_actions))
        kw = dict(num_envs=w.ff_envs, batch_size=w.ff_batch,
                  train_freq=w.ff_train_freq, buffer_size=w.ff_buffer,
                  max_episode_length=100, double_q=True, dueling=True,
                  prioritized_replay=True, train_start=2 * w.ff_envs)
    elif kind == "drqn":
        env = SimpleGridWorld()
        h = w.drqn_hidden
        chain = Chain(LSTM(2, h), Dense(h, env.num_actions))
        kw = dict(num_envs=w.drqn_envs, batch_size=w.drqn_batch,
                  trace_length=w.drqn_trace, train_freq=w.drqn_train_freq,
                  buffer_size=w.drqn_buffer, max_episode_length=100,
                  recurrence=True, dueling=False, double_q=True,
                  train_start=w.drqn_envs)
    elif kind == "conv":
        env = TestMDP(w.conv_obs, w.conv_frames, 6)
        c1, c2, c3 = w.conv_channels
        oh, ow = (-(-(-(-s // 2)) // 2) for s in w.conv_obs)  # strides 1,2,2
        chain = Chain(
            # replay hands back bf16 rows, the actor f32 obs: cast at the
            # input so every conv and matmul runs bf16 x bf16 -> f32
            Activation(_to_bf16),
            Conv2D(w.conv_frames, c1, (3, 3), (1, 1), "SAME", relu),
            Conv2D(c1, c2, (3, 3), (2, 2), "SAME", relu),
            Conv2D(c2, c3, (3, 3), (2, 2), "SAME", relu),
            Flatten(),
            Dense(oh * ow * c3, w.conv_dense, relu),
            Dense(w.conv_dense, env.num_actions),
        )
        kw = dict(num_envs=w.conv_envs, batch_size=w.conv_batch,
                  train_freq=w.conv_train_freq, buffer_size=w.conv_buffer,
                  max_episode_length=6, double_q=True, dueling=True,
                  prioritized_replay=True, dtype=jnp.bfloat16,
                  train_start=2 * w.conv_envs)
    else:
        raise ValueError(kind)
    return env, chain, kw


def check_device(n_gpus: int = 1):
    dev = require_gpu()
    if len(jax.devices()) < n_gpus:
        raise RuntimeError(
            f"--gpus {n_gpus} needs {n_gpus} cards; JAX sees "
            f"{len(jax.devices())}")
    return dev


def _peak_bytes(dev) -> str:
    stats = dev.memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "not reported"))


def _mem_line(compiled) -> str:
    ma = compiled.memory_analysis()
    names = ("argument_size_in_bytes", "output_size_in_bytes",
             "alias_size_in_bytes", "temp_size_in_bytes",
             "generated_code_size_in_bytes")
    return " ".join(f"{n.replace('_size_in_bytes', '')}={getattr(ma, n, None)}"
                    for n in names)


def phase_device():
    dev = jax.devices()[0]
    print(f"phase0 device kind={dev.device_kind!r} platform={dev.platform} "
          f"count={len(jax.devices())}")
    print(f"phase0 nvidia-smi: {gpu_name_and_power_limit()}")
    print(f"phase0 jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision!r} "
          f"compile_cache={enable_compile_cache()}")
    return dev


# ---------------------------------------------------------------- phases 1-3
def make_solver(kind: str, w: Widths, **over) -> tuple:
    env, chain, kw = spec(kind, w)
    kw.update(over)
    spi = DQNConfig(**kw).env_steps_per_iter
    max_steps = kw.pop("max_steps", w.solve_iters * spi)
    verbose = kw.pop("verbose", True)
    kw.setdefault("eval_freq", 2 * spi)
    kw.setdefault("log_freq", 2 * spi)
    kw.setdefault("num_ep_eval", 256)
    solver = DeepQLearningSolver(
        qnetwork=chain,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, max(1, max_steps // 2))),
        max_steps=max_steps, save_freq=1 << 30, logdir=None,
        verbose=verbose, **kw,
    )
    return env, solver


def loop_parts(kind: str, w: Widths):
    """The loop ``solve`` builds, via the same ``build_loop`` entry point."""
    env, solver = make_solver(kind, w, verbose=False)
    cfg = solver.config
    network = solver._build_network()
    buffer = solver._build_buffer(env)
    ep = solver.exploration_policy
    gamma = float(env.discount)
    iteration, populate_step, optimizer = build_loop(
        env, network, buffer, cfg, ep.eps, gamma, select_fn=ep.select)
    return SimpleNamespace(kind=kind, env=env, cfg=cfg, network=network,
                           buffer=buffer, gamma=gamma, eps=ep.eps,
                           select=ep.select, iteration=iteration,
                           populate_step=populate_step, optimizer=optimizer)


def populated_carry(p, seed: int = 0) -> LoopCarry:
    cfg = p.cfg
    k_init, k_pop, k_act, k_learn = jax.random.split(jax.random.PRNGKey(seed), 4)
    params = p.network.init(k_init, cfg.dtype)
    if cfg.recurrence:
        n_pop = cfg.max_episode_length + 1
    else:
        n_pop = max(1, cfg.buffer_size // cfg.num_envs)

    @jax.jit
    def populate(actor, replay, params):
        (actor, replay, params), _ = jax.lax.scan(
            p.populate_step, (actor, replay, params), None, length=n_pop)
        return replay

    replay = populate(init_actor(p.env, p.network, cfg.num_envs, k_pop),
                      p.buffer.init(), params)
    if cfg.recurrence:
        replay = p.buffer.reset_in_progress(replay)
    # separate target buffers (the compiled loop step donates its input),
    # and metrics typed as the step returns them (it takes back its output)
    carry = LoopCarry(
        init_actor(p.env, p.network, cfg.num_envs, k_act), replay, params,
        jax.tree_util.tree_map(jnp.copy, params), p.optimizer.init(params),
        k_learn, jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32))
    out = jax.eval_shape(lambda c: p.iteration(c, None)[0], carry)
    return carry._replace(loss=jnp.zeros((), out.loss.dtype),
                          gnorm=jnp.zeros((), out.gnorm.dtype))


def phase_model(kind: str, w: Widths, dev) -> SimpleNamespace:
    """One model through ``solve()``, then its loop step compiled alone."""
    env, solver = make_solver(kind, w)
    cfg = solver.config
    t0 = time.perf_counter()
    solver.solve(env)
    wall = time.perf_counter() - t0
    losses = solver.metrics["loss"]
    evals = [r for _, r in solver.metrics["eval"]]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"{kind}: loss not finite: {losses}")
    if not evals or not np.isfinite(evals).all():
        raise AssertionError(f"{kind}: eval return not finite: {evals}")
    print(f"phase {kind}: solve() envs={cfg.num_envs} batch={cfg.batch_size} "
          f"updates_per_iter={cfg.updates_per_iter} "
          f"buffer={cfg.buffer_size} dtype={cfg.dtype} "
          f"steps={cfg.max_steps} loss={losses[-1]:.6g} eval={evals} "
          f"wall_s_incl_compile={wall:.1f}")

    p = loop_parts(kind, w)
    p.carry = populated_carry(p)
    step = jax.jit(lambda c: p.iteration(c, None)[0], donate_argnums=0)
    p.loop_step = step.lower(p.carry).compile()
    print(f"phase {kind}: loop step memory_analysis {_mem_line(p.loop_step)} "
          f"peak_bytes_in_use={_peak_bytes(dev)}")
    return p


# ------------------------------------------------------------------ phase 4
def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _run_step(step, inputs, device, precision):
    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        out = jax.jit(step)(*jax.device_put(inputs, device))
    return jax.device_get(out)


def _compare(kind, name, x, ref, inputs, tol, sampled=None):
    p0 = _flat(inputs[0])
    got = {"loss": _rel(x.loss, ref.loss),
           "dparams": _rel(_flat(x.params) - p0, _flat(ref.params) - p0)}
    if sampled is not None:
        got["prio"] = _rel(np.asarray(x.replay_state.tree[0])[sampled],
                           np.asarray(ref.replay_state.tree[0])[sampled])
    line = " ".join(f"{k}={v:.3e}(tol {tol[k]:g})" for k, v in got.items())
    print(f"phase4 {kind} {name}: {line}")
    bad = {k: v for k, v in got.items() if not v <= tol[k]}
    if bad:
        raise AssertionError(f"phase4 {kind} {name} out of tolerance: {bad}")


def phase_numerics(parts: dict, card, cpu):
    """Grouped FF and DRQN train steps from identical inputs, three ways."""
    for kind in ("ff", "drqn"):
        p = parts[kind]
        cfg, U = p.cfg, p.cfg.updates_per_iter
        if kind == "ff":
            step, _ = make_grouped_dqn_train_step(
                p.network, p.buffer, p.gamma, cfg.double_q,
                cfg.learning_rate, U)
        else:
            step, _ = make_grouped_drqn_train_step(
                p.network, p.buffer, p.gamma, cfg.double_q,
                cfg.learning_rate, U)
        c = jax.device_get(p.carry)
        key = jax.random.PRNGKey(11)
        inputs = (c.params, c.target_params, c.opt_state, c.replay, key)
        a = _run_step(step, inputs, card, None)
        b = _run_step(step, inputs, card, "highest")
        ref = _run_step(step, inputs, cpu, "highest")
        sampled = None
        if kind == "ff":
            _, idx, _ = jax.device_get(jax.jit(
                lambda r, k: p.buffer.sample_n(r, k, U))(c.replay, key))
            sampled = np.unique(np.asarray(idx))
        _compare(kind, "card-default vs card-highest", a, b, inputs,
                 TOL_TF32, sampled)
        _compare(kind, "card-highest vs cpu-highest", b, ref, inputs,
                 TOL_F32, sampled)

    # PER draws: the sum-tree lookups pin HIGHEST, so the card must pick the
    # CPU's leaves. Integer priorities make every partial sum exact in f32,
    # whatever order each backend sums in: the draws must match exactly.
    p = parts["ff"]
    U = p.cfg.updates_per_iter
    replay = jax.device_get(p.carry.replay)
    ints = np.random.default_rng(0).integers(
        1, 9, size=p.cfg.buffer_size).astype(np.float32)
    int_replay = replay._replace(tree=jax.device_get(sumtree.set_priorities(
        sumtree.init_tree(p.cfg.buffer_size),
        jnp.arange(p.cfg.buffer_size), jnp.asarray(ints))))
    key = jax.random.PRNGKey(5)
    draw = lambda r, dev: np.asarray(jax.device_get(jax.jit(
        lambda r: p.buffer.sample_n(r, key, U)[1])(jax.device_put(r, dev))))
    for name, r in (("integer priorities", int_replay),
                    ("populated priorities", replay)):
        i_card, i_cpu = draw(r, card), draw(r, cpu)
        same = float(np.mean(i_card == i_cpu))
        print(f"phase4 PER indices card vs cpu ({name}, {i_card.size} "
              f"draws): {same:.6f} identical")
        if name == "integer priorities" and same != 1.0:
            raise AssertionError("PER draws differ between card and CPU")


# ------------------------------------------------------------------ phase 5
def _stats(secs) -> str:
    q = statistics.quantiles(secs, n=4) if len(secs) > 1 else secs * 3
    return (f"median_ms={statistics.median(secs) * 1e3:.4f} "
            f"q1_ms={q[0] * 1e3:.4f} q3_ms={q[2] * 1e3:.4f} n={len(secs)}")


def phase_timing(parts: dict, w: Widths, card_line: str):
    """Separate jitted calls, each ending in block_until_ready."""
    print(f"phase5 card: {card_line}")
    for kind, p in parts.items():
        cfg, U = p.cfg, p.cfg.updates_per_iter
        carry = p.carry
        if cfg.recurrence:
            insert_fn = lambda r, tr, e, b=p.buffer: b.add_step(r, tr, e)
        else:
            insert_fn = lambda r, tr, e, b=p.buffer: b.insert(r, tr)
        collect = make_collect_step(p.env, p.network, cfg.max_episode_length,
                                    p.eps, insert_fn, select_fn=p.select)
        f = jax.jit(lambda x: collect(x, None)[0], donate_argnums=0)
        (actor, replay, params), secs = time_calls(
            f, (carry.actor, carry.replay, carry.params), w.reps)
        print(f"phase5 {kind} collect_step (E={cfg.num_envs}): {_stats(secs)}")

        key = jax.random.PRNGKey(3)
        g = jax.jit(lambda x: (x[0], p.buffer.sample_n(x[0], key, U)),
                    donate_argnums=0)
        (replay, _), secs = time_calls(
            g, (replay, p.buffer.sample_n(replay, key, U)), w.reps)
        print(f"phase5 {kind} sample_n (U*B={U * cfg.batch_size}): "
              f"{_stats(secs)}")

        make = (make_grouped_drqn_train_step if cfg.recurrence
                else make_grouped_dqn_train_step)
        ts, _ = make(p.network, p.buffer, p.gamma, cfg.double_q,
                     cfg.learning_rate, U)

        def train(x):
            params, target, opt, replay, k = x
            res = ts(params, target, opt, replay, k)
            return res.params, target, res.opt_state, res.replay_state, k

        h = jax.jit(train, donate_argnums=0)
        x, secs = time_calls(
            h, (params, carry.target_params, carry.opt_state, replay, key),
            w.reps)
        print(f"phase5 {kind} grouped_train_step (U={U}, B={cfg.batch_size}): "
              f"{_stats(secs)}")
        carry = carry._replace(actor=actor, params=x[0], target_params=x[1],
                               opt_state=x[2], replay=x[3])

        carry, secs = time_calls(p.loop_step, carry, w.reps)
        print(f"phase5 {kind} loop_step (one iteration, "
              f"{cfg.env_steps_per_iter} env steps): {_stats(secs)}")
        p.carry = carry


# ------------------------------------------------------------------ phase 6
def phase_learning(w: Widths) -> dict:
    """The learning checks of the reference's test suite, on the card."""
    out = {}
    env = SimpleGridWorld()
    common = dict(save_freq=1 << 30, logdir=None, verbose=False, seed=3,
                  learning_rate=5e-3, double_q=True, num_ep_eval=256,
                  target_update_freq=500)

    def run(name, qnetwork, max_steps, **kw):
        solver = DeepQLearningSolver(
            qnetwork=qnetwork,
            exploration_policy=EpsGreedyPolicy(
                LinearDecaySchedule(1.0, 0.01, max_steps // 2)),
            max_steps=max_steps, **{**common, **kw})
        t0 = time.perf_counter()
        solver.solve(env)
        finals = [r for _, r in solver.metrics["eval"]]
        print(f"phase6 {name}: eval returns {finals} "
              f"(wall_s_incl_compile={time.perf_counter() - t0:.1f})")
        if not finals or not np.isfinite(finals).all():
            raise AssertionError(f"{name}: eval return not finite: {finals}")
        out[name] = finals

    E = w.learn_envs
    run("ff_gridworld", Chain(Dense(2, 32, jnp.tanh),
                              Dense(32, env.num_actions)),
        w.learn_ff_steps, num_envs=E, train_freq=E // 4, batch_size=32,
        buffer_size=1 << 14, train_start=4 * E,
        eval_freq=w.learn_ff_steps // 4, log_freq=w.learn_ff_steps // 4,
        dueling=True, prioritized_replay=True, max_episode_length=100)
    run("drqn_gridworld", Chain(LSTM(2, 32), Dense(32, env.num_actions)),
        w.learn_drqn_steps, num_envs=E, train_freq=E // 4, batch_size=32,
        buffer_size=2048, train_start=4 * E,
        eval_freq=w.learn_drqn_steps // 3, log_freq=w.learn_drqn_steps // 3,
        dueling=False, recurrence=True, trace_length=8, max_episode_length=50)
    Eb, tf = w.learn_big_envs, w.learn_big_train_freq
    big_steps = w.learn_big_updates * tf
    run("ff_gridworld_wide", Chain(Flatten(), Dense(2, 64, jnp.tanh),
                                   Dense(64, 64, jnp.tanh),
                                   Dense(64, env.num_actions)),
        big_steps, num_envs=Eb, train_freq=tf, batch_size=512,
        buffer_size=1 << 18, train_start=Eb, eval_freq=big_steps // 4,
        log_freq=big_steps // 4, target_update_freq=tf * 128, dueling=True,
        prioritized_replay=True, max_episode_length=100)
    return out


# thresholds of the reference's learning tests (test/runtests.jl:45-147)
LEARN_THRESHOLDS = {"ff_gridworld": 1.0, "drqn_gridworld": 0.0,
                    "ff_gridworld_wide": 1.0}


def check_learning(results: dict):
    for name, finals in results.items():
        if max(finals) < LEARN_THRESHOLDS[name]:
            raise AssertionError(
                f"phase6 {name}: best eval {max(finals)} below "
                f"{LEARN_THRESHOLDS[name]}")
        print(f"phase6 {name}: best eval {max(finals):.4f} >= "
              f"{LEARN_THRESHOLDS[name]}")


# ------------------------------------------------------------ --gpus path
def phase_data_parallel(w: Widths, n: int):
    """The data-parallel path over ``n`` devices.

    1. ``DataParallelRunner`` runs ``w.dp_iters`` full iterations: the loss
       stays finite and the params stay equal on every card.
    2. The grouped train step of that path (``axis_name`` set: gradients
       averaged by an all-reduce across the cards) is compared with the same
       step on one card over the ``n`` stacked shards, the same ``pmean``
       under ``vmap``, from identical inputs and keys.

    The comparison is made on the train step, not on whole iterations: each
    program re-sums the sum-tree's inner nodes in its own order, and at 2^20
    leaves a float32 ulp shift of the stratum boundaries moves a large share
    of the next draws to an adjacent leaf, so whole iterations diverge far
    beyond rounding (3.2e-2 relative in the parameter change after two
    iterations on four H100s) while each program is correct.
    """
    from deepqlearning_tpu.parallel.mesh import DataParallelRunner, make_mesh
    from jax.sharding import PartitionSpec as P

    devs = jax.devices()[:n]
    mesh = make_mesh(n)
    for kind in ("ff", "drqn"):
        p = loop_parts(kind, w)
        cfg = p.cfg
        runner = DataParallelRunner(p.env, p.network, p.buffer, cfg, p.eps,
                                    p.gamma, mesh=mesh)
        ax = runner.axes[0]
        carry = runner.init_carry(jax.random.PRNGKey(0))
        n_pop = (cfg.max_episode_length + 1 if cfg.recurrence
                 else max(1, cfg.buffer_size // cfg.num_envs))
        carry = runner.run_populate(carry, n_pop)
        if cfg.recurrence:
            carry = carry._replace(replay=jax.jit(jax.vmap(
                p.buffer.reset_in_progress))(carry.replay))

        t0 = time.perf_counter()
        out = jax.block_until_ready(runner.run_segment(carry, w.dp_iters))
        t_dp = time.perf_counter() - t0
        if not np.isfinite(np.asarray(out.loss)).all():
            raise AssertionError(f"dp {kind}: loss not finite")
        for leaf in jax.tree_util.tree_leaves(jax.device_get(out.params)):
            for d in range(1, n):
                if not np.array_equal(leaf[0], leaf[d]):
                    raise AssertionError(f"dp {kind}: card {d} params differ "
                                         "from card 0")

        make = (make_grouped_drqn_train_step if cfg.recurrence
                else make_grouped_dqn_train_step)
        step, _ = make(p.network, p.buffer, p.gamma, cfg.double_q,
                       cfg.learning_rate, cfg.updates_per_iter, axis_name=ax)

        def one(params, target, opt, replay, key):
            res = step(params, target, opt, replay, key)
            return res.params, res.loss, res.replay_state

        def sharded(*xs):
            xs = jax.tree_util.tree_map(lambda x: x[0], xs)
            return jax.tree_util.tree_map(lambda x: x[None], one(*xs))

        keys = jax.random.split(jax.random.PRNGKey(9), n)
        inputs = (carry.params, carry.target_params, carry.opt_state,
                  carry.replay, keys)
        with jax.default_matmul_precision("highest"):
            dp = jax.jit(jax.shard_map(
                sharded, mesh=mesh, in_specs=P(ax), out_specs=P(ax),
                check_vma=False))(*inputs)
            ref = jax.jit(jax.vmap(one, axis_name=ax))(
                *jax.device_put(inputs, devs[0]))
        dp, ref, start = jax.device_get((dp, ref, carry.params))
        first = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
        p0 = _flat(first(start))
        got = {"loss": _rel(dp[1], ref[1]),
               "dparams": _rel(_flat(first(dp[0])) - p0,
                               _flat(first(ref[0])) - p0)}
        if not cfg.recurrence:
            got["prio"] = _rel(dp[2].tree[0], ref[2].tree[0])
        line = " ".join(f"{k}={v:.3e}(tol {TOL_DP[k]:g})"
                        for k, v in got.items())
        print(f"dp {kind}: {n} cards x {cfg.num_envs} envs; runner "
              f"{w.dp_iters} iterations x {cfg.updates_per_iter} updates, "
              f"loss finite, params equal on all cards "
              f"(wall_s_incl_compile={t_dp:.1f}); grouped step vs "
              f"stacked-shard reference: {line}")
        bad = {k: v for k, v in got.items() if not v <= TOL_DP[k]}
        if bad:
            raise AssertionError(f"dp {kind} out of tolerance: {bad}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the data-parallel path on four cards")
    args = ap.parse_args(argv)
    check_device(args.gpus)
    dev = phase_device()
    if args.gpus > 1:
        phase_data_parallel(FULL, args.gpus)
    else:
        parts = {kind: phase_model(kind, FULL, dev)
                 for kind in ("ff", "drqn", "conv")}
        phase_numerics(parts, dev, jax.devices("cpu")[0])
        phase_timing(parts, FULL, gpu_name_and_power_limit())
        check_learning(phase_learning(FULL))
        print(f"peak_bytes_in_use={_peak_bytes(dev)}")
    print(f"nvidia-smi: {gpu_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
