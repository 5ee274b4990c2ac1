"""End-to-end learning tests — the reference's test matrix
(``test/runtests.jl:45-163``, SURVEY.md §4): each testset trains on a small
problem with a known optimum and asserts a mean-return threshold from greedy
rollouts. TestMDP optimum is 2.1 (``test/test_env.jl:7``); threshold 1.5 as
in the reference.
"""
import jax
import jax.numpy as jnp
import pytest

from deepqlearning_tpu import (
    Chain,
    DeepQLearningSolver,
    Dense,
    EpsGreedyPolicy,
    Flatten,
    LinearDecaySchedule,
    LSTM,
    SimpleGridWorld,
    TestMDP,
    TigerPOMDP,
)
from deepqlearning_tpu.solver.evaluation import basic_evaluation


def evaluate(env, policy, key, n_ep=100, max_steps=100):
    r, _, _ = basic_evaluation(policy.network, policy.params, env, n_ep,
                               max_steps, key)
    return r


def _solver(model, max_steps=10000, **kw):
    defaults = dict(
        qnetwork=model, max_steps=max_steps, learning_rate=0.005,
        eval_freq=2000, num_ep_eval=100, log_freq=2000, logdir=None,
        verbose=False,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, max_steps // 2)
        ),
    )
    defaults.update(kw)
    return DeepQLearningSolver(**defaults)


def _mlp(mdp):
    return Chain(Flatten(), Dense(100, 8, jnp.tanh), Dense(8, mdp.num_actions))


# --- feed-forward matrix (test/runtests.jl:45-111) ------------------------
def test_vanilla_dqn():
    mdp = TestMDP((5, 5), 4, 6)
    solver = _solver(_mlp(mdp), double_q=False, dueling=False,
                     prioritized_replay=False)
    policy = solver.solve(mdp)
    r = evaluate(mdp, policy, jax.random.PRNGKey(7))
    assert r >= 1.5
    av = policy.actionvalues(jnp.zeros((5, 5, 4)))
    assert av.shape == (mdp.num_actions,)


def test_double_q_dqn():
    mdp = TestMDP((5, 5), 4, 6)
    solver = _solver(_mlp(mdp), double_q=True, dueling=False,
                     prioritized_replay=False)
    policy = solver.solve(mdp)
    assert evaluate(mdp, policy, jax.random.PRNGKey(7)) >= 1.5


def test_dueling_dqn():
    mdp = TestMDP((5, 5), 4, 6)
    solver = _solver(_mlp(mdp), double_q=False, dueling=True,
                     prioritized_replay=False)
    policy = solver.solve(mdp)
    assert evaluate(mdp, policy, jax.random.PRNGKey(7)) >= 1.5


def test_prioritized_ddqn():
    mdp = TestMDP((5, 5), 4, 6)
    solver = _solver(_mlp(mdp), double_q=True, dueling=True,
                     prioritized_replay=True)
    policy = solver.solve(mdp)
    assert evaluate(mdp, policy, jax.random.PRNGKey(7)) >= 1.5


# --- recurrent matrix (test/runtests.jl:115-163) --------------------------
def test_testmdp_drqn():
    mdp = TestMDP((5, 5), 1, 6)  # stack 1 => partially observable
    model = Chain(Flatten(), LSTM(25, 8), Dense(8, mdp.num_actions))
    solver = _solver(model, max_steps=6000, double_q=True, dueling=False,
                     recurrence=True, trace_length=10)
    policy = solver.solve(mdp)
    assert evaluate(mdp, policy, jax.random.PRNGKey(7)) >= 0.0


def test_gridworld_ddrqn():
    mdp = SimpleGridWorld()
    model = Chain(Flatten(), LSTM(2, 32), Dense(32, mdp.num_actions))
    solver = _solver(model, max_steps=6000, learning_rate=0.001,
                     prioritized_replay=False, recurrence=True,
                     trace_length=10, double_q=True, dueling=True)
    policy = solver.solve(mdp)
    assert evaluate(mdp, policy, jax.random.PRNGKey(7), max_steps=10) >= 0.0


def test_tiger_ddrqn_smoke():
    pomdp = TigerPOMDP(discount=0.95)
    model = Chain(Flatten(), LSTM(1, 4), Dense(4, pomdp.num_actions))
    solver = _solver(model, max_steps=2000, learning_rate=1e-4,
                     prioritized_replay=False, recurrence=True,
                     trace_length=10, double_q=True, dueling=True,
                     target_update_freq=1000)
    policy = solver.solve(pomdp)
    av = policy.actionvalues(jnp.zeros((1,)))
    assert av.shape == (pomdp.num_actions,)


# --- vectorized collection preserves learning -----------------------------
def test_vectorized_envs_learning():
    # num_envs > 1 is the vectorized extension; ratios are preserved so
    # learning matches (SURVEY.md §7 hard part (c))
    mdp = TestMDP((5, 5), 4, 6)
    solver = _solver(_mlp(mdp), double_q=True, dueling=True,
                     prioritized_replay=True, num_envs=8, train_freq=8,
                     max_steps=16000, buffer_size=4096)
    policy = solver.solve(mdp)
    assert evaluate(mdp, policy, jax.random.PRNGKey(7)) >= 1.5


def test_recurrent_populate_commits_episodes_multi_env():
    # regression: populate sizing must give every env >= max_episode_length
    # steps so episodes commit before training samples (review finding)
    mdp = SimpleGridWorld()
    model = Chain(Flatten(), LSTM(2, 8), Dense(8, mdp.num_actions))
    solver = _solver(model, max_steps=64, recurrence=True, trace_length=5,
                     num_envs=8, train_freq=8, prioritized_replay=False,
                     dueling=False, max_episode_length=20, buffer_size=64,
                     train_start=16, eval_freq=10_000)
    policy = solver.solve(mdp)  # must not train on phantom empty records
    assert policy.actionvalues(jnp.zeros(2)).shape == (mdp.num_actions,)


def test_bf16_replay_storage():
    # cfg.dtype=bfloat16 stores replay obs in bf16 (HBM halved); training
    # still learns (sampling casts back to f32)
    mdp = TestMDP((5, 5), 4, 6)
    solver = _solver(_mlp(mdp), max_steps=4000, double_q=True, dueling=False,
                     prioritized_replay=True, dtype=jnp.bfloat16)
    policy = solver.solve(mdp)
    assert evaluate(mdp, policy, jax.random.PRNGKey(7)) >= 1.0


def test_bf16_dtype_reaches_params_and_solves():
    """cfg.dtype must reach BOTH the replay storage and the network params
    (r4: solver previously initialized params f32 regardless); bf16 solve
    stays finite and produces a valid policy."""
    import jax.numpy as jnp

    from deepqlearning_tpu import (
        Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy,
        LinearDecaySchedule, SimpleGridWorld,
    )

    env = SimpleGridWorld()
    solver = DeepQLearningSolver(
        qnetwork=Chain(Dense(2, 16, jnp.tanh), Dense(16, env.num_actions)),
        max_steps=512, num_envs=16, train_freq=16, buffer_size=1024,
        train_start=128, eval_freq=512, log_freq=512, save_freq=1 << 30,
        double_q=True, dueling=False, prioritized_replay=True,
        verbose=False, logdir=None, max_episode_length=50,
        dtype=jnp.bfloat16,
        exploration_policy=EpsGreedyPolicy(LinearDecaySchedule(1.0, 0.1, 256)),
    )
    policy = solver.solve(env)
    leaf = jax.tree_util.tree_leaves(policy.params)[0]
    assert leaf.dtype == jnp.bfloat16
    assert policy.action(jnp.asarray([1.0, 1.0])) in env.action_map
