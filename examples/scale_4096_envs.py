"""Scaled collection: 4096 lockstep envs on one chip, data-parallel-ready.

Same learning problem as gridworld_dqn.py, but collection runs 4096 envs per
step with aggregate-step frequencies preserved (train_freq in env steps).
On a multi-GPU mesh, wrap the same loop with ``parallel.DataParallelRunner``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deepqlearning_tpu import (
    Chain,
    DeepQLearningSolver,
    Dense,
    EpsGreedyPolicy,
    LinearDecaySchedule,
    SimpleGridWorld,
)

mdp = SimpleGridWorld()
model = Chain(Dense(2, 64), Dense(64, mdp.num_actions))
solver = DeepQLearningSolver(
    qnetwork=model,
    max_steps=2_000_000,          # aggregate env steps
    num_envs=4096,                # lockstep envs
    train_freq=4096,              # one fused update per sweep
    batch_size=512,
    buffer_size=1 << 17,
    eval_freq=500_000, log_freq=100_000, save_freq=1_000_000,
    learning_rate=1e-3,
    exploration_policy=EpsGreedyPolicy(LinearDecaySchedule(1.0, 0.01, 1_000_000)),
)
policy = solver.solve(mdp)
print("done;", solver.metrics["eval"])
