"""deepqlearning_tpu — a vectorized deep Q-learning framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
JuliaPOMDP/DeepQLearning.jl (reference mounted at /root/reference): vanilla /
double / dueling / prioritized DQN and recurrent DRQN, pure-functional
vectorized environments, HBM sum-tree replay, fused jitted train steps, and
data-parallel scaling over a device mesh.

The public surface mirrors the reference export list
(``src/DeepQLearning.jl:19-33``) plus the vectorized extensions.
"""

from .config import DQNConfig
from .models.chain import (
    Activation,
    Chain,
    Conv2D,
    Dense,
    Flatten,
    GRU,
    LSTM,
    isrecurrent,
)
from .models.dueling import DuelingNetwork, create_dueling_network
from .ops.helpers import batch_trajectories, flattenbatch, globalnorm, huber_loss
from .replay.transition import DQExperience, TransitionBatch
from .replay.prioritized import PrioritizedReplayBuffer, ReplayBuffer, ReplayState
from .replay.episode import EpisodeBatch, EpisodeReplayBuffer, EpisodeReplayState
from .envs.base import Env
from .envs.test_mdp import TestMDP
from .envs.gridworld import SimpleGridWorld
from .envs.tiger import TigerPOMDP
from .envs.cartpole import CartPole
from .envs.mountain_car import MountainCar
from .envs.acrobot import Acrobot
from .envs.adapters import MDPEnv, POMDPEnv
from .envs.compat import HostEnv
from .solver.exploration import (
    ConstantEpsilon,
    EpsGreedyPolicy,
    LinearDecaySchedule,
    VectorizedStrategy,
    epsilon_greedy_select,
    exploration,
    linear_epsilon_greedy,
)
from .solver.evaluation import basic_evaluation, evaluation
from .solver.policy import AbstractNNPolicy, NNPolicy, getnetwork, resetstate
from .solver.solver import DeepQLearningSolver, restore_best_model, solve

__all__ = [
    # solver
    "DeepQLearningSolver", "DQNConfig", "solve", "restore_best_model",
    # policy
    "AbstractNNPolicy", "NNPolicy", "getnetwork", "resetstate",
    # replay
    "DQExperience", "TransitionBatch", "PrioritizedReplayBuffer",
    "ReplayBuffer", "ReplayState", "EpisodeReplayBuffer", "EpisodeReplayState",
    "EpisodeBatch",
    # models
    "Chain", "Dense", "LSTM", "GRU", "Conv2D", "Flatten", "Activation", "DuelingNetwork",
    "create_dueling_network", "isrecurrent",
    # helpers
    "flattenbatch", "huber_loss", "batch_trajectories", "globalnorm",
    # envs
    "Env", "HostEnv", "MDPEnv", "POMDPEnv", "TestMDP", "SimpleGridWorld",
    "TigerPOMDP", "CartPole", "MountainCar", "Acrobot",
    # exploration / evaluation
    "EpsGreedyPolicy", "LinearDecaySchedule", "ConstantEpsilon",
    "VectorizedStrategy", "epsilon_greedy_select",
    "linear_epsilon_greedy", "exploration", "basic_evaluation", "evaluation",
]

__version__ = "0.1.0"
