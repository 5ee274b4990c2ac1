"""Compute-bound benchmark: image-observation DQN through a Conv2D stack,
with analytic model-FLOP accounting and the share of the card's peak.

The headline bench (bench.py) is a 2->64->64->4 MLP, latency-bound by
design; this bench is the FLOP-bound half: the reference benchmark's own
image sweep shape ((20,20) observations x 4 stacked frames,
``benchmark/flux_dqn.jl:46-52`` / ``test/test_env.jl:52-58`` of the
reference) through a conv stack, in bf16 and f32.

Accounting (MACs x 2, analytic):
  collect   : num_envs x fwd per lockstep step (online-net inference)
  train     : per sub-update B x fwd x (2 [s+s' online] + 1 [target,
              amortized from the once-per-group U*B pass] + 2 [backward of
              the differentiated s pass])
MFU = achieved model FLOP/s / the card's dense bf16 peak (``PEAKS``). f32
runs are reported against the same peak: their matmuls run in TF32 or
float32, both below the bf16 rate.

Each rep runs ``BENCH_ITERS`` iterations in one jitted scan and ends in
``jax.block_until_ready`` on the whole carry; the per-iteration time is the
median over ``BENCH_REPS`` reps divided by the iterations. Needs an NVIDIA
GPU listed in ``PEAKS``; fails otherwise.

Run: ``python scripts/conv_bench.py``. Prints one JSON line per dtype.
"""
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# Published dense peaks per device_kind (NVIDIA H100 data sheet, SXM part,
# without sparsity, at the full 700 W power limit). A card missing here is
# an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peak_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {device_kind!r}; "
                       f"add it to PEAKS with its source")
    return PEAKS[device_kind]


def fwd_flops(network, obs_shape):
    """Analytic forward FLOPs (2 x MACs) per sample; returns (flops, out_dim)."""
    from deepqlearning_tpu.models.chain import (
        Activation, Chain, Conv2D, Dense, Flatten,
    )
    from deepqlearning_tpu.models.dueling import DuelingNetwork

    def chain_flops(chain, shape):
        fl = 0
        for layer in chain.layers:
            if isinstance(layer, Conv2D):
                h, w, _ = shape
                sh, sw = layer.stride
                ho, wo = -(-h // sh), -(-w // sw)  # SAME padding
                kh, kw = layer.kernel
                fl += 2 * ho * wo * kh * kw * layer.in_channels * layer.out_channels
                shape = (ho, wo, layer.out_channels)
            elif isinstance(layer, Dense):
                fl += 2 * layer.in_dim * layer.out_dim
                shape = (layer.out_dim,)
            elif isinstance(layer, (Flatten, Activation)):
                if isinstance(layer, Flatten):
                    n = 1
                    for s in shape:
                        n *= s
                    shape = (n,)
            else:
                raise ValueError(f"no FLOP model for {layer}")
        return fl, shape

    if isinstance(network, DuelingNetwork):
        fb, shape = chain_flops(network.base, obs_shape)
        fv, _ = chain_flops(network.val, shape)
        fa, _ = chain_flops(network.adv, shape)
        return fb + fv + fa
    fl, _ = chain_flops(network, obs_shape)
    return fl


def run_one(dtype_name, dev):
    from deepqlearning_tpu import (
        Chain, DQNConfig, Dense, TestMDP, create_dueling_network,
    )
    from deepqlearning_tpu.models.chain import Activation, Conv2D, Flatten
    from deepqlearning_tpu.learner.actor import init_actor
    from deepqlearning_tpu.learner.loop import LoopCarry, build_loop
    from deepqlearning_tpu.replay.prioritized import PrioritizedReplayBuffer
    from deepqlearning_tpu.solver.exploration import LinearDecaySchedule
    from deepqlearning_tpu.utils.profiling import (
        gpu_name_and_power_limit,
        time_calls,
    )

    peak = peak_for(dev.device_kind)
    dtype = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    num_envs = int(os.environ.get("BENCH_ENVS", "4096"))
    batch_size = 1024
    train_freq = 512          # 8 sub-updates per 4096-env lockstep step
    n_iters = int(os.environ.get("BENCH_ITERS", "30"))
    reps = int(os.environ.get("BENCH_REPS", "10"))

    env = TestMDP((20, 20), 4, 6)  # obs (20, 20, 4), the reference sweep shape
    relu = jax.nn.relu
    layers = [
        Conv2D(4, 32, (3, 3), (1, 1), "SAME", relu),
        Conv2D(32, 64, (3, 3), (2, 2), "SAME", relu),
        Conv2D(64, 128, (3, 3), (2, 2), "SAME", relu),
        Flatten(),
        Dense(5 * 5 * 128, 512, relu),
        Dense(512, env.num_actions),
    ]
    if dtype_name == "bf16":
        # cast at the network input so every conv and matmul runs
        # bf16 x bf16 -> f32-accumulate
        layers.insert(0, Activation(lambda x: x.astype(jnp.bfloat16)))
    network = create_dueling_network(Chain(*layers))
    flops = fwd_flops(network, env.obs_shape)

    cfg = DQNConfig(
        num_envs=num_envs, batch_size=batch_size, buffer_size=32768,
        train_freq=train_freq, max_episode_length=6, double_q=True,
        prioritized_replay=True, dtype=dtype,
    )
    buffer = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size,
        alpha=cfg.prioritized_replay_alpha, beta=cfg.prioritized_replay_beta,
        eps=cfg.prioritized_replay_epsilon, prioritized=True, obs_dtype=dtype,
    )
    iteration, populate_step, optimizer = build_loop(
        env, network, buffer, cfg, LinearDecaySchedule(1.0, 0.01, 100_000),
        gamma=env.discount,
    )

    key = jax.random.PRNGKey(0)
    k_init, k_act, k_learn = jax.random.split(key, 3)
    params = network.init(k_init, dtype=dtype)
    carry = LoopCarry(
        actor=init_actor(env, network, num_envs, k_act),
        replay=buffer.init(), params=params,
        target_params=params,
        opt_state=optimizer.init(params), lkey=k_learn,
        loss=jnp.asarray(0.0), gnorm=jnp.asarray(0.0),
        sync_acc=jnp.asarray(0, jnp.int32),
    )

    @jax.jit
    def populate(carry):
        actor, replay, params = carry.actor, carry.replay, carry.params
        (actor, replay, params), _ = jax.lax.scan(
            populate_step, (actor, replay, params), None, length=2
        )
        return carry._replace(actor=actor, replay=replay)

    @jax.jit
    def run(carry):
        carry, _ = jax.lax.scan(iteration, carry, None, length=n_iters)
        return carry

    _, secs = time_calls(run, populate(carry), reps)
    per_iter = statistics.median(secs) / n_iters

    U = cfg.updates_per_iter
    collect_fl = cfg.env_steps_per_iter * flops
    train_fl = U * batch_size * 5 * flops
    achieved = (collect_fl + train_fl) / per_iter
    print(json.dumps({
        "metric": "conv_model_flops",
        "value": achieved / 1e12,
        "unit": "TFLOP/s",
        "dtype": dtype_name,
        "mfu_vs_bf16_peak": achieved / peak["bf16_flops"],
        "env_steps_per_s": cfg.env_steps_per_iter / per_iter,
        "updates_per_s": U / per_iter,
        "fwd_flops_per_sample": flops,
        "reps": reps, "iters_per_rep": n_iters,
        "config": (f"{num_envs} envs, obs (20,20,4), conv 32-64-128 + "
                   f"dueling dense 3200-512-|A|, batch {batch_size}, "
                   f"{U} updates/iter"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": gpu_name_and_power_limit(),
    }))


def main():
    from deepqlearning_tpu.utils.compile_cache import enable_compile_cache
    from deepqlearning_tpu.utils.profiling import require_gpu

    dev = require_gpu()
    enable_compile_cache()
    for dtype_name in os.environ.get("BENCH_DTYPES", "bf16,f32").split(","):
        run_one(dtype_name.strip(), dev)


if __name__ == "__main__":
    main()
