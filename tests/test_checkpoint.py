"""Checkpoint/restore tests (reference: ``src/solver.jl:290-318``)."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from deepqlearning_tpu import Chain, Dense, DeepQLearningSolver, EpsGreedyPolicy
from deepqlearning_tpu.solver import checkpoint


def test_save_load_roundtrip(tmp_path):
    net = Chain(Dense(3, 8), Dense(8, 2))
    params = net.init(jax.random.PRNGKey(0))
    checkpoint.save_params(str(tmp_path), params)
    template = net.init(jax.random.PRNGKey(1))
    loaded = checkpoint.load_params(str(tmp_path), template)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_save_model_best_gating(tmp_path):
    # save iff score >= best (src/solver.jl:290-300)
    params = {"w": jnp.ones(3)}
    saved, best = checkpoint.save_model(str(tmp_path), params, 1.0, -math.inf,
                                        False, verbose=False)
    assert saved and best == 1.0
    saved2, best2 = checkpoint.save_model(str(tmp_path), params, 0.5, best,
                                          saved, verbose=False)
    assert saved2 and best2 == 1.0  # stays saved, best unchanged
    saved3, best3 = checkpoint.save_model(str(tmp_path), params, 2.0, best2,
                                          saved2, verbose=False)
    assert best3 == 2.0


def test_solver_restore_best_model(tmp_path):
    from deepqlearning_tpu import TestMDP

    mdp = TestMDP((3,), 2, 4)
    from deepqlearning_tpu import Flatten

    model = Chain(Flatten(), Dense(6, 8, jnp.tanh), Dense(8, mdp.num_actions))
    solver = DeepQLearningSolver(
        qnetwork=model, max_steps=600, eval_freq=200, save_freq=200,
        num_ep_eval=10, log_freq=200, train_start=100, verbose=False,
        logdir=str(tmp_path),
        exploration_policy=EpsGreedyPolicy(),
    )
    policy = solver.solve(mdp)
    assert os.path.exists(os.path.join(solver.logdir, checkpoint.CKPT_NAME))
    restored = solver.restore_best_model(mdp)
    # restored params equal the checkpointed best (policy was restored too)
    for a, b in zip(jax.tree_util.tree_leaves(policy.params),
                    jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_train_state_roundtrip(tmp_path):
    carry = {"params": {"w": jnp.arange(4.0)}, "step": jnp.asarray(7)}
    checkpoint.save_train_state(str(tmp_path), carry)
    template = {"params": {"w": jnp.zeros(4)}, "step": jnp.asarray(0)}
    loaded = checkpoint.load_train_state(str(tmp_path), template)
    np.testing.assert_allclose(np.asarray(loaded["params"]["w"]),
                               np.arange(4.0))
    assert int(loaded["step"]) == 7


def test_tb_writer_produces_readable_events(tmp_path):
    from deepqlearning_tpu.utils.tb_writer import TBWriter, _masked_crc

    w = TBWriter(str(tmp_path))
    w.log_value("loss", 0.5, step=10)
    w.log_value("eval_reward", 1.5, step=20)
    w.close()
    files = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    assert len(files) == 1
    # verify TFRecord framing: length + masked crc of header
    import struct

    with open(os.path.join(tmp_path, files[0]), "rb") as f:
        data = f.read()
    off, records = 0, 0
    while off < len(data):
        header = data[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[off + 8:off + 12])
        assert crc == _masked_crc(header)
        payload = data[off + 12:off + 12 + length]
        (pcrc,) = struct.unpack("<I", data[off + 12 + length:off + 16 + length])
        assert pcrc == _masked_crc(payload)
        off += 16 + length
        records += 1
    assert records == 3  # file-version event + 2 scalars


def test_full_train_state_resume(tmp_path):
    from deepqlearning_tpu import SimpleGridWorld, EpsGreedyPolicy

    mdp = SimpleGridWorld()
    model = Chain(Dense(2, 8), Dense(8, mdp.num_actions))

    def make():
        return DeepQLearningSolver(
            qnetwork=model, max_steps=300, train_start=100, logdir=str(tmp_path),
            verbose=False, eval_freq=10_000, save_freq=10_000, log_freq=100,
            exploration_policy=EpsGreedyPolicy(),
        )

    p1 = make().solve(mdp)
    assert os.path.exists(os.path.join(str(tmp_path), checkpoint.TRAIN_STATE_NAME))
    # resume continues from the saved optimizer/replay/params
    p2 = make().solve(mdp, resume=True)
    # resumed run trained further: params differ from the checkpointed ones
    a = jax.tree_util.tree_leaves(p1.params)[0]
    b = jax.tree_util.tree_leaves(p2.params)[0]
    assert not np.allclose(np.asarray(a), np.asarray(b))


def test_npz_roundtrip_keeps_structure_dtypes_and_bits(tmp_path):
    # the .npz format restores every leaf bit-exactly, with its dtype —
    # bfloat16 params included — into the template's pytree structure
    from typing import NamedTuple

    import ml_dtypes

    class Carry(NamedTuple):
        params: dict
        step: object
        flags: object

    rng = np.random.default_rng(0)
    carry = Carry(
        params={"w": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
                "b": jnp.asarray(rng.normal(size=4), jnp.float32)},
        step=jnp.asarray(123456789, jnp.int32),
        flags=jnp.asarray([True, False, True]),
    )
    path = checkpoint.save_train_state(str(tmp_path), carry)
    assert path.endswith(".npz")
    template = jax.tree_util.tree_map(jnp.zeros_like, carry)
    loaded = checkpoint.load_train_state(str(tmp_path), template)
    assert type(loaded) is Carry
    for a, b in zip(jax.tree_util.tree_leaves(carry),
                    jax.tree_util.tree_leaves(loaded)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(loaded.params["w"]).dtype == ml_dtypes.bfloat16
    # a template of another structure is refused, not half-filled
    import pytest

    with pytest.raises(ValueError, match="different pytree"):
        checkpoint.load_train_state(str(tmp_path), {"params": template.params})


def test_legacy_msgpack_checkpoint_refused(tmp_path):
    # a checkpoint in the earlier msgpack format is refused with an error
    # that names the format, for both the best model and the train state
    import pytest

    for name in ("qnetwork.msgpack", "train_state.msgpack"):
        (tmp_path / name).write_bytes(b"\x82\xa1w\x93\x01\x02\x03")
    net = Chain(Dense(3, 8), Dense(8, 2))
    with pytest.raises(ValueError, match="msgpack"):
        checkpoint.load_params(str(tmp_path), net.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="msgpack"):
        checkpoint.load_train_state(str(tmp_path), {"w": jnp.zeros(3)})
    # bytes that are not an .npz at the .npz path are refused as well
    (tmp_path / checkpoint.CKPT_NAME).write_bytes(b"\x82\xa1w\x93\x01")
    with pytest.raises(ValueError, match="npz"):
        checkpoint.load_params(str(tmp_path), net.init(jax.random.PRNGKey(0)))


def test_full_train_state_resume_recurrent(tmp_path):
    """Resume on the DRQN path: the episode ring (r4 merged shadow-row
    layout), its index records, and the recurrent actor state must all
    roundtrip through the .npz train-state checkpoint."""
    from deepqlearning_tpu import LSTM, EpsGreedyPolicy, SimpleGridWorld

    mdp = SimpleGridWorld()

    def make():
        return DeepQLearningSolver(
            qnetwork=Chain(LSTM(2, 8), Dense(8, mdp.num_actions)),
            max_steps=400, num_envs=8, train_freq=32, buffer_size=64,
            train_start=64, trace_length=5, recurrence=True, dueling=False,
            max_episode_length=20, logdir=str(tmp_path), verbose=False,
            eval_freq=10_000, save_freq=200, log_freq=200,
            exploration_policy=EpsGreedyPolicy(),
        )

    p1 = make().solve(mdp)
    assert os.path.exists(os.path.join(str(tmp_path),
                                       checkpoint.TRAIN_STATE_NAME))
    p2 = make().solve(mdp, resume=True)
    a = jax.tree_util.tree_leaves(p1.params)[0]
    b = jax.tree_util.tree_leaves(p2.params)[0]
    assert not np.allclose(np.asarray(a), np.asarray(b))
