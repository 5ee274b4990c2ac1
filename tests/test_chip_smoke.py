"""Rehearsal of ``chip_smoke.py``'s phases at tiny width on the CPU.

The script itself refuses to run without a GPU; these call its phase
functions directly, so a wrong path, argument or shape shows here before a
chip call is spent on it."""
import jax
import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def parts():
    dev = jax.devices()[0]
    return {kind: cs.phase_model(kind, cs.TINY, dev)
            for kind in ("ff", "drqn", "conv")}


def test_models_solve_and_compile_loop_step(parts):
    for kind, p in parts.items():
        assert p.loop_step.memory_analysis() is not None
        assert np.isfinite(float(p.carry.loss))
    assert parts["conv"].cfg.dtype == np.dtype("bfloat16")
    assert parts["drqn"].cfg.recurrence


def test_numerics_and_timing_phases(parts, capsys):
    cpu = jax.devices("cpu")[0]
    cs.phase_numerics(parts, cpu, cpu)
    cs.phase_timing(parts, cs.TINY, "cpu rehearsal")
    out = capsys.readouterr().out
    assert "phase4 PER indices card vs cpu (integer priorities" in out
    for kind in ("ff", "drqn", "conv"):
        for name in ("collect_step", "sample_n", "grouped_train_step",
                     "loop_step"):
            assert f"phase5 {kind} {name}" in out


def test_learning_and_data_parallel_phases():
    results = cs.phase_learning(cs.TINY)
    assert set(results) == set(cs.LEARN_THRESHOLDS)
    assert all(np.isfinite(v).all() for v in results.values())
    # the --gpus path on 4 of the test session's virtual CPU devices
    cs.phase_data_parallel(cs.TINY, 4)
