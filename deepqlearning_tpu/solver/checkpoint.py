"""Best-model checkpointing and full train-state resume.

Parity with the reference checkpoint story (``src/solver.jl:290-318``):
save the Q-network parameters whenever an eval score beats the best so far
(``save_model``), auto-restore the best weights at the end of training
(``src/solver.jl:170-176``), and offline ``restore_best_model`` that rebuilds
the policy and loads weights.

The serialized artifact (the BSON analog) is an ``.npz`` of the flattened
pytree, written and read by numpy alone with ``allow_pickle=False``: one
array per leaf plus the leaves' key paths and dtype names. Loading restores
into a template pytree of the same structure; a path or shape mismatch is an
error. Dtypes numpy cannot store natively (bfloat16) are stored as their
same-width unsigned-integer bits and viewed back on load.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

CKPT_NAME = "qnetwork.npz"
TRAIN_STATE_NAME = "train_state.npz"


def _save_tree(path: str, tree) -> str:
    leaves_with_paths, _ = jax.tree_util.tree_flatten_with_path(
        jax.device_get(tree))
    arrays = {}
    keys, dtypes = [], []
    for i, (kp, leaf) in enumerate(leaves_with_paths):
        arr = np.asarray(leaf)
        keys.append(jax.tree_util.keystr(kp))
        dtypes.append(arr.dtype.name)
        if arr.dtype.kind == "V":   # ml_dtypes (bfloat16, ...): store the bits
            arr = arr.view(f"u{arr.dtype.itemsize}")
        arrays[f"leaf_{i}"] = arr
    arrays["__paths__"] = np.asarray(keys, dtype=np.str_)
    arrays["__dtypes__"] = np.asarray(dtypes, dtype=np.str_)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def _refuse_legacy(path: str) -> None:
    legacy = os.path.splitext(path)[0] + ".msgpack"
    if not os.path.exists(path) and os.path.exists(legacy):
        raise ValueError(
            f"{legacy} is a msgpack (flax.serialization) checkpoint from an "
            f"earlier version; this version reads only the .npz format "
            f"({os.path.basename(path)}). Re-train or convert it."
        )


def _load_tree(path: str, template):
    _refuse_legacy(path)
    tmpl_leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jax.device_get(template))
    try:
        data = np.load(path, allow_pickle=False)
    except ValueError as e:
        raise ValueError(f"{path} is not an .npz checkpoint: {e}") from e
    with data:
        if "__paths__" not in data.files:
            raise ValueError(f"{path} is not a checkpoint written by save_*")
        paths = [str(p) for p in data["__paths__"]]
        dtypes = [str(d) for d in data["__dtypes__"]]
        want = [jax.tree_util.keystr(kp) for kp, _ in tmpl_leaves]
        if paths != want:
            raise ValueError(
                f"checkpoint {path} holds a different pytree: saved paths "
                f"{paths[:4]}... vs template {want[:4]}..."
            )
        out = []
        for i, (_, t) in enumerate(tmpl_leaves):
            arr = data[f"leaf_{i}"]
            dt = jnp.dtype(dtypes[i])
            if arr.dtype != dt:
                arr = arr.view(dt)
            if arr.shape != np.shape(t):
                raise ValueError(
                    f"checkpoint {path}: leaf {paths[i]} has shape "
                    f"{arr.shape}, template {np.shape(t)}"
                )
            out.append(arr)
    return jax.tree_util.tree_unflatten(treedef, out)


def save_params(logdir: str, params) -> str:
    os.makedirs(logdir, exist_ok=True)
    return _save_tree(os.path.join(logdir, CKPT_NAME), params)


def load_params(logdir: str, params_template):
    return _load_tree(os.path.join(logdir, CKPT_NAME), params_template)


def save_train_state(logdir: str, carry) -> str:
    """Full resume checkpoint (params + target + opt state + replay + actor).

    Extension over the reference, which saves best-model params only and
    cannot resume training (SURVEY.md §5.4).
    """
    os.makedirs(logdir, exist_ok=True)
    return _save_tree(os.path.join(logdir, TRAIN_STATE_NAME), carry)


def load_train_state(logdir: str, carry_template):
    """Restore a full training state into ``carry_template``'s structure."""
    return _load_tree(os.path.join(logdir, TRAIN_STATE_NAME), carry_template)


def save_model(logdir: Optional[str], params, scores_eval: float,
               saved_mean_reward: float, model_saved: bool,
               verbose: bool) -> Tuple[bool, float]:
    """Save iff the eval score beats (or ties) the best so far
    (``save_model``, ``src/solver.jl:290-300``)."""
    if scores_eval >= saved_mean_reward:
        if logdir is not None:
            save_params(logdir, params)
        if verbose:
            print(f"Saving new model with eval reward {scores_eval:1.3f}")
        return True, scores_eval
    return model_saved, saved_mean_reward
