"""Multi-host launch: process wiring, pod-shaped meshes, per-process sizing.

The reference has no distributed story (SURVEY.md §5.8). Multi-host
here: every host runs the same program; ``initialize_multihost`` wires
``jax.distributed``; mesh builders shape the device mesh so collectives ride
ICI before DCN; ``pod_shard_plan`` does the per-process arithmetic a pod
launch actually needs (how many envs/batch rows this process owns, and
whether the requested sizes divide). The per-shard program is byte-identical
to the single-host ``DataParallelRunner`` — each process feeds its
addressable shards; gradients ``pmean`` over the data axis.

Topology note (the scaling-book recipe): a DP all-reduce over a flat device
list is lowered hierarchically by XLA only if the mesh order keeps
ICI-connected devices adjacent. ``pod_data_mesh`` builds the hybrid
(DCN x ICI) mesh first and flattens it ICI-major, so the 1-D ``data`` axis
the runner uses still reduces intra-slice over ICI and crosses DCN once per
slice — not once per chip. ``hybrid_mesh`` exposes the full 2-D mesh for
programs that want distinct in-slice / cross-slice axes.

Exercised here by the 2-process test in tests/test_multihost.py and the
simulated-mesh tests in tests/test_distributed.py; real pods are the same
code with more processes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed. Where JAX detects a cluster the arguments
    are inferred from the environment; otherwise pass all three."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def hybrid_mesh(ici_axis: str = "ici", dcn_axis: str = "dcn") -> Mesh:
    """2-D (DCN x ICI) mesh: one row per process/slice, ICI-connected chips
    along the fast axis.

    Single-process (or forced-host) environments degrade to a 1 x N mesh, so
    the same program shape compiles everywhere. Use this when you want
    separate in-slice and cross-slice collectives (e.g. hierarchical
    psum: ``psum(psum(g, ici_axis), dcn_axis)``).
    """
    n_proc = jax.process_count()
    devs = jax.devices()
    if n_proc <= 1:
        grid = np.asarray(devs).reshape(1, len(devs))
    else:
        try:
            from jax.experimental import mesh_utils

            grid = mesh_utils.create_hybrid_device_mesh(
                mesh_shape=(1, jax.local_device_count()),
                dcn_mesh_shape=(n_proc, 1),
                devices=devs,
            ).reshape(n_proc, -1)
        except Exception:
            # fallback: group by process index (ICI-contiguous per row)
            rows = [[] for _ in range(n_proc)]
            for d in devs:
                rows[d.process_index].append(d)
            grid = np.asarray(rows, dtype=object)
    return Mesh(grid, (dcn_axis, ici_axis))


def pod_data_mesh(axis_name: str = "data") -> Mesh:
    """1-D data mesh over every chip, flattened ICI-major from the hybrid
    mesh — the drop-in pod mesh for ``DataParallelRunner``.

    The flat order keeps each slice's chips contiguous, so XLA lowers the
    grad all-reduce hierarchically (ring over ICI within the slice, one DCN
    exchange across slices) instead of treating DCN and ICI links alike.
    """
    grid = hybrid_mesh().devices  # [processes, local_devices], ICI fast axis
    return Mesh(grid.reshape(-1), (axis_name,))


def global_data_mesh(axis_name: str = "data") -> Mesh:
    """1-D mesh over every chip in jax.devices() order (single-slice case;
    prefer :func:`pod_data_mesh` on multi-slice topologies)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Per-process sizing for a pod launch."""

    global_devices: int
    local_devices: int
    process_index: int
    process_count: int
    envs_per_device: int     # lockstep envs each device steps
    local_envs: int          # envs this process owns
    global_envs: int         # aggregate (= envs_per_device * global_devices)
    batch_per_device: int    # train-batch rows each device samples locally


def pod_shard_plan(global_num_envs: int, batch_size: int,
                   mesh: Optional[Mesh] = None) -> ShardPlan:
    """Size the per-process shards for a target aggregate env count.

    Validates the divisibility constraints a sharded launch silently
    miscounts otherwise: ``global_num_envs`` must divide over the devices
    (every device steps the same lockstep env block), and the per-device
    replay batch is the full ``batch_size`` (sharded replay samples locally;
    grads are averaged, so the effective global batch is
    ``batch_size * devices`` — same semantics as tests/test_distributed.py).
    """
    mesh = mesh if mesh is not None else pod_data_mesh()
    D = int(mesh.devices.size)
    if global_num_envs % D != 0:
        raise ValueError(
            f"global_num_envs={global_num_envs} must be divisible by the "
            f"{D}-device mesh (every device steps an equal lockstep block)"
        )
    per_dev = global_num_envs // D
    local = jax.local_device_count()
    return ShardPlan(
        global_devices=D,
        local_devices=local,
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        envs_per_device=per_dev,
        local_envs=per_dev * local,
        global_envs=global_num_envs,
        batch_per_device=batch_size,
    )


def local_shard_info(mesh: Mesh, axis_name: str = "data"):
    """(local_device_count, global_device_count, process_index) — the numbers
    a host loop needs to size its per-process shards."""
    return (
        jax.local_device_count(),
        mesh.devices.size,
        jax.process_index(),
    )
