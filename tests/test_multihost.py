"""2-process jax.distributed test: the multi-host recipe on one machine.

Exercises ``parallel/multihost.py`` for real (VERDICT r1 weak #4): two OS
processes, 4 virtual CPU devices each, one global 8-device ``data`` mesh,
DataParallelRunner populate + train segments across the process boundary,
params asserted replicated. This is the single-machine stand-in for the
BASELINE.md 2-host target; only the transport differs between hosts.

Both processes are pinned to the CPU (``JAX_PLATFORMS=cpu``): on a machine
with one GPU, each JAX process would reserve most of the card's memory when
it first touched it, and the second would fail for want of memory.
"""
import os
import socket
import subprocess
import sys


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_training():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "scripts", "multihost_worker.py")
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_NUM_CPU_DEVICES"] = "4"

    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"OK pid={pid} local_devices=4" in out, out[-3000:]
