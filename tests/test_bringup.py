"""What the GPU bring-up relies on, checked on the CPU: the package imports
without flax or msgpack, the compile cache lands where the environment or the
checkout says, and ``chip_smoke.py`` refuses a process without a GPU."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_without_flax_or_msgpack():
    code = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "msgpack"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import deepqlearning_tpu
import deepqlearning_tpu.solver.checkpoint
import deepqlearning_tpu.learner.loop
import deepqlearning_tpu.parallel.mesh
import deepqlearning_tpu.parallel.multihost
import chip_smoke
assert not any(m.split(".")[0] in ("flax", "msgpack") for m in sys.modules)
print("IMPORT_OK")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORT_OK" in out.stdout


def test_compile_cache_defaults_to_checkout(tmp_path):
    code = """
import jax
from deepqlearning_tpu.utils import compile_cache as cc
d = cc.enable_compile_cache()
print(repr(d))
print(repr(jax.config.jax_compilation_cache_dir))
"""
    out = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr[-3000:]
    want = repr(os.path.join(REPO, ".jax_cache"))
    assert out.stdout.split() == [want, want]


def test_compile_cache_follows_environment(tmp_path):
    cache = str(tmp_path / "cache")
    code = """
import jax, jax.numpy as jnp
from deepqlearning_tpu.utils import compile_cache as cc
d = cc.enable_compile_cache()
print(repr(d))
print(repr(jax.config.jax_compilation_cache_dir))
jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)).block_until_ready()
"""
    out = _run(code, env_extra={
        "JAX_COMPILATION_CACHE_DIR": cache,
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0",
    })
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == [repr(cache), repr(cache)]
    # the program compiled something, and its cache went where the
    # environment said
    assert os.listdir(cache)


def test_chip_smoke_refuses_cpu_process():
    import chip_smoke

    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.check_device()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
