"""What the package needs from its installation, and how it starts.

Each check runs in a fresh interpreter, since imports, environment
variables and JAX's platform are fixed when a process starts.
"""

import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def run(code: str, *, cwd=REPO, env=None, args=None) -> subprocess.CompletedProcess:
    full_env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})}
    return subprocess.run(
        [sys.executable, *(args or ["-c", code])],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(cwd),
        env=full_env,
    )


HIDE_JAXTYPING = """
import sys

class _Hide:
    def find_spec(self, name, path=None, target=None):
        if name == "jaxtyping" or name.startswith("jaxtyping."):
            raise ImportError("jaxtyping is hidden")
        return None

sys.meta_path.insert(0, _Hide())
"""


def test_import_without_jaxtyping() -> None:
    result = run(
        HIDE_JAXTYPING
        + """
import jax.numpy as jnp
import differt_tpu
from differt_tpu.geometry import Mesh, Scene
assert "jaxtyping" not in sys.modules
scene = Scene(
    transmitters=jnp.array([[-3.0, 0.0, 1.0]]),
    receivers=jnp.array([[3.0, 0.5, 1.0]]),
    mesh=Mesh.box(10.0, 6.0, 4.0, with_top=False),
)
print("PATHS", int(scene.trace_paths(order=1).mask.sum()))
"""
    )
    assert "PATHS" in result.stdout, result.stderr[-3000:]
    assert int(result.stdout.split("PATHS")[1]) > 0


def test_import_needs_only_the_core_packages() -> None:
    # Beyond JAX, NumPy and chex (and what those import themselves), the
    # package and its main-path modules import nothing outside the
    # standard library: plotting and download helpers stay lazy.
    result = run(
        HIDE_JAXTYPING
        + """
import jax, jax.numpy, numpy, chex
import jax.experimental.pallas
import jax.experimental.pallas.triton
before = set(sys.modules)
import differt_tpu, differt_tpu.coverage, differt_tpu.parallel, differt_tpu.scenes
import differt_tpu.ops._pallas_rt, differt_tpu.profiling, differt_tpu.compile_cache
new = {m.split(".")[0] for m in set(sys.modules) - before}
allowed = {"differt_tpu", "jax", "jaxlib", "ml_dtypes", "opt_einsum", "numpy",
           "scipy", "optax", "chex", "einops"}
print("NEW", sorted(new - set(sys.stdlib_module_names) - allowed))
"""
    )
    assert "NEW []" in result.stdout, result.stdout + result.stderr[-3000:]


def test_compile_cache_honours_the_environment(tmp_path) -> None:
    result = run(
        """
import jax
from differt_tpu.compile_cache import enable_compilation_cache
print("DIR", enable_compilation_cache())
print("CONFIG", jax.config.jax_compilation_cache_dir)
""",
        env={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
    )
    assert f"DIR {tmp_path}" in result.stdout, result.stderr[-3000:]
    assert f"CONFIG {tmp_path}" in result.stdout


def test_compile_cache_defaults_to_the_repo() -> None:
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    result = subprocess.run(
        [
            sys.executable,
            "-c",
            """
import jax
from differt_tpu.compile_cache import enable_compilation_cache
print("DIR", enable_compilation_cache())
print("CONFIG", jax.config.jax_compilation_cache_dir)
""",
        ],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(REPO),
        env={**env, "JAX_PLATFORMS": "cpu"},
    )
    expected = REPO / ".jax_cache"
    assert f"DIR {expected}" in result.stdout, result.stderr[-3000:]
    assert f"CONFIG {expected}" in result.stdout
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_refuses_the_cpu() -> None:
    result = run("", args=["chip_smoke.py"])
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
    assert "not a GPU" in result.stderr


def test_chip_smoke_needs_the_repo(tmp_path) -> None:
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    result = run("", cwd=tmp_path, args=["chip_smoke.py"])
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
