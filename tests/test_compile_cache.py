"""utils/compile_cache.enable_compile_cache: one place decides where JAX's
persistent compilation cache lives.  Each case runs in a fresh process,
since the cache directory is process-wide JAX configuration."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = (
    "import jax\n"
    "from qamreconciliation_jax.utils.compile_cache import "
    "enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def _run(env_update):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update)
    out = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO,
                         check=True)
    return out.stdout.split()


def test_compile_cache_follows_environment(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache goes there and the helper
    sets no other directory."""
    want = str(tmp_path / "cc")
    returned, configured = _run({"JAX_COMPILATION_CACHE_DIR": want})
    assert returned == want and configured == want


def test_compile_cache_defaults_to_checkout():
    """Unset: a fixed .jax_cache/ at the root of the checkout, which
    .gitignore lists."""
    returned, configured = _run({})
    want = os.path.join(REPO, ".jax_cache")
    assert returned == want and configured == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
