"""Persistent compilation cache for the programs that drive a device.

Called by the entry scripts (``chip_smoke.py``, ``bench.py``,
``benchmarks/*.py``, ``examples/dam_break_demo.py``), never at library
import, so importing :mod:`tpgsd` changes no JAX setting.
"""

import os

#: the checkout's root: ``tpgsd/utils/`` is two levels below it
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache():
    """Point JAX's persistent compilation cache at a fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to ``.jax_cache`` at
    the checkout's root (listed in ``.gitignore``): a fixed path, since
    the path is part of the cache key and a moving directory never hits.

    Returns the cache directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
