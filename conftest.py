"""Load the JAX package's native libraries once per pytest process, before
collection.

``xerus_tpu.core.sparse_qr`` and ``xerus_tpu.network.native`` run ``make
-C native`` on first use and keep a failed load for the life of the
process.  Under ``pytest -n`` on a checkout without ``native/*.so`` every
xdist worker runs ``make`` at collection, and a worker can load a library
another worker is still linking; ``tests/test_sparse_qr.py`` and
``tests/test_native_pathopt.py`` then skip there.  This hook runs in the
main process and in each worker before collection and loads both libraries
through ``tests/native_jax.py``'s ``loaded()``, under its lock: one
process runs ``make``, the others load the finished file.  A library that
never loads leaves those files to their own skip.
"""

import importlib.util
import os


def _native_jax():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "native_jax.py")
    spec = importlib.util.spec_from_file_location("native_jax", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pytest_configure(config):
    from xerus_tpu.core import sparse_qr
    from xerus_tpu.network import native
    loaded = _native_jax().loaded
    for module in (sparse_qr, native):
        try:
            loaded(module)
        except AssertionError:
            pass
