"""The JAX package's native libraries, loaded for sure before a comparison.

``xerus_tpu.core.sparse_qr`` and ``xerus_tpu.network.native`` build
``native/*.so`` with ``make`` on first use and cache the outcome: a load
that fails once leaves ``_LIB`` at None for the life of the process, and
the JAX package then takes its dense sparse-QR route or its Python
contraction-path portfolio.  A fresh checkout has no ``native/*.so``, and
under ``pytest -n`` several workers run ``make`` at once; ``make`` links
in place, so a worker can load a library another worker is still writing
("file too short") and keep the failure.  The port builds its own copies
atomically and takes the native routes, so a comparison in such a worker
would hold the port against another route.

``loaded(module)`` serializes the retries of the workers on a lock file
and loads the library again until it loads, then asserts that it did.  It
never skips a test: the comparison needs the native route."""

import fcntl
import os
import subprocess
import tempfile
import time

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
LOCK = os.path.join(tempfile.gettempdir(), "xerus_tpu_native_load.lock")


def loaded(module, timeout: float = 60.0, every: float = 0.5):
    """``module``'s native library (``module._LIB``), loading it again
    every ``every`` seconds for at most ``timeout`` seconds while it is
    missing; raises AssertionError with ``make``'s output if it never
    loads."""
    with open(LOCK, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + timeout
            while module._LIB is None:
                module._TRIED = False
                if module._load() is not None or time.monotonic() > deadline:
                    break
                time.sleep(every)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    if module._LIB is None:
        make = subprocess.run(["make", "-C", NATIVE_DIR, "-s"],
                              capture_output=True, text=True)
        raise AssertionError(
            f"{module.__name__}: the native library did not load within "
            f"{timeout:g} s; make -C {NATIVE_DIR} -s gave rc "
            f"{make.returncode}:\n{make.stdout}{make.stderr}")
    return module._LIB
