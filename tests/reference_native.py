"""The JAX package's native library (``titok_tpu/native/libtitok_native.so``)
loaded before a port test reaches it, for the port's test files that call
the JAX reader, resize or packer; they import the fixture by name.

The JAX loader rebuilds a missing or stale library in place with ``make -B``
(``titok_tpu/data/video_reader.py:_load_lib``), so under parallel test
workers one worker can ``dlopen`` the file while another is still writing
it ("file too short"), and the JAX chunk sampler then falls back to PIL for
the rest of that worker. The loader caches only a successful load, so
retrying until the other worker's build is done gives every test the
library.
"""

import subprocess
import time

import pytest

WAIT_S = 120.0
PAUSE_S = 0.25


def load_reference_native_lib():
    """``video_reader._load_lib()``, retried on ``OSError`` (a library still
    being written) and on a failed ``make`` (two builds at once) for up to
    ``WAIT_S`` seconds; the last error is raised after that."""
    from titok_tpu.data import video_reader

    deadline = time.monotonic() + WAIT_S
    while True:
        try:
            return video_reader._load_lib()
        except (OSError, subprocess.CalledProcessError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(PAUSE_S)


@pytest.fixture(scope="module", autouse=True)
def reference_native_lib():
    """Load the JAX package's native library once a module, before its
    first test."""
    load_reference_native_lib()
