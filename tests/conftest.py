"""Test configuration.

The suite runs JAX on CPU with 8 virtual devices so that the sharding and
mesh paths are exercised without a GPU; ``chip_smoke.py`` and
``scripts/chip_verify.py`` cover the card.  The platform is pinned with
``jax.config.update`` so that an environment which selects another
platform cannot move the suite; the backend initializes lazily, so the
XLA_FLAGS set here are still honored.
"""

import os
import sys

if os.environ.get("SYNTH_TPU_HIDE_AUDIOOP"):
    # Python 3.13 removed the audioop stdlib module.  This mode simulates
    # that world: goldref's audioop-conformance suite must skip cleanly
    # (goldref then IS the spec) and everything else must stay green.
    class _BlockAudioop:
        def find_spec(self, name, path=None, target=None):
            if name == "audioop":
                raise ImportError(
                    "audioop hidden (SYNTH_TPU_HIDE_AUDIOOP=1 simulates "
                    "Python 3.13 where the module is removed)")
            return None

    sys.modules.pop("audioop", None)
    sys.meta_path.insert(0, _BlockAudioop())

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# the CLI entry points enable the persistent compile cache; the suite
# compiles thousands of small CPU programs and needs none
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    assert jax.devices()[0].platform == "cpu"


#: Every compiled XLA CPU executable holds several memory mappings; the
#: full suite compiles thousands of programs in ONE process and marches
#: into the kernel's vm.max_map_count (65530 default) — at ~65k maps the
#: next LLVM mmap fails and the process SEGFAULTS mid-compile (measured:
#: maps grow ~linearly to 65.1k right before the crash).  A fixed
#: every-N-tests clear is NOT safe: compile density varies wildly per
#: test file (swept automation grids compile hundreds of programs per
#: test, so round 3's every-150 policy segfaulted ~90 tests in).
#: Instead we read the live mapping count from /proc/self/maps after
#: every test (~0.5 ms) and drop the jit caches whenever we cross a
#: safety threshold well below the kernel limit; retired executables
#: unmap, the handful of cross-module programs recompile (~seconds),
#: and the count stays bounded regardless of per-test compile density.
def _map_count_limit():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except OSError:
        return 65530


#: Clear at 55% of the kernel limit: a single swept-grid test has been
#: observed to add a few thousand maps, so the headroom must absorb the
#: largest single-test burst BETWEEN teardown checks (worst measured
#: burst ~5k maps << the ~29k headroom this leaves on a 65530 box).
_MAP_CLEAR_THRESHOLD = int(_map_count_limit() * 0.55)


def _live_map_count():
    try:
        with open("/proc/self/maps", "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0  # non-Linux: fall back to the periodic clear below


_test_counter = 0


def pytest_runtest_teardown(item, nextitem):
    global _test_counter
    _test_counter += 1
    n = _live_map_count()
    if n > _MAP_CLEAR_THRESHOLD or (n == 0 and _test_counter % 150 == 0):
        jax.clear_caches()
        import gc

        gc.collect()  # drop executables kept alive only by cycles


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)
