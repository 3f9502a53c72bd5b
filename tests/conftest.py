"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The sharding tests need several devices; XLA's host platform provides 8
virtual ones.  Must run before the first ``import jax`` anywhere in the test
process.  Tests that need the GPU carry the ``gpu`` marker and decide inside
a fixture (``gpu_device``) whether one is present: under this configuration
there never is, so they skip here and run through ``chip_smoke.py`` on the
card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # JAX_PLATFORMS=cuda runs -m gpu on a card
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from dbde_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

# Bound the process's live memory-map count.  Root cause (/proc/self/maps
# sampled across a cold run): every live
# compiled CPU executable + its device buffers holds thousands of anonymous
# mappings, tests keep codecs/jits referenced for the whole session, and at
# vm.max_map_count (default 65530) a failed mmap inside XLA:CPU is
# unchecked — the suite dies with SIGSEGV in backend_compile or
# executable.serialize() (observed deterministically at ~62k maps, test 51
# of a cold run).  Two independent layers:
#   1. raise the kernel limit when permitted (CI images run as root);
#   2. an autouse fixture that clears jax's executable caches when the map
#      count nears the effective limit.  jax.clear_caches() releases the
#      mappings even while DbdeCodec/jit wrapper objects stay alive
#      and re-runs reload programs from the persistent disk cache above,
#      so a trip costs time, not a crash.
# DBDE_TEST_MAPS_LIMIT overrides the trip threshold (and skips the kernel
# bump) so the fixture path itself stays testable.
import gc  # noqa: E402

import pytest  # noqa: E402

_MAPS_LIMIT_ENV = os.environ.get("DBDE_TEST_MAPS_LIMIT")
if _MAPS_LIMIT_ENV is None:
    try:
        with open("/proc/sys/vm/max_map_count", "w") as _f:
            _f.write("1048576")
    except OSError:
        pass


def _max_map_count() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


_MAPS_LIMIT = (
    int(_MAPS_LIMIT_ENV) if _MAPS_LIMIT_ENV else int(_max_map_count() * 0.7)
)


def _nmaps() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _bound_jit_code_maps():
    yield
    if _nmaps() > _MAPS_LIMIT:
        jax.clear_caches()
        gc.collect()


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip: card-only tests run on the card
    through chip_smoke.py, never on the CPU suite's platform."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; runs on the card through chip_smoke.py")
    return devs[0]
