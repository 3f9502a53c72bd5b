"""The trace reduction and compile-cache helpers, on recorded-shape data."""

import os
from types import SimpleNamespace as NS

import pytest

from dbde_tpu.utils import compile_cache, profiling


def _ev(name, ns):
    return NS(name=name, duration_ns=ns, stats=[("hlo_op", "command_buffer")])


def _planes():
    """The shape a GPU trace has: one device plane with a compute stream,
    plus host planes whose events must not count."""
    stream = NS(name="Stream #13(Compute)", events=[
        _ev("loop_select_fusion", 300), _ev("input_transpose_fusion", 900),
        _ev("loop_select_fusion", 300), _ev("input_transpose_fusion", 900)])
    derived = NS(name="XLA Modules", events=[_ev("jit_encode_frames", 5000)])
    host = NS(name="python", events=[_ev("trace", 10**9)])
    return [NS(name="/host:CPU", lines=[host]),
            NS(name="/device:GPU:0", lines=[stream, derived])]


def test_kernel_times_sums_device_streams_only():
    assert profiling.kernel_times(_planes()) == {
        "loop_select_fusion": 600, "input_transpose_fusion": 1800}


def test_program_time_is_the_sum_per_execution():
    t = profiling.program_time(_planes(), reps=2)
    assert t.seconds == pytest.approx(1200e-9)
    assert [k for k, _ in t.kernels] == ["input_transpose_fusion",
                                         "loop_select_fusion"]
    assert t.kernels[0][1] == pytest.approx(900e-9)


def test_program_time_raises_without_device_events():
    with pytest.raises(RuntimeError, match="no GPU kernel events"):
        profiling.program_time(_planes()[:1], reps=1)


def test_measure_program_raises_on_cpu():
    import jax
    import jax.numpy as jnp

    with pytest.raises(RuntimeError, match="no GPU kernel events"):
        profiling.measure_program(jax.jit(lambda x: x + 1), jnp.ones(4), reps=1)


def test_hbm_bound():
    assert profiling.hbm_bound_seconds(335, "NVIDIA H100 80GB HBM3") == pytest.approx(1e-10)
    with pytest.raises(KeyError):
        profiling.hbm_bound_seconds(1, "cpu")


def test_device_info_names_the_platform():
    info = profiling.device_info()
    assert info["platform"] == "cpu" and info["count"] == 8


def test_compile_cache_honours_the_environment(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
