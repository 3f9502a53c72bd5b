"""Device-time measurement from the JAX profiler's trace.

The reference times with raw ``__rdtsc`` deltas (dbde_util_test.cpp:234-364).
Here a function runs under ``jax.profiler.trace`` and its device time is read
back from the emitted ``*.xplane.pb`` with ``jax.profiler.ProfileData``: the
GPU device planes hold one event per kernel the program launched, and the
program's time per execution is the sum of its kernels' durations divided by
the number of executions.  Kernel time counts what the device ran, not the
gaps between kernels; the host clock around ``block_until_ready`` gives the
wall time that includes them.

A trace with no GPU device events is an error: there is no fallback to the
host clock.
"""

from __future__ import annotations

import glob
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass

import jax

# Lines the profiler derives from the kernel events of a device plane.  They
# repeat the same device time grouped by module, op or step, so summing them
# with the stream lines would count it twice.
DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source code", "TensorFlow Ops",
                 "TensorFlow Name Scope", "Framework Ops", "Framework Name Scope")


@dataclass
class ProgramTime:
    """Device time of one program, per execution."""

    seconds: float  # sum of the program's kernel times per execution
    kernels: list  # [(kernel name, seconds per execution)], longest first
    reps: int


def device_info() -> dict:
    """The device the process runs on, as JAX reports it."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _is_device_plane(name: str) -> bool:
    return name.startswith("/device:GPU")


def kernel_times(planes) -> dict:
    """{kernel name: total ns} over every kernel event on GPU device planes.

    ``planes`` is ``ProfileData.planes`` (or any objects with the same
    ``name``/``lines``/``events`` shape).  A kernel is named by its event,
    which XLA names after the fusion it compiled (``loop_select_fusion``,
    ``input_transpose_fusion``...).  The ``hlo_op`` stat is no name here:
    XLA runs a program's kernels as one CUDA graph and labels every one of
    them ``command_buffer``.  Derived lines are skipped.
    """
    tot: dict = defaultdict(int)
    for plane in planes:
        if not _is_device_plane(plane.name):
            continue
        for line in plane.lines:
            if line.name in DERIVED_LINES:
                continue
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
    return dict(tot)


def program_time(planes, reps: int) -> ProgramTime:
    """Reduce a trace of ``reps`` executions of one program → ProgramTime."""
    tot = kernel_times(planes)
    if not tot:
        raise RuntimeError("the trace holds no GPU kernel events")
    per = sorted(((k, v / reps / 1e9) for k, v in tot.items()),
                 key=lambda kv: -kv[1])
    return ProgramTime(seconds=sum(v for _, v in per), kernels=per, reps=reps)


def trace_program(fn, *args, reps: int = 4):
    """Run ``fn(*args)`` ``reps`` times under the profiler → the trace as
    ``jax.profiler.ProfileData``.  ``args`` should already be device
    arrays, so that no transfer lands in the window."""
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))  # compile + warm
    d = tempfile.mkdtemp(prefix="dbde_prof_")
    try:
        with jax.profiler.trace(d):
            out = None
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        pbs = sorted(glob.glob(d + "/plugins/profile/*/*.xplane.pb"))
        if not pbs:
            raise RuntimeError("the profiler wrote no trace")
        return ProfileData.from_file(pbs[-1])
    finally:
        shutil.rmtree(d, ignore_errors=True)


def measure_program(fn, *args, reps: int = 4) -> ProgramTime:
    """Device time per execution of ``fn(*args)`` from a profiler trace."""
    return program_time(trace_program(fn, *args, reps=reps).planes, reps)


# Peak device-memory bandwidth by ``device_kind``, bytes/s (NVIDIA H100 SXM
# data sheet: 3.35 TB/s HBM3).  A device missing here is an error, not a
# default.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bound_seconds(nbytes: int, device_kind: str) -> float:
    """Least time ``nbytes`` of device-memory traffic can take."""
    if device_kind not in HBM_BYTES_PER_S:
        raise KeyError(f"no memory-bandwidth peak on record for {device_kind!r}")
    return nbytes / HBM_BYTES_PER_S[device_kind]
