"""chip_smoke.py's phases at tiny sizes on the CPU.

Every phase but the device check runs here at small shapes; the device
check, and the device-time phase that needs a GPU trace, must refuse the
CPU.  The full-size run happens on the card (``python chip_smoke.py``).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from dbde_tpu.bench_core import make_adversarial, make_content, make_uniform8
from dbde_tpu.golden_vectors import README_10x10_IMAGE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_device_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeError, match="not a GPU"):
        chip_smoke.phase_device()


def test_phase_device_time_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU kernel events"):
        chip_smoke.phase_device_time(H=16, W=16, B=1, reps=1)


TINY_CASES = {
    "camera": lambda: make_content(40, 24, 3, "camera"),
    "lowlight": lambda: make_content(40, 24, 3, "lowlight"),
    "random": lambda: make_content(40, 24, 3, "random"),
    "flat": lambda: make_content(40, 24, 3, "flat"),
    "adversarial": lambda: make_adversarial(40, 24, 3, maxd=8, seed=4),
    "uniform8": lambda: make_uniform8(42, 18, 3, seed=2),
    "golden": lambda: README_10x10_IMAGE[None],
}


@pytest.mark.parametrize("label", sorted(TINY_CASES))
def test_check_case_tiny(label):
    r = chip_smoke.check_case(label, TINY_CASES[label]())
    assert r["oracle_frames"] == min(2, r["frames"])


def test_check_case_detects_a_wrong_decode(monkeypatch):
    from dbde_tpu.codec import DbdeCodec

    real = DbdeCodec.decode
    monkeypatch.setattr(DbdeCodec, "decode",
                        lambda self, *a: real(self, *a) ^ np.uint8(1))
    with pytest.raises(chip_smoke.SmokeError, match="differ after the round trip"):
        chip_smoke.check_case("camera", TINY_CASES["camera"]())


def test_phase_parity_tiny_with_compile_report():
    cases = [(k, TINY_CASES[k]()) for k in ("camera", "golden")]
    res = chip_smoke.phase_parity(cases, compile_shape=(3, 24, 40))
    assert [r["label"] for r in res] == ["camera", "golden"]


def test_phase_stream_tiny():
    r = chip_smoke.phase_stream(H=24, W=40, n_frames=9, batch=4)
    assert r["file_bytes"] > 28 + 9 * 20
    assert r["write_compiles"] >= 0 and r["read_compiles"] >= 0


def test_phase_four_on_virtual_mesh():
    chip_smoke.phase_four(H=32, W=24, per_shard=2, file_frames=7)


def test_codec_bytes_counts_both_sides():
    # 1 frame of 16x16: 256 pixels, 4 tiles → 4 depths + 4 minima
    assert chip_smoke.codec_bytes(1, 16, 16, payload_bytes=64) == 256 + 64 + 8


def test_compile_counter_counts_only_while_active():
    import jax
    import jax.numpy as jnp

    c = chip_smoke.CompileCounter()
    jax.jit(lambda x: x * 3)(jnp.ones(5))
    assert c.count == 0
    c.active = True
    jax.jit(lambda x: x * 5 + 1)(jnp.ones(7))
    assert c.count >= 1


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [[], ["--four"]], ids=["one", "four"])
def test_script_fails_on_cpu_and_prints_no_result(args):
    r = _run([os.path.join(ROOT, "chip_smoke.py"), *args], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def test_script_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_parity_on_card(gpu_device):
    """The parity phase at real widths on the GPU."""
    assert chip_smoke.phase_device()["platform"] == "gpu"
    chip_smoke.phase_parity(chip_smoke.real_parity_cases(),
                            compile_shape=(16, 2048, 2048))


@pytest.mark.gpu
def test_served_stream_on_card(gpu_device):
    r = chip_smoke.phase_stream()
    assert r["file_bytes"] > 0
    json.dumps(r)
