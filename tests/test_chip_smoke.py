"""chip_smoke.py refuses to pass anywhere but on a GPU.

The smoke test itself runs on the card (`python chip_smoke.py`); here only its
device check and its failure paths run.  The `gpu` test drives a short smoke
run when a card is present and skips otherwise.
"""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _gpu(i):
    return SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3", id=i)


def test_device_check_rejects_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_device_check_counts_cards():
    chip_smoke.require_gpu([_gpu(0)])
    chip_smoke.require_gpu([_gpu(i) for i in range(4)], count=4)
    with pytest.raises(SystemExit, match="need 4 GPUs"):
        chip_smoke.require_gpu([_gpu(0)], count=4)


def _run(cwd, script, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_no_result(r):
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_smoke_fails_on_cpu():
    r = _run(REPO, "chip_smoke.py")
    _assert_no_result(r)
    assert "no GPU" in r.stderr


def test_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path, "chip_smoke.py")
    _assert_no_result(r)
    assert "checkout" in r.stderr


@pytest.fixture
def gpu_card():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_short_smoke_on_gpu(gpu_card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py", "--reads", "20000"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
