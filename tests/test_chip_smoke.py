"""chip_smoke.py off the GPU: it stops at its device phase with a non-zero
exit and prints no result line; ``--four`` selects only its own phases."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(script, *args, cwd=None):
    return subprocess.run(
        [sys.executable, script, *args], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=""),
    )


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_exits_nonzero_at_device_phase_on_cpu(args):
    out = _run(SCRIPT, *args)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout.strip().splitlines() == ["== device"]  # nothing ran after it
    assert '"ok"' not in out.stdout


def test_fails_alone_without_the_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, alone)
    out = _run(str(alone), cwd=str(tmp_path))
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_phase_selection():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.phases(four=True) == ["device", "dp_vs_single", "spmd_vs_single"]
    assert chip_smoke.phases(four=False) == ["device", "ce", "attention", "train", "serve"]
