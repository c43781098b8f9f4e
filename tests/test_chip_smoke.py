"""chip_smoke.py without a GPU: it must fail, and print no result line."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, SCRIPT if cwd == REPO
                           else os.path.join(cwd, "chip_smoke.py"), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return False
        except (ValueError, TypeError):
            pass
    return True


def test_exits_nonzero_without_gpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert _no_result(r.stdout)


def test_multi_exits_nonzero_without_gpu():
    r = _run(REPO, "--multi")
    assert r.returncode != 0
    assert _no_result(r.stdout)


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the program, it cannot run."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert _no_result(r.stdout)
