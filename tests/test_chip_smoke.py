"""chip_smoke.py refuses to report a result without a GPU or without the
rest of the repo: non-zero exit, and no `"ok": true` line."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_cpu():
    out = _run(ROOT / "chip_smoke.py", ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_refuses_without_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = _run(lone, tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
