"""The port passes the JAX package's invariant analyzer (ROADMAP C9).

``python -m ai4e_tpu.analysis`` runs on ``ai4e_tpu_torch/`` with an empty
baseline and every per-file rule: AIL006, AIL010, AIL016 and AIL017 are
left out because they read the JAX package's own ``docs/``. A finding is
fixed in the code, or carries the written ``ai4e: noqa[...] — reason`` the
JAX package gives at the same site."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COMMAND = [sys.executable, "-m", "ai4e_tpu.analysis", "--no-baseline",
           "--ignore", "AIL006,AIL010,AIL016,AIL017", "ai4e_tpu_torch/"]


def test_the_port_has_no_analyzer_finding():
    out = subprocess.run(COMMAND, cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    summary = (out.stdout + out.stderr).strip().splitlines()
    assert out.returncode == 0, "\n".join(summary)
    assert " 0 finding(s)" in summary[-1], "\n".join(summary)
