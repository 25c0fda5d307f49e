"""The port's device choice (``ai4e_tpu_torch.device``): its CPU set-up makes
a process's first call into MKL's vector math from one thread. Without it,
that call, made by two intra-op threads at once, computes one thread's
chunk less exactly about once in a hundred processes
(``scripts/cpu_first_exp.py``), which made the float32-masters test of
``test_torch_train.py`` fail in some whole runs. Imports no JAX."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_first_vml_call_after_the_cpu_set_up_repeats_bit_for_bit():
    """400 forked processes, two at a time, each resolving the CPU device
    and then taking ``torch.exp`` of the masters test's score shape twice
    on two threads: no first call differs from the second (with no set-up,
    28 of 1000 differed so on an 8-core Xeon)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "cpu_first_exp.py"),
         "--set-up", "port", "--trials", "400", "--parallel", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["trials"] == 400
    assert report["first_call_differs"] == 0, report
