"""The port's disk faults and crash-point sweep (``ai4e_tpu_torch/chaos/
disk.py``, ``crashpoint.py``) held against the JAX package's.

``tests/test_disk_chaos.py`` runs whole on the port (``port_suite``): the
sweep across its seeds, degraded mode at the edge, disk faults composed
with failover and a slot move. Then both packages on the same inputs: the
disk injector's decisions under one seed and rule set, a fault-injected
journal handle's surviving bytes, and on one driven trace (the journals
are byte-compatible both ways) the crash offsets and every reboot's
verdict under ``fsync`` ``always`` and ``never``; each package's own
``sweep`` is clean.
"""

from __future__ import annotations

import errno
import os
import random

import pytest

import ai4e_tpu.chaos as jax_chaos
import ai4e_tpu.chaos.crashpoint as jax_crashpoint
import ai4e_tpu_torch.chaos as port_chaos
import ai4e_tpu_torch.chaos.crashpoint as port_crashpoint
from tests.test_torch_tenancy import port_suite

globals().update(port_suite("test_disk_chaos"))

PACKAGES = {"jax": jax_chaos, "port": port_chaos}


def disk_script(chaos, seed: int) -> dict:
    inj = chaos.DiskFaultInjector(seed=seed)
    inj.add_rule(op="write", errno=errno.ENOSPC, after_ops=3, rate=0.3,
                 times=4, torn_bytes=5)
    inj.add_rule(op="fsync", errno=errno.EIO, rate=0.5, times=None)
    inj.add_rule(op="flush", errno=errno.EIO, after_ops=10, times=2)
    seq = []
    for i in range(120):
        if i == 90:
            inj.clear()
        rule = inj.decide(("write", "flush", "fsync")[i % 3])
        seq.append(None if rule is None
                   else (rule.op, rule.errno, rule.torn_bytes))
    return {"seq": seq, "counts": inj.counts()}


@pytest.mark.parametrize("seed", [0, 7, 20260803])
def test_disk_injector_decisions_equal_jax(seed):
    got = {pkg: disk_script(chaos, seed) for pkg, chaos in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["counts"]


def test_faulty_file_leaves_the_same_bytes_as_jax(tmp_path):
    """Both packages' ``FaultyFile`` over a real file, same seeded rules:
    the same raises, and the same bytes on disk (torn prefixes included)."""
    out = {}
    for pkg, chaos in PACKAGES.items():
        path = tmp_path / f"{pkg}.journal"
        inj = chaos.DiskFaultInjector(seed=3)
        inj.add_rule(op="write", errno=errno.ENOSPC, rate=0.4, times=None,
                     torn_bytes=7)
        inj.add_rule(op="fsync", errno=errno.EIO, rate=0.3, times=None)
        raised = []
        with open(path, "w", encoding="utf-8") as raw:
            fh = chaos.FaultyFile(raw, inj)
            for i in range(40):
                try:
                    fh.write(f'{{"record": {i}, "pad": "{"x" * i}"}}\n')
                    fh.flush()
                    fh.fsync()
                    raised.append(None)
                except OSError as exc:
                    raised.append(exc.errno)
        out[pkg] = (raised, path.read_bytes(), inj.counts())
    assert out["port"] == out["jax"]


CRASHPOINT = {"jax": jax_crashpoint, "port": port_crashpoint}


@pytest.mark.parametrize("driver", ["jax", "port"])
@pytest.mark.parametrize("fsync", ["always", "never"])
@pytest.mark.parametrize("seed", [1, 42])
def test_crash_offsets_and_reboot_verdicts_equal_jax(tmp_path, seed, fsync,
                                                     driver):
    """One trace driven by ``driver``'s store; both packages'
    ``crash_offsets`` under the same seed, then both packages'
    ``check_reboot`` at every offset: the same points, the same (empty)
    verdicts. And each package's own ``sweep`` from the same seed is
    clean."""
    trace = CRASHPOINT[driver].drive_workload(
        str(tmp_path / "drive.journal"), seed, fsync=fsync, ops=30)
    offsets = {pkg: mod.crash_offsets(trace, random.Random(seed ^ 0x5EED),
                                      mid_points=8)
               for pkg, mod in CRASHPOINT.items()}
    assert offsets["port"] == offsets["jax"]
    verdicts = {}
    for pkg, mod in CRASHPOINT.items():
        scratch = str(tmp_path / f"{pkg}.crash")
        verdicts[pkg] = [mod.check_reboot(trace, at, scratch)
                         for at in offsets[pkg]]
        for suffix in ("", ".salvage.json"):
            if os.path.exists(scratch + suffix):
                os.unlink(scratch + suffix)
    assert verdicts["port"] == verdicts["jax"]
    assert not any(verdicts["port"])
    for pkg, chaos in PACKAGES.items():
        work = tmp_path / f"sweep-{pkg}"
        work.mkdir()
        n, violations = chaos.sweep(str(work), seed, fsync=fsync, ops=30,
                                    mid_points=8)
        assert violations == [], (pkg, violations)
        assert n >= 30
