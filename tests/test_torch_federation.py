"""The port's fleet federation and ``top`` (``ai4e_tpu_torch/observability/
federation.py``, ``top.py``) held against the JAX package's.

``tests/test_federation.py`` runs on the port (``port_suite``) but for its
one case that imports the rig's ``scrape_and_merge``, which waits for the
rig (ROADMAP A19). Then both packages on the same inputs: parsed and
merged series of the same exposition pages (the port's own control plane
and worker registries among them), the collector's snapshot JSON and
merged exposition over one fake fleet, and ``render_top``'s frame for the
same snapshots. Last, what the port adds: a worker's request counter in
``requests_total``, and a ``top --once`` frame with rates, through the
CLI verb.
"""

from __future__ import annotations

import asyncio
import subprocess
import sys
from pathlib import Path

import pytest

import ai4e_tpu.observability.federation as jax_federation
import ai4e_tpu.observability.top as jax_top
import ai4e_tpu_torch.observability.federation as port_federation
import ai4e_tpu_torch.observability.top as port_top
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry
from tests.test_torch_tenancy import port_suite

_suite = port_suite("test_federation")
# Imports ai4e_tpu.rig.verdict: the rig is not ported (ROADMAP A19).
del _suite["TestParseMerge"].test_verdict_scrape_and_merge_delegates
globals().update(_suite)
_MetricsServer = sys.modules["_port_test_federation"]._MetricsServer
GW_PAGE = sys.modules["_port_test_federation"].GW_PAGE
STORE_PAGE = sys.modules["_port_test_federation"].STORE_PAGE

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (jax_federation, jax_top, JaxRegistry),
            "port": (port_federation, port_top, PortRegistry)}


def registry_page(Registry) -> str:
    """A control plane's and a worker's series as one registry renders
    them: labelled counters, gauges and a histogram."""
    reg = Registry()
    reqs = reg.counter("ai4e_gateway_requests_total", "by outcome")
    reqs.inc(5, route="/v1/a", outcome="created")
    reqs.inc(2, route="/v1/a", outcome="429")
    outcomes = reg.counter("ai4e_request_outcomes_total", "by outcome")
    outcomes.inc(3, route="/v1/a", outcome="ok")
    outcomes.inc(1, route="/v1/a", outcome="late")
    reg.counter("ai4e_http_requests_total", "HTTP").inc(
        7, code="200", path="/classify")
    reg.gauge("ai4e_process_rss_bytes", "rss").set(3 * 1048576)
    reg.gauge("ai4e_slo_burn_rate", "burn").set(1.5, objective="/v1/a")
    hist = reg.histogram("ai4e_request_latency_seconds", "latency")
    for v in (0.01, 0.2, 3.0):
        hist.observe(v, route="/v1/a")
    return reg.render_prometheus()


PAGES = {"gateway": GW_PAGE, "store": STORE_PAGE,
         "registry": registry_page(PortRegistry),
         "garbage": "# HELP x\nnot a series\nx{a=\"1\"} 2\nx{a=\"1\"} 3\n"}


@pytest.mark.parametrize("page", sorted(PAGES))
def test_parse_and_merge_equal_jax(page):
    text = PAGES[page]
    got = {}
    for pkg, (fed, _top, _reg) in PACKAGES.items():
        series = fed.parse_prometheus(text)
        merged = fed.merge_series({"a": series, "b": fed.parse_prometheus(
            PAGES["registry"])})
        got[pkg] = (series, merged, sorted(fed.render_key(k)
                                           for k in merged))
    assert got["port"] == got["jax"]
    assert got["port"][0]


def test_role_of_equal_jax():
    names = ["gateway0", "store1r0", "dispatcher0.1", "worker0.0", "cp",
             "a", "B", "0x", "balancer", ""]
    assert ([port_federation.role_of(n) for n in names]
            == [jax_federation.role_of(n) for n in names])


def test_jax_registry_renders_the_same_page():
    assert registry_page(JaxRegistry) == PAGES["registry"]


def collect(fed, Registry, gw, store, worker) -> tuple[list, str]:
    col = fed.FleetCollector({"gateway0": gw.url, "store0": store.url,
                              "worker0": worker.url},
                             metrics=Registry())

    async def run():
        snaps = []
        await col.scrape_once()
        snaps.append(col.snapshot())
        gw.page = GW_PAGE.replace("} 10", "} 14")
        await col.scrape_once()
        snaps.append(col.snapshot())
        store.page = STORE_PAGE.replace("} 6", "} 30")  # terminal > admitted
        await col.scrape_once()
        await col.scrape_once()
        snaps.append(col.snapshot())
        return snaps, col.render_merged()

    snaps, merged = asyncio.run(run())
    gw.page, store.page = GW_PAGE, STORE_PAGE
    for snap in snaps:
        snap.pop("t")
        for proc in snap["per_proc"].values():
            proc.pop("last_scrape")
        for v in snap["conservation"]["violations"]:
            v.pop("t")
    return snaps, merged


def test_collector_snapshot_and_merged_page_equal_jax(fake_fleet):
    """Both collectors over one fake fleet, three ticks with a breach: the
    same snapshots but the times, the same merged exposition. The fleet's
    worker shows no JAX-known request counter, so ``requests_total`` is
    the same 0 in both."""
    gw, store = fake_fleet
    worker = _MetricsServer(STORE_PAGE.replace(
        "ai4e_request_outcomes_total", "ai4e_batch_total"))
    try:
        got = {pkg: collect(fed, Registry, gw, store, worker)
               for pkg, (fed, _top, Registry) in PACKAGES.items()}
    finally:
        worker.stop()
    assert got["port"] == got["jax"]
    snaps, _merged = got["port"]
    assert snaps[-1]["conservation"]["confirmed_violations"]


SNAP = {
    "t": 1000.0, "targets": 3, "ticks": 4,
    "fleet": {"admitted": 120, "terminal": 100, "in_flight": 20, "up": 2},
    "conservation": {"checked": True, "ok": True, "violations": [],
                     "confirmed_violations": [], "degraded": False},
    "per_proc": {
        "cp": {"role": "cp", "up": True, "requests_total": 400.0,
               "outcomes": {"ok": 90, "late": 6, "failed": 4, "shed": 3},
               "loop_lag_max_s": 0.012, "rss_bytes": 80 * 1048576,
               "open_fds": 40, "slo_burn_max": 0.7},
        "a": {"role": "a", "up": True, "requests_total": 250.0,
              "outcomes": {}, "loop_lag_max_s": 12.5,
              "rss_bytes": 2.5 * 1024 ** 3, "open_fds": None,
              "slo_burn_max": None},
        "b": {"role": "b", "up": False, "requests_total": 0.0,
              "outcomes": {"expired": 2}, "loop_lag_max_s": None,
              "rss_bytes": None, "open_fds": 9, "slo_burn_max": 14.0},
    },
}


def variants() -> dict:
    later = {**SNAP, "t": 1002.5, "per_proc": {
        k: {**v, "requests_total": v["requests_total"] * 1.5}
        for k, v in SNAP["per_proc"].items()}}
    violated = {**SNAP, "conservation": {
        "checked": True, "ok": False, "degraded": True,
        "violations": [{"kind": "terminal_exceeds_admitted", "t": 1.0,
                        "confirmed": True}],
        "confirmed_violations": [{"kind": "terminal_exceeds_admitted",
                                  "t": 1.0, "confirmed": True}]}}
    unchecked = {**SNAP, "conservation": {"checked": False, "ok": True}}
    return {"alone": (SNAP, None), "rates": (later, SNAP),
            "backwards": (SNAP, later), "violated": (violated, None),
            "unchecked": (unchecked, SNAP), "empty": ({}, None)}


@pytest.mark.parametrize("case", sorted(variants()))
def test_render_top_equal_jax(case):
    snap, prev = variants()[case]
    assert port_top.render_top(snap, prev) == jax_top.render_top(snap, prev)


# -- what the port adds ------------------------------------------------------------


def test_worker_requests_count_in_the_port_snapshot():
    """A worker's service shell counts ``ai4e_http_requests_total``; the
    port's snapshot reads it as the worker's requests, JAX's reads 0."""
    worker = _MetricsServer(registry_page(PortRegistry).replace(
        "ai4e_gateway_requests_total", "ai4e_other_total"))
    try:
        out = {}
        for pkg, (fed, _top, Registry) in PACKAGES.items():
            col = fed.FleetCollector({"worker0": worker.url},
                                     metrics=Registry())
            asyncio.run(col.scrape_once())
            out[pkg] = col.snapshot()["per_proc"]["worker0"]["requests_total"]
    finally:
        worker.stop()
    assert out == {"jax": 0.0, "port": 7.0}


class CountingServer(_MetricsServer):
    """A gateway whose request counter grows by 100 each scrape."""

    @property
    def page(self) -> str:
        self.scrapes = getattr(self, "scrapes", 0) + 1
        return self.base.replace("} 10", f"}} {10 + 100 * self.scrapes}")

    @page.setter
    def page(self, text: str) -> None:
        self.base = text


def test_top_verb_once_prints_a_frame_with_rates():
    """``python -m ai4e_tpu_torch top --once`` over a fleet whose gateway
    counts up between the two scrapes: one frame naming each process, a
    request rate on the gateway, exit 0. ``--spec`` and no source refuse
    with 2."""
    gw = CountingServer(GW_PAGE)
    store = _MetricsServer(STORE_PAGE)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "ai4e_tpu_torch", "top", "--once",
             "--interval", "1", "--targets",
             f"gateway0={gw.url},store0={store.url}"],
            cwd=ROOT, capture_output=True, text=True, timeout=60)
    finally:
        gw.stop()
        store.stop()
    assert out.returncode == 0, out.stderr
    rows = {line.split()[0]: line.split() for line in out.stdout.splitlines()
            if line.split() and line.split()[0] in ("gateway0", "store0")}
    assert set(rows) == {"gateway0", "store0"}
    assert float(rows["gateway0"][3]) > 0
    for argv in (["--spec", "topology.json"], []):
        refused = subprocess.run(
            [sys.executable, "-m", "ai4e_tpu_torch", "top", "--once", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=60)
        assert refused.returncode == 2, refused.stderr
