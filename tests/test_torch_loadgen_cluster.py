"""Load harness end to end: a small (seed, profile) run against the
embedded cluster must come back green — client percentiles agreeing
with the mgr digest over the wire, tenant QoS counters populated,
zero errors / lost / corrupt objects, zero cold XLA launches and zero
implicit host transfers (the steady-state discipline).

The port's twin of tests/integration/test_loadgen.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.loadgen import resolve_profile
from ceph_tpu_torch.loadgen.driver import run_profile
from ceph_tpu_torch.loadgen.schedule import generate_load, trace_hash


def _run(profile, seed):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(
            asyncio.wait_for(run_profile(profile, seed, device="cpu"), 300))
    finally:
        loop.close()


class TestLoadRun:
    def test_rados_profile_green_end_to_end(self):
        profile = resolve_profile(
            "rados_rw", clients=30, ops_per_client=4)
        rec = _run(profile, seed=7)
        assert rec["ops_completed"] == rec["ops_scheduled"] == 120
        assert rec["latency"]["errors"] == 0
        assert rec["undrained"] == 0
        # percentiles present and sane
        lat = rec["latency"]["overall"]
        assert lat["n"] == 120
        assert 0 < lat["p50_us"] <= lat["p95_us"] <= lat["p99_us"]
        # the run's trace re-derives bit-identically (purity)
        assert rec["trace_hash"] == trace_hash(
            generate_load(7, profile))
        # client-vs-mgr cross-check: the digest served the same
        # series back within tolerance, over the mon wire path
        assert rec["client_vs_mgr"]["agree"], rec["client_vs_mgr"]
        assert rec["client_vs_mgr"]["mgr"].get("n", 0) > 0
        # per-tenant QoS counters flowed through the mClock gates
        assert set(rec["qos"]) >= {"gold", "bronze"}
        assert rec["qos"]["gold"]["admitted"] > 0
        assert rec["qos"]["bronze"]["admitted"] > 0
        assert rec["qos"]["gold"]["weight"] \
            > rec["qos"]["bronze"]["weight"]
        # per-tenant latency rows exist in the client summary
        assert set(rec["latency"]["by_tenant"]) == {"gold", "bronze"}
        # verification sweep: nothing lost, nothing corrupt
        assert rec["verify"]["checked"] > 0
        assert rec["verify"]["mismatches"] == 0
        assert rec["verify"]["lost"] == 0
        # steady-state discipline
        assert rec["cold_launches"] == 0
        assert rec["host_transfers"] == 0
        assert rec["ok"], rec

    @pytest.mark.slow
    def test_mixed_profile_all_planes_green(self):
        """The all-planes profile (RADOS + EC-RMW + S3 + RBD + FS)
        at reduced scale: every plane must complete green."""
        profile = resolve_profile(
            "mixed", clients=40, ops_per_client=5)
        rec = _run(profile, seed=3)
        assert rec["ok"], rec
        kinds = set(rec["latency"]["by_kind"])
        # every plane saw traffic (the trace mixes all streams)
        assert {"rados_write", "rados_read", "ec_write"} <= kinds
        assert kinds & {"s3_put", "s3_get"}
        assert kinds & {"rbd_write", "rbd_read"}
        assert kinds & {"fs_write", "fs_read"}
        assert rec["latency"]["errors"] == 0
        assert rec["cold_launches"] == 0
        assert rec["host_transfers"] == 0

    def test_external_mode_rejects_non_rados_profiles(self):
        from ceph_tpu_torch.loadgen.driver import LoadHarness

        h = LoadHarness(resolve_profile("mixed"), 1,
                        monmap=[("127.0.0.1", 1)], device="cpu")

        async def go():
            with pytest.raises(ValueError):
                await h.start()
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(go())
        finally:
            loop.close()
