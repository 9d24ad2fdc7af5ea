"""CLAY sub-chunk repair end-to-end: the bandwidth-optimal property
must show up ON THE WIRE, not just in minimum_to_decode's math.

Reference: ECCommon.cc:262-299 threads the per-shard (offset, count)
runs down to shard reads; ErasureCodeClay::repair_one_lost_chunk
(ErasureCodeClay.cc:462) consumes them.  Here one OSD loses a single
object's shard (store corruption) and restarts; the recovery pass
regenerates exactly that shard — run twice (sub-chunk reads enabled
and disabled), the helpers' served-byte counters must show the
regenerating read moving ~d/q chunk-equivalents instead of k+.

The port's twin of tests/integration/test_clay_repair.py: the same
cases over ``ceph_tpu_torch`` on the CPU, CLAY's scalar MDS code on the
``cuda`` plugin where the reference's is ``jax``.
"""

from __future__ import annotations

import asyncio
import random

from ceph_tpu_torch.osd.daemon import OSDDaemon, object_to_pg
from ceph_tpu_torch.store import ghobject_t

from tests.test_torch_mini_cluster import Cluster, run

K, M, D = 4, 2, 5  # q=2, t=3, sub_chunk_no=8; repair reads 1/2 per helper
OBJ_SIZE = 3 * 65536


async def _run_repair(c: Cluster, disable_subchunk: bool) -> int:
    """Drop one shard of one object from a peer's store, restart the
    peer, wait for regeneration; returns helper bytes served."""
    for o in c.osds:
        o.disable_subchunk_repair = disable_subchunk
    await c.client.ec_profile_set("clayprof", {
        "plugin": "clay", "k": str(K), "m": str(M), "d": str(D),
        "scalar_mds": "cuda", "crush-failure-domain": "host",
    })
    await c.client.pool_create(
        "claypool", pg_num=4, pool_type="erasure",
        erasure_code_profile="clayprof",
    )
    io = c.client.ioctx("claypool")
    rng = random.Random(77)
    payload = rng.randbytes(OBJ_SIZE)
    await io.write_full("c0", payload)

    om = c.client.osdmap
    pool = om.get_pg_pool(io.pool_id)
    pg = object_to_pg(pool, "c0")
    _, _, acting, primary = om.pg_to_up_acting_osds(pg)
    shard, victim = next(
        (s, o) for s, o in enumerate(acting) if o != primary
    )

    def sub_read_bytes() -> int:
        return int(sum(
            o.perf.dump().get("subop_read_bytes", 0)
            for o in c.osds if o is not None
        ))

    # drop the shard from the victim's store, then restart the daemon:
    # the re-peer pass finds it missing and regenerates it in place
    daemon = c.osds[victim]
    store = daemon.store
    await daemon.stop()
    coll = daemon._shard_coll(pool, pool.raw_pg_to_pg(pg), shard)
    obj = ghobject_t("c0", shard=shard)
    assert store.exists(coll, obj), "victim does not hold the shard"
    shard_len = store.stat(coll, obj)
    from ceph_tpu_torch.osd.pglog import PGMETA_OID
    from ceph_tpu_torch.store import Transaction

    t = Transaction()
    t.remove(coll, obj)
    # drop the shard's pg log too: peering then sees the member behind
    # (log delta names c0) and reconciles it — data loss with an intact
    # log is scrub territory, not peering's
    meta = ghobject_t(PGMETA_OID, shard=shard)
    if store.exists(coll, meta):
        t.remove(coll, meta)
    store.queue_transaction(t)

    before = sub_read_bytes()
    c.osds[victim] = OSDDaemon(victim, c.mon.addr, store=store,
                                device=c.device)
    for o in c.osds:
        o.disable_subchunk_repair = disable_subchunk
    await c.osds[victim].start()
    deadline = asyncio.get_running_loop().time() + 30
    while not store.exists(coll, obj):
        assert asyncio.get_running_loop().time() < deadline, "no repair"
        await asyncio.sleep(0.2)
    await asyncio.sleep(0.5)  # let trailing recovery I/O settle
    assert await io.read("c0") == payload
    # read() itself fans out ranged reads; subtract by sampling before
    delta = sub_read_bytes() - before
    return delta, shard_len


class TestClaySubChunkRepair:
    def test_repair_reads_subchunk_fraction(self):
        async def go():
            async with Cluster(n_osds=K + M + 2) as c:
                full_delta, shard_len = await _run_repair(
                    c, disable_subchunk=True)
            async with Cluster(n_osds=K + M + 2) as c:
                sub_delta, _ = await _run_repair(c, disable_subchunk=False)
            # regenerating read: d helpers x 1/q each = 2.5 chunks;
            # full reconstruction reads every consistent source (5).
            # The final client read adds the same k-chunk fan-out to
            # both runs.
            assert sub_delta < 0.75 * full_delta, (
                sub_delta, full_delta, shard_len,
            )

        run(go())

    def test_repaired_shard_bit_exact(self):
        async def go():
            async with Cluster(n_osds=K + M + 2) as c:
                await _run_repair(c, disable_subchunk=False)
                import json

                pool_id = c.client.osdmap.lookup_pg_pool_name("claypool")
                pool = c.client.osdmap.get_pg_pool(pool_id)
                for ps in range(pool.pg_num):
                    code, rs, data = await c.client.command({
                        "prefix": "pg deep-scrub",
                        "pgid": f"{pool_id}.{ps}",
                    })
                    assert code == 0, (rs, data)
                    rep = json.loads(data)
                    assert rep["inconsistencies"] == [], rep

        run(go())
