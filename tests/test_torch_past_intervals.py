"""Past-intervals-lite: a fully remapped PG pulls its data from the
previous acting set (reference PastIntervals prior-set role,
src/osd/osd_types.h:3270).

The port's twin of tests/integration/test_past_intervals.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

import numpy as np

from tests.test_torch_mini_cluster import Cluster, run


class TestFullRemapRecovery:
    def test_replicated_pg_survives_total_remap(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                await c.client.pool_create("pi", pg_num=4, size=2)
                io = c.client.ioctx("pi")
                payloads = {
                    f"o{i}": np.random.default_rng(i).integers(
                        0, 256, 9000, dtype=np.uint8).tobytes()
                    for i in range(8)
                }
                for oid, data in payloads.items():
                    await io.write_full(oid, data)
                await c.client.wait_clean(timeout=30)

                # move EVERY pg of the pool to a disjoint acting set
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                epoch0 = om.epoch
                from ceph_tpu_torch.osd.types import pg_t

                for ps in range(pool.pg_num):
                    _, _, acting, _ = om.pg_to_up_acting_osds(
                        pg_t(io.pool_id, ps), folded=True)
                    spare = [o for o in range(6) if o not in acting]
                    pairs = " ".join(
                        f"{frm} {to}" for frm, to in zip(acting, spare))
                    code, rs, _ = await c.client.command({
                        "prefix": "osd pg-upmap-items",
                        "pgid": f"{io.pool_id}.{ps}",
                        "pairs": pairs})
                    assert code == 0, rs
                await c.wait_epoch(epoch0 + 1)
                om2 = c.client.osdmap
                for ps in range(pool.pg_num):
                    _, _, a2, _ = om2.pg_to_up_acting_osds(
                        pg_t(io.pool_id, ps), folded=True)
                # the new homes must recover all data from the old ones
                st = await c.client.wait_clean(timeout=60)
                for oid, data in payloads.items():
                    assert await io.read(oid) == data, oid

        run(go())

    def test_ec_pg_survives_total_remap(self):
        """EC flavor: every positional shard pulls from its previous
        home after a disjoint remap."""
        async def go():
            async with Cluster(n_osds=8) as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "3", "m": "1",
                          "crush-failure-domain": "host"})
                await c.client.pool_create(
                    "pie", pg_num=2, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("pie")
                payloads = {
                    f"e{i}": np.random.default_rng(100 + i).integers(
                        0, 256, 30000, dtype=np.uint8).tobytes()
                    for i in range(4)
                }
                for oid, data in payloads.items():
                    await io.write_full(oid, data)
                await c.client.wait_clean(timeout=30)

                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                epoch0 = om.epoch
                from ceph_tpu_torch.osd.types import pg_t

                for ps in range(pool.pg_num):
                    _, _, acting, _ = om.pg_to_up_acting_osds(
                        pg_t(io.pool_id, ps), folded=True)
                    spare = [o for o in range(8) if o not in acting]
                    pairs = " ".join(
                        f"{frm} {to}" for frm, to in zip(acting, spare))
                    code, rs, _ = await c.client.command({
                        "prefix": "osd pg-upmap-items",
                        "pgid": f"{io.pool_id}.{ps}",
                        "pairs": pairs})
                    assert code == 0, rs
                await c.wait_epoch(epoch0 + 1)
                await c.client.wait_clean(timeout=60)
                for oid, data in payloads.items():
                    assert await io.read(oid) == data, oid

        run(go())

    def test_chained_double_remap(self):
        """Two quick remaps: the final home never saw the FIRST interval
        — it must learn it from the middle home's shared chain
        (PastIntervals propagation via pg info)."""
        async def go():
            async with Cluster(n_osds=6) as c:
                await c.client.pool_create("pc", pg_num=1, size=2)
                io = c.client.ioctx("pc")
                data = b"chained " * 2000
                await io.write_full("obj", data)
                await c.client.wait_clean(timeout=30)

                om = c.client.osdmap
                from ceph_tpu_torch.osd.types import pg_t

                _, _, acting0, _ = om.pg_to_up_acting_osds(
                    pg_t(io.pool_id, 0), folded=True)
                others = [o for o in range(6) if o not in acting0]
                mid, final = others[:2], others[2:4]
                # remap 1: acting0 -> mid ; remap 2 immediately: ->
                # final.  upmap pairs always map FROM the raw CRUSH set
                # (items replace wholesale), so both rounds zip from
                # acting0.
                for dest in (mid, final):
                    omx = c.client.osdmap
                    pairs = " ".join(
                        f"{frm} {to}" for frm, to in zip(acting0, dest))
                    code, rs, _ = await c.client.command({
                        "prefix": "osd pg-upmap-items",
                        "pgid": f"{io.pool_id}.0", "pairs": pairs})
                    assert code == 0, rs
                    epoch = omx.epoch
                    await c.wait_epoch(epoch + 1)
                await c.client.wait_clean(timeout=60)
                _, _, a2, _ = c.client.osdmap.pg_to_up_acting_osds(
                    pg_t(io.pool_id, 0), folded=True)
                assert set(a2) == set(final), (a2, final)
                assert await io.read("obj") == data

        run(go())
