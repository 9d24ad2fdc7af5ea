"""Watch/notify + object classes over a live cluster.

Reference surfaces: PrimaryLogPG watch/notify (MWatchNotify round
trip, notify completion on all acks / timeout) and the cls dispatch
(src/objclass/, src/cls/lock, src/cls/version, src/cls/hello) via
librados exec().

The port's twin of tests/integration/test_watch_cls.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import errno
import json

import pytest

from ceph_tpu_torch.client.rados import RadosError

from tests.test_torch_mini_cluster import Cluster, run


class TestWatchNotify:
    def test_notify_reaches_watchers_with_replies(self):
        async def go():
            from ceph_tpu_torch.client import RadosClient

            async with Cluster(n_osds=4) as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("obj", b"x")

                got: list[bytes] = []

                def cb(notify_id, payload):
                    got.append(payload)
                    return b"seen:" + payload

                cookie = await io.watch("obj", cb)

                # second client notifies; the watcher must see it and
                # its reply must come back to the notifier
                cl2 = RadosClient(client_id=777)
                await cl2.connect(*c.mon.addr)
                io2 = cl2.ioctx("rbd")
                res = await io2.notify("obj", b"ping")
                assert got == [b"ping"]
                assert len(res["acks"]) == 1
                assert res["acks"][0][2] == b"seen:ping"
                assert res["timeouts"] == []

                await io.unwatch("obj", cookie)
                res2 = await io2.notify("obj", b"again")
                assert res2["acks"] == []  # no watchers left
                assert got == [b"ping"]
                await cl2.shutdown()

        run(go())

    def test_notify_timeout_on_dead_watcher(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("obj", b"x")

                def hang(notify_id, payload):
                    # swallow the notify without acking by raising:
                    # the ack still goes out on exception, so instead
                    # deregister the cookie to drop the ack path
                    raise RuntimeError("no ack")

                cookie = await io.watch("obj", hang)
                # sabotage: remove the callback so the ack is empty but
                # still sent — to force a TIMEOUT, drop the watch map
                # entirely so the client never acks
                c.client._watches.clear()
                # the watcher connection is alive but never acks: notify
                # must return with the watcher listed under timeouts
                # (small timeout keeps the test fast)
                res = await io.notify("obj", b"hello", timeout_ms=400)
                assert res["acks"] == []
                assert len(res["timeouts"]) == 1

        run(go())


class TestObjectClasses:
    def test_hello_and_version(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("obj", b"x")
                out = await io.execute("obj", "hello", "say_hello", b"ceph")
                assert out == b"Hello, ceph!"
                assert await io.execute("obj", "version", "inc") == b"1"
                assert await io.execute("obj", "version", "inc") == b"2"
                assert await io.execute("obj", "version", "read") == b"2"
                with pytest.raises(RadosError) as ei:
                    await io.execute("obj", "nope", "nothing")
                assert ei.value.errno == errno.EOPNOTSUPP
                # malformed client input is contained as EINVAL, not EIO
                # (reference ClassHandler method-call containment)
                with pytest.raises(RadosError) as ei:
                    await io.execute("obj", "lock", "lock", b"not-json")
                assert ei.value.errno == errno.EINVAL

        run(go())

    def test_lock_class_semantics(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("obj", b"x")

                async def lock(owner, typ):
                    return await io.execute("obj", "lock", "lock", json.dumps({
                        "name": "l1", "type": typ, "owner": owner,
                    }).encode())

                await lock("alice", "exclusive")
                with pytest.raises(RadosError) as ei:
                    await lock("bob", "exclusive")
                assert ei.value.errno == errno.EBUSY
                info = json.loads(
                    await io.execute("obj", "lock", "get_info"))
                assert info["type"] == "exclusive"
                assert info["holders"] == [["alice", ""]]
                await io.execute("obj", "lock", "unlock", json.dumps({
                    "name": "l1", "owner": "alice",
                }).encode())
                # shared locks coexist
                await lock("bob", "shared")
                await lock("carol", "shared")
                info = json.loads(
                    await io.execute("obj", "lock", "get_info"))
                assert len(info["holders"]) == 2
                # break_lock evicts one owner
                await io.execute("obj", "lock", "break_lock", json.dumps({
                    "owner": "bob",
                }).encode())
                info = json.loads(
                    await io.execute("obj", "lock", "get_info"))
                assert info["holders"] == [["carol", ""]]
                # lock state persists in omap: cls effects replicated
                assert await io.omap_get_keys("obj") == ["lock.state"]

        run(go())
