"""The services of the two packages share one cluster's bytes.

RBD, RGW and CephFS are client libraries over RADOS, so a service of
either package reads what the other wrote: the image headers, object
maps and data objects, the RGW bucket-index omaps and manifests, the
MDS's dirfrag omaps and journal.  Each case runs a port mon and port
OSDs (``device="cpu"``, EC data pools on the ``cuda`` plugin) with one
RADOS client of each package, writes through one package's service and
reads through the other's:

- an RBD image with an object map, written, snapshotted and overwritten
  by one package and read (head, snapshot) by the other; the object-map
  objects of the same writes byte-equal;
- S3 objects PUT through one package's ``S3Frontend`` and listed and GET
  through the other's, both gateways over the same pools;
- a file written by one package's ``FSClient`` and read by the other's,
  through either package's MDS;

and without a cluster:

- a file's 1 MiB appends reach RADOS as the same writes from either
  package's ``File``;

- the same wire-encoded reports into both packages' ``MgrDaemon`` give
  the same digest JSON (the reference's engine on JAX's CPU backend, the
  port's on its plain version);
- ``decompile`` of both packages gives byte-equal text, and
  ``compile_text`` of it equal maps, placing equally through the port's
  ``cudamapper`` and both scalar mappers;
- the port's ``ANALYTICS_COLUMNS`` equal the reference's.

The reference compiles privately (tests/xla_private.py).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from tests.test_torch_mini_cluster import Cluster, run
from tests.xla_private import _private_xla_compiles  # noqa: F401

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
ACCESS, SECRET = "AKIDPARITY", "parity-secret-key"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class TwoClientCluster(Cluster):
    """A port cluster with a RADOS client of each package."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.ref_client = _mod(REF, "client").RadosClient(client_id=4343)

    async def __aenter__(self):
        await super().__aenter__()
        await self.ref_client.connect(*self.mon.addr)
        return self

    async def __aexit__(self, *exc):
        await self.ref_client.shutdown()
        await super().__aexit__(*exc)

    def rados(self, pkg: str):
        return self.ref_client if pkg == REF else self.client


async def _pools(c, meta: str, data: str) -> None:
    await c.client.pool_create(meta, pg_num=4, size=3)
    await c.client.ec_profile_set("sp", {"plugin": "cuda", "k": "3", "m": "2"})
    await c.client.pool_create(data, pg_num=8, pool_type="erasure",
                               erasure_code_profile="sp")
    await c.ref_client._wait_new_map(c.client.osdmap.epoch - 1, timeout=10)


# ---------------------------------------------------------------------------
# RBD
# ---------------------------------------------------------------------------

ORDER = 16                      # 64 KiB objects
IMG_SIZE = 6 << ORDER           # 6 objects, the last never written


def _rbd_payloads():
    rng = np.random.default_rng(15)
    v1 = rng.integers(0, 256, 3 * (1 << ORDER) + 1234, dtype=np.uint8).tobytes()
    patch = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    return v1, patch


async def _rbd_write(c, pkg: str, name: str) -> dict:
    """Create, write, snapshot and overwrite image ``name`` through
    ``pkg``'s RBD; returns the expected head and snapshot bytes."""
    rbd_mod = _mod(pkg, "rbd")
    rados = c.rados(pkg)
    rbd = rbd_mod.RBD(rados.ioctx("rbdmeta"), rados.ioctx("rbddata"))
    await rbd.create(name, size=IMG_SIZE, order=ORDER, features=["object-map"])
    img = await rbd.open(name)
    v1, patch = _rbd_payloads()
    await img.write(777, v1)
    await img.write(4 * (1 << ORDER) + 5, b"\x5a" * 300)
    snapid = await img.snap_create("s1")
    await img.write((1 << ORDER) - 100, patch)
    snap = bytearray(IMG_SIZE)
    snap[777:777 + len(v1)] = v1
    snap[4 * (1 << ORDER) + 5:4 * (1 << ORDER) + 305] = b"\x5a" * 300
    head = bytearray(snap)
    head[(1 << ORDER) - 100:(1 << ORDER) - 100 + len(patch)] = patch
    return {"head": bytes(head), "snap": bytes(snap), "snapid": snapid}


async def _rbd_read(c, pkg: str, name: str, want: dict) -> None:
    rbd_mod = _mod(pkg, "rbd")
    rados = c.rados(pkg)
    rbd = rbd_mod.RBD(rados.ioctx("rbdmeta"), rados.ioctx("rbddata"))
    assert name in await rbd.list()
    img = await rbd.open(name)
    assert img.size() == IMG_SIZE and img.order == ORDER
    assert await img.read(0, IMG_SIZE) == want["head"]
    assert await img.read(777, 5000) == want["head"][777:5777]
    assert [s["name"] for s in img.snap_list()] == ["s1"]
    img.snap_set("s1")
    assert await img.read(0, IMG_SIZE) == want["snap"]
    img.snap_set(None)
    # the reader's object map of the head: objects 0-2 and 4 dirtied or
    # clean, 5 never written
    om = _mod(pkg, "rbd.objectmap")
    assert img.objmap.get(5) == om.OBJECT_NONEXISTENT
    assert img.objmap.get(1) == om.OBJECT_EXISTS
    assert img.objmap.get(4) == om.OBJECT_EXISTS_CLEAN


def test_rbd_image_crosses_packages():
    async def go():
        async with TwoClientCluster(n_osds=6) as c:
            await _pools(c, "rbdmeta", "rbddata")
            wants = {pkg: await _rbd_write(c, pkg, f"img-{pkg}") for pkg in (REF, PORT)}
            assert wants[REF]["head"] == wants[PORT]["head"]
            # the other package reads each image, head and snapshot
            await _rbd_read(c, PORT, f"img-{REF}", wants[REF])
            await _rbd_read(c, REF, f"img-{PORT}", wants[PORT])
            # the same writes left byte-equal object maps (head and
            # snapshot) and the same header keys and geometry
            meta = c.client.ioctx("rbdmeta")
            maps = {}
            for pkg in (REF, PORT):
                base = f"rbd_object_map.img-{pkg}"
                maps[pkg] = (await meta.read(base),
                             await meta.read(f"{base}.{wants[pkg]['snapid']:x}"))
            assert maps[REF] == maps[PORT]
            assert len(maps[REF][0]) == 2 and maps[REF][0] != maps[REF][1]
            hdr = {pkg: await meta.omap_get(f"rbd_header.img-{pkg}") for pkg in (REF, PORT)}
            assert sorted(hdr[REF]) == sorted(hdr[PORT])
            for key in ("size", "order", "features", "primary"):
                assert hdr[REF][key] == hdr[PORT][key], key
            assert hdr[REF]["object_prefix"] == b"rbd_data.img-" + REF.encode()
            assert hdr[PORT]["object_prefix"] == b"rbd_data.img-" + PORT.encode()

    run(go())


# ---------------------------------------------------------------------------
# RGW
# ---------------------------------------------------------------------------

async def _gateway(c, pkg: str, create_user: bool):
    rgw = _mod(pkg, "rgw")
    rados = c.rados(pkg)
    store = rgw.RGWStore(rados.ioctx("rgw.meta"), {"default": rados.ioctx("rgw.data")},
                         chunk_size=64 * 1024)
    if create_user:
        await store.create_user("parity", "Parity User", access_key=ACCESS,
                                secret_key=SECRET)
    fe = rgw.S3Frontend(store)
    await fe.start()
    return fe


def _keys(list_xml: bytes) -> list[str]:
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    return [e.findtext(f"{ns}Key") for e in ET.fromstring(list_xml).findall(f"{ns}Contents")]


@pytest.mark.parametrize("writer", [REF, PORT])
def test_s3_objects_cross_gateways(writer):
    from tests.test_torch_rgw import S3Client

    reader = PORT if writer == REF else REF
    rng = np.random.default_rng(7)
    objs = {f"dir/obj-{i}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for i, n in enumerate((0, 1000, 64 * 1024, 150_001))}

    async def go():
        async with TwoClientCluster(n_osds=6) as c:
            await _pools(c, "rgw.meta", "rgw.data")
            fe_w = await _gateway(c, writer, create_user=True)
            fe_r = await _gateway(c, reader, create_user=False)
            try:
                s3w = S3Client(fe_w.host, fe_w.port, access=ACCESS, secret=SECRET)
                s3r = S3Client(fe_r.host, fe_r.port, access=ACCESS, secret=SECRET)
                st, _, _ = await s3w.request("PUT", "/pb")
                assert st == 200
                for key, body in objs.items():
                    st, h, _ = await s3w.request("PUT", f"/pb/{key}", body=body)
                    assert st == 200
                    assert h["etag"].strip('"') == hashlib.md5(body).hexdigest()
                # both gateways list the one bucket index alike
                lists = []
                for s3 in (s3w, s3r):
                    st, _, body = await s3.request("GET", "/pb", "list-type=2")
                    assert st == 200
                    lists.append(body)
                assert _keys(lists[0]) == sorted(objs)
                assert lists[0] == lists[1]
                for key, body in objs.items():
                    st, h, got = await s3r.request("GET", f"/pb/{key}")
                    assert st == 200 and got == body, key
                    assert h["etag"].strip('"') == hashlib.md5(body).hexdigest()
                    if len(body) > 10:
                        st, _, got = await s3r.request(
                            "GET", f"/pb/{key}", headers={"range": "bytes=3-9"})
                        assert st == 206 and got == body[3:10]
                # the reader's PUT lands in the same index; the writer sees it
                st, _, _ = await s3r.request("PUT", "/pb/dir/back", body=b"back")
                assert st == 200
                st, _, got = await s3w.request("GET", "/pb/dir/back")
                assert st == 200 and got == b"back"
                # and the reader's delete too
                st, _, _ = await s3r.request("DELETE", "/pb/dir/obj-0")
                assert st == 204
                st, _, body = await s3w.request("GET", "/pb", "list-type=2")
                assert _keys(body) == sorted(set(objs) - {"dir/obj-0"} | {"dir/back"})
            finally:
                await fe_w.stop()
                await fe_r.stop()

    run(go())


# ---------------------------------------------------------------------------
# CephFS
# ---------------------------------------------------------------------------

FS_MIXES = {
    # (writer client, writer's MDS, reader client, reader's MDS)
    "ref_writes_port_reads": (REF, REF, PORT, PORT),
    "port_writes_ref_reads": (PORT, PORT, REF, REF),
    "ref_client_on_port_mds": (REF, PORT, PORT, REF),
}


@pytest.mark.parametrize("mix", list(FS_MIXES))
def test_file_crosses_packages(mix):
    w_pkg, w_mds, r_pkg, r_mds = FS_MIXES[mix]
    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()

    async def mount(c, client_pkg, mds_pkg):
        mds = _mod(mds_pkg, "fs").MDSDaemon(0, c.mon.addr)
        await mds.start()
        fs = _mod(client_pkg, "fs").FSClient(mds.addr, c.rados(client_pkg).ioctx("cephfs.data"))
        await fs.mount()
        return mds, fs

    async def go():
        async with TwoClientCluster(n_osds=6) as c:
            await _pools(c, "cephfs.meta", "cephfs.data")
            mds, fs = await mount(c, w_pkg, w_mds)
            await fs.mkdir("/d")
            f = await fs.create("/d/data.bin")
            await f.write(0, payload[:200_000])
            await f.write(200_000, payload[200_000:])
            await f.write(1000, b"\xee" * 500)
            await f.fsync()
            await fs.symlink("/d/link", "/d/data.bin")
            await fs.unmount()
            await mds.stop()
            want = payload[:1000] + b"\xee" * 500 + payload[1500:]

            mds, fs = await mount(c, r_pkg, r_mds)
            try:
                assert sorted(await fs.readdir("/d")) == ["data.bin", "link"]
                attr = await fs.stat("/d/data.bin")
                assert attr["type"] == "file" and attr["size"] == len(want)
                assert await fs.readlink("/d/link") == "/d/data.bin"
                g = await fs.open("/d/data.bin")
                assert await g.read(0) == want
                assert await g.read(199_990, 20) == want[199_990:200_010]
            finally:
                await fs.unmount()
                await mds.stop()

    run(go())


class _WriteLog:
    """An IoCtx stand-in that records each write as the client issues it."""

    def __init__(self):
        self.writes: list[tuple[str, int, int]] = []

    async def write(self, oid: str, data: bytes, off: int = 0) -> None:
        self.writes.append((oid, off, len(data)))


def test_file_appends_issue_the_same_writes():
    """Four 1 MiB appends by a sole writer reach RADOS as the same writes
    from either package's ``File``: 16 of 64 KiB an append, four to each
    of the four objects of the default layout's stripe (its 64 KiB units
    round robin), so an append costs both packages the same object ops."""
    issued = {}
    for pkg in (REF, PORT):
        mds = _mod(pkg, "fs.mds")
        fs = types.SimpleNamespace(data_io=_WriteLog(), _caps={1: mds.CAP_EXCL}, _dirty={})
        f = _mod(pkg, "fs.client").File(fs, "/f", 1, 0, _mod(pkg, "client.striper").Layout())
        for off in range(0, 4 << 20, 1 << 20):
            run(f.write(off, bytes(1 << 20)))
        issued[pkg] = fs.data_io.writes
        assert f.size == 4 << 20 and fs._dirty[1]["size"] == 4 << 20
    assert issued[PORT] == issued[REF]
    assert len(issued[PORT]) == 64 and {n for _, _, n in issued[PORT]} == {64 * 1024}
    for a in range(4):
        append = issued[PORT][16 * a:16 * a + 16]
        assert sorted({oid for oid, _, _ in append}) == [f"1.{i:08x}" for i in range(4)]
        assert all(sum(oid == f"1.{i:08x}" for oid, _, _ in append) == 4 for i in range(4))


# ---------------------------------------------------------------------------
# the mgr's digest
# ---------------------------------------------------------------------------

def _reports() -> list[bytes]:
    """Seeded reports of 5 OSDs and a mon, wire-encoded by the reference."""
    msgs = _mod(REF, "msg.messages")
    messenger = _mod(REF, "msg.messenger")
    rng = np.random.default_rng(99)
    out = []
    for r in range(12):
        for d in range(5):
            slow = 8.0 if d == 3 else 1.0
            gauges = {"write_lat_us": float(rng.integers(200, 900)) * slow,
                      "subop_w_lat_us": float(rng.integers(100, 400)),
                      "read_lat_us": float(rng.integers(50, 300)),
                      "num_pgs": 24.0 + d, "transient_metric_%d" % (r % 3): 1.5}
            status = {"slow_ops": r // 4 if d == 1 else 0, "slow_ops_inflight": 0}
            msg = msgs.MMgrReport(daemon=f"osd.{d}", counters={"op_w": float(r + d)},
                                  gauges=gauges, status=json.dumps(status).encode())
            out.append(messenger.encode_message(msg, ("osd", d), r + 1))
        mon = msgs.MMgrReport(daemon="mon.0", gauges={"inflight_ops": float(r)})
        out.append(messenger.encode_message(mon, ("mon", 0), r + 1))
    return out


def _digest(pkg: str, wire: list[bytes]) -> tuple[dict, dict]:
    mgr_daemon = _mod(pkg, "mgr.daemon")
    messenger = _mod(pkg, "msg.messenger")
    kw = {"device": "cpu"} if pkg == PORT else {}
    mgr = mgr_daemon.MgrDaemon(f"parity-{pkg}", ("127.0.0.1", 1), **kw)
    assert mgr.engine.prewarm() == 1
    for raw in wire:
        mgr._handle_report(messenger.decode_message(raw))
    mgr.last_analytics = mgr.engine.analyze(*mgr.store.snapshot())
    digest = mgr._build_digest()
    for key in ("ts", "gid", "active"):
        digest.pop(key)
    return digest, mgr.last_analytics


def test_mgr_digest_equal_on_both_packages():
    wire = _reports()
    ref, ref_a = _digest(REF, wire)
    port, port_a = _digest(PORT, wire)
    assert json.dumps(ref, sort_keys=True) == json.dumps(port, sort_keys=True)
    for key in ref_a:
        np.testing.assert_array_equal(ref_a[key], port_a[key], err_msg=key)
    # the digest saw the slow OSD and the SLOW_OPS complainer
    assert "osd.3" in port["slow_osds"]
    assert "SLOW_OPS" in port["health"]
    assert sorted(port["osd_perf"]) == ["0", "1", "2", "3", "4"]
    assert port["engine"]["launches"] == 1 and port["engine"]["cold_launches"] == 0


def test_analytics_columns_equal():
    from ceph_tpu.analysis.prewarm_registry import ANALYTICS_COLUMNS as REF_COLUMNS
    from ceph_tpu_torch.mgr.daemon import ANALYTICS_COLUMNS

    assert ANALYTICS_COLUMNS == REF_COLUMNS


# ---------------------------------------------------------------------------
# the CRUSH compiler
# ---------------------------------------------------------------------------

def _crush_map(pkg: str):
    B = _mod(pkg, "crush.builder")
    m = _mod(pkg, "crush.types").CrushMap()
    root = B.build_hierarchy(m, osds_per_host=3, n_hosts=6)
    B.add_simple_rule(m, root.id, 1, mode="firstn", rule_id=0)
    B.add_simple_rule(m, root.id, 1, mode="indep", rule_type=3, rule_id=1)
    m.device_classes[4] = "ssd"
    return m


def test_crush_compiler_text_and_placements_equal():
    from ceph_tpu_torch.crush.cudamapper import BatchedRuleMapper, compile_map

    texts = {pkg: _mod(pkg, "crush.compiler").decompile(_crush_map(pkg)) for pkg in (REF, PORT)}
    assert texts[REF] == texts[PORT]
    maps = {pkg: _mod(pkg, "crush.compiler").compile_text(texts[REF]) for pkg in (REF, PORT)}
    for pkg in (REF, PORT):
        assert _mod(pkg, "crush.compiler").decompile(maps[pkg]) == texts[REF]
    xs = np.arange(256, dtype=np.int64)
    for rule, n in ((0, 3), (1, 5)):
        ref_rows = [_mod(REF, "crush.mapper").crush_do_rule(maps[REF], rule, int(x), n)
                    for x in xs]
        port_rows = [_mod(PORT, "crush.mapper").crush_do_rule(maps[PORT], rule, int(x), n)
                     for x in xs]
        assert ref_rows == port_rows
        batched = BatchedRuleMapper(compile_map(maps[PORT]), rule, n, device="cpu")
        vals, cnt = batched(xs.astype(np.uint32))
        assert [[int(v) for v in vals[i, :cnt[i]]] for i in range(len(xs))] == ref_rows, rule
