"""The OSD's host modules against ceph_tpu: the same bytes, orders and answers.

``ceph_tpu_torch``'s ``osd/mapenc``, ``osd/pgutil`` with
``ops.hashing.ceph_str_hash_rjenkins``, ``osd/scheduler``, ``cls``,
``osd/snaps``, ``osd/pglog`` and ``PgPool.get_snap_context`` beside the
JAX package's, on inputs made from a seed with numpy (tolerance: exact):

- ``encode_osdmap`` and ``encode_incremental`` of maps built the same
  way in both packages (upmaps, upmap items and primaries, pg_temp,
  primary_temp, affinities, choose_args on the CRUSH map and on the
  OSDMap, device classes, snaps, addresses) are byte-equal, and each
  package decodes and applies the other's bytes;
- ``ceph_str_hash_rjenkins`` and ``object_to_pg`` over every name length
  0-64, non-ASCII UTF-8 names and 10,000 seeded names;
- ``MClockScheduler`` and ``WeightedPriorityQueue`` dequeue the same
  items in the same order for a seeded enqueue/dequeue trace;
- the ``lock``, ``version``, ``hello`` and ``rgw`` methods on ``MemStore``
  objects give the same rc, outdata and encoded effect ops;
- ``SnapSet`` / ``encode_snaps`` bytes and ``get_snap_context``;
- a seeded ``PGLog`` history (append, fill, trim, set_tail, adopt_tail,
  split, merge, rollback) leaves byte-equal pgmeta omaps and the same
  peering answers.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import ceph_tpu.cls as ref_cls
import ceph_tpu.crush.builder as ref_builder
import ceph_tpu.crush.types as ref_crush_types
import ceph_tpu.msg.messages as ref_messages
import ceph_tpu.ops.hashing as ref_hashing
import ceph_tpu.osd.mapenc as ref_mapenc
import ceph_tpu.osd.osdmap as ref_osdmap
import ceph_tpu.osd.pglog as ref_pglog
import ceph_tpu.osd.pgutil as ref_pgutil
import ceph_tpu.osd.scheduler as ref_scheduler
import ceph_tpu.osd.snaps as ref_snaps
import ceph_tpu.osd.types as ref_types
import ceph_tpu.store as ref_store
import ceph_tpu_torch.cls as cls
import ceph_tpu_torch.crush.builder as builder
import ceph_tpu_torch.crush.types as crush_types
import ceph_tpu_torch.msg.messages as messages
import ceph_tpu_torch.ops.hashing as hashing
import ceph_tpu_torch.osd.mapenc as mapenc
import ceph_tpu_torch.osd.osdmap as osdmap
import ceph_tpu_torch.osd.pglog as pglog
import ceph_tpu_torch.osd.pgutil as pgutil
import ceph_tpu_torch.osd.scheduler as scheduler
import ceph_tpu_torch.osd.snaps as snaps
import ceph_tpu_torch.osd.types as osd_types
import ceph_tpu_torch.store as store
from tests.xla_private import _private_xla_compiles  # noqa: F401

REF = types.SimpleNamespace(builder=ref_builder, crush=ref_crush_types, mapenc=ref_mapenc,
                            osdmap=ref_osdmap, types=ref_types, pglog=ref_pglog,
                            store=ref_store, cls=ref_cls, messages=ref_messages,
                            scheduler=ref_scheduler, snaps=ref_snaps)
PORT = types.SimpleNamespace(builder=builder, crush=crush_types, mapenc=mapenc, osdmap=osdmap,
                             types=osd_types, pglog=pglog, store=store, cls=cls,
                             messages=messages, scheduler=scheduler, snaps=snaps)


# -- maps and incrementals ---------------------------------------------------------


def build_map(pkg, seed: int):
    """A map with every section mapenc writes, its values from ``seed``."""
    rng = np.random.default_rng(seed)
    crush = pkg.crush.CrushMap()
    root = pkg.builder.build_hierarchy(crush, osds_per_host=3, n_hosts=6)
    n_osd = 18
    for o in range(0, n_osd, 4):
        pkg.builder.set_device_class(crush, o, "ssd")
    rep = pkg.builder.add_simple_rule(crush, root.id, 1, mode="firstn")
    ec = pkg.builder.add_simple_rule(crush, root.id, 1, mode="indep", rule_type=3)
    msr = pkg.builder.add_osd_multi_per_domain_rule(crush, root.id, 1, num_per_domain=1,
                                                    num_domains=5)
    crush.choose_args[root.id] = pkg.crush.ChooseArg(
        root.id, weight_set=[[int(w) for w in rng.integers(0x4000, 0x20000, root.size)]])
    om = pkg.osdmap.OSDMap(crush=crush, epoch=int(rng.integers(1, 100)))
    for o in range(n_osd):
        om.new_osd(o, weight=int(rng.choice([0x10000, 0x8000, 0])), up=bool(rng.random() < .9))
        om.osd_addrs[o] = ("127.0.0.1", 6800 + o)
    om.mark_out(int(rng.integers(0, n_osd)))
    for o in rng.integers(0, n_osd, 3):
        om.set_primary_affinity(int(o), int(rng.choice([0, 0x4000, 0x8000])))
    om.pools[1] = pkg.types.PgPool(id=1, size=3, min_size=2, crush_rule=rep, pg_num=16,
                                   pgp_num=16, snap_seq=7, removed_snaps={3, 5},
                                   pool_snaps={"a": 2, "b": 7}, extra={"fast_read": "1"})
    om.pools[2] = pkg.types.PgPool(id=2, type=pkg.types.PoolType.ERASURE, size=5, min_size=4,
                                   crush_rule=ec, pg_num=8, pgp_num=8,
                                   erasure_code_profile="p42")
    om.pools[3] = pkg.types.PgPool(id=3, type=pkg.types.PoolType.ERASURE, size=5, min_size=4,
                                   crush_rule=msr, pg_num=8, pgp_num=8)
    om.pool_names.update({1: "rbd", 2: "ec", 3: "msr"})
    om.erasure_code_profiles["p42"] = {"plugin": "cuda", "k": "3", "m": "2"}
    pg = pkg.types.pg_t
    om.pg_upmap[pg(1, int(rng.integers(0, 16)))] = [int(x) for x in rng.integers(0, n_osd, 3)]
    om.pg_upmap_items[pg(2, int(rng.integers(0, 8)))] = [(0, 1), (2, int(rng.integers(3, 18)))]
    om.pg_upmap_primaries[pg(1, 3)] = int(rng.integers(0, n_osd))
    om.pg_temp[pg(2, 1)] = [int(x) for x in rng.integers(0, n_osd, 5)]
    om.primary_temp[pg(1, 5)] = int(rng.integers(0, n_osd))
    om.choose_args = {root.id: pkg.crush.ChooseArg(
        root.id, weight_set=[[int(w) for w in rng.integers(0x8000, 0x18000, root.size)]])}
    return om


def change(pkg, om, seed: int) -> None:
    """One epoch of seeded churn, every kind of delta the encoder has."""
    rng = np.random.default_rng(seed)
    pg = pkg.types.pg_t
    om.epoch += 1
    om.mark_down(int(rng.integers(0, om.max_osd)))
    om.osd_weight[int(rng.integers(0, om.max_osd))] = 0x4000
    om.new_osd(om.max_osd, weight=0x10000)
    om.osd_addrs[om.max_osd - 1] = ("10.0.0.1", 7000)
    del om.osd_addrs[0]
    om.set_primary_affinity(int(rng.integers(0, om.max_osd)), 0x2000)
    om.pg_upmap.clear()
    om.pg_upmap_items[pg(1, int(rng.integers(0, 16)))] = [(1, 2)]
    om.pg_temp[pg(3, 2)] = [int(x) for x in rng.integers(0, om.max_osd, 5)]
    om.primary_temp.clear()
    om.pools[4] = pkg.types.PgPool(id=4, size=2, min_size=1, crush_rule=0, pg_num=4, pgp_num=4)
    om.pool_names[4] = "new"
    del om.erasure_code_profiles["p42"]
    om.erasure_code_profiles["q"] = {"plugin": "isa", "k": "4", "m": "2"}
    om.choose_args = None
    b = next(b for b in om.crush.buckets.values() if b.items)
    b.item_weights[0] = int(rng.integers(0x1000, 0x20000))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_osdmap_and_incremental_bytes_equal(seed):
    ref_m, port_m = build_map(REF, seed), build_map(PORT, seed)
    ref_full, port_full = ref_mapenc.encode_osdmap(ref_m), mapenc.encode_osdmap(port_m)
    assert port_full == ref_full
    # each package decodes the other's full map
    assert mapenc.encode_osdmap(mapenc.decode_osdmap(ref_full)) == ref_full
    assert ref_mapenc.encode_osdmap(ref_mapenc.decode_osdmap(port_full)) == port_full
    ref_prev, port_prev = ref_mapenc.decode_osdmap(ref_full), mapenc.decode_osdmap(port_full)
    change(REF, ref_m, seed + 10)
    change(PORT, port_m, seed + 10)
    ref_inc = ref_mapenc.encode_incremental(ref_mapenc.diff_osdmap(ref_prev, ref_m))
    port_inc = mapenc.encode_incremental(mapenc.diff_osdmap(port_prev, port_m))
    assert port_inc == ref_inc
    # the port applies the reference's incremental, and back
    m, gap = mapenc.apply_map_message(port_prev, {}, {port_m.epoch: ref_inc})
    assert not gap and m is not port_prev
    assert mapenc.encode_osdmap(m) == ref_mapenc.encode_osdmap(ref_m)
    r, gap = ref_mapenc.apply_map_message(ref_prev, {}, {ref_m.epoch: port_inc})
    assert not gap and ref_mapenc.encode_osdmap(r) == mapenc.encode_osdmap(port_m)
    assert mapenc.crush_sections(port_m) == ref_mapenc.crush_sections(ref_m)
    # placement of the decoded maps agrees
    for pid in (1, 2, 3):
        for ps in range(8):
            assert (m.pg_to_up_acting_osds(osd_types.pg_t(pid, ps))
                    == r.pg_to_up_acting_osds(ref_types.pg_t(pid, ps)))


def test_apply_map_message_reports_gaps_alike():
    ref_m, port_m = build_map(REF, 4), build_map(PORT, 4)
    full = mapenc.encode_osdmap(port_m)
    for pkg, base in ((mapenc, mapenc.decode_osdmap(full)),
                      (ref_mapenc, ref_mapenc.decode_osdmap(full))):
        got, gap = pkg.apply_map_message(base, {}, {base.epoch + 2: b""})
        assert gap and got is base
        got, gap = pkg.apply_map_message(None, {port_m.epoch: full}, {})
        assert not gap and pkg.encode_osdmap(got) == full
    assert ref_mapenc.encode_osdmap(ref_m) == full


# -- object names to PGs ---------------------------------------------------------------


def _names() -> list:
    rng = np.random.default_rng(2026)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789._-", np.uint8)
    names = ["".join(chr(c) for c in rng.choice(alphabet, n)) for n in range(65)]
    names += ["é", "中文对象", "объект.данные", "rbd_data.é中\U0001F600", "\x00\x01\xff"]
    names += [bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
              for _ in range(50)]
    names += ["".join(chr(c) for c in rng.choice(alphabet, int(rng.integers(1, 48))))
              for _ in range(10_000)]
    return names


def test_rjenkins_and_object_to_pg_equal_over_the_sweep():
    names = _names()
    lengths = {len(n.encode() if isinstance(n, str) else n) for n in names[:65]}
    assert lengths == set(range(65)) and {n % 12 for n in lengths} == set(range(12))
    pool, ref_pool = (osd_types.PgPool(id=7, pg_num=32, pgp_num=32),
                      ref_types.PgPool(id=7, pg_num=32, pgp_num=32))
    for name in names:
        h = hashing.ceph_str_hash_rjenkins(name)
        assert h == ref_hashing.ceph_str_hash_rjenkins(name), name
        if isinstance(name, str):
            got, want = pgutil.object_to_pg(pool, name), ref_pgutil.object_to_pg(ref_pool, name)
            assert (got.pool, got.ps) == (want.pool, want.ps) == (7, h)
            assert pool.raw_pg_to_pg(got).ps == ref_pool.raw_pg_to_pg(want).ps


def test_pgutil_constants_and_version_attr_equal():
    for name in ("NO_SHARD", "STRIPE_UNIT", "SUBOP_TIMEOUT", "SIZE_ATTR", "HINFO_ATTR",
                 "VERSION_ATTR", "USER_XATTR_PREFIX", "RB_SNAP"):
        assert getattr(pgutil, name) == getattr(ref_pgutil, name)
    for e, v in ((0, 0), (3, 17), (4_000_000_000, 999_999_999_999)):
        raw = pgutil._v_bytes(pglog.eversion_t(e, v))
        assert raw == ref_pgutil._v_bytes(ref_pglog.eversion_t(e, v))
        assert pgutil._v_parse(raw) == pglog.eversion_t(e, v)
    assert pgutil._v_parse(None) == pglog.ZERO
    assert pgutil.ECFetchError(5).errno == ref_pgutil.ECFetchError(5).errno
    s = store.MemStore()
    c, o = store.coll_t(1, 0, 0), store.ghobject_t("x")
    s.queue_transaction(store.Transaction().create_collection(c).write(c, o, 0, b"0123456789"))
    assert pgutil._read_extents(s, c, o, [(2, 3), (7, 5), (0, 1)]) == b"234" + b"789" + b"0"


# -- scheduler order ------------------------------------------------------------------------


def _mclock_trace(pkg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    sch = pkg.scheduler.MClockScheduler()
    sch.set_profile("client", pkg.scheduler.ClientProfile(reservation=5, weight=10))
    sch.set_profile("recovery", pkg.scheduler.ClientProfile(weight=1, limit=20))
    sch.set_profile("gold", pkg.scheduler.ClientProfile(reservation=2, weight=30, limit=50))
    now, out = 0.0, []
    for i in range(600):
        now += float(rng.exponential(0.01))
        if rng.random() < 0.6:
            klass = ["client", "recovery", "gold", "best_effort"][int(rng.integers(0, 4))]
            sch.enqueue(klass, i, cost=float(rng.choice([1.0, 2.5, 17.0])), now=now)
        else:
            out.append(sch.dequeue(now))
    while not sch.empty():
        now += 0.01
        out.append(sch.dequeue(now))
    return out


def _wpq_trace(pkg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    q, out = pkg.scheduler.WeightedPriorityQueue(cutoff=64), []
    for i in range(800):
        if rng.random() < 0.55:
            q.enqueue(int(rng.choice([1, 3, 10, 63, 64, 100, 196])), i)
        elif not q.empty():
            out.append(q.dequeue())
    while not q.empty():
        out.append(q.dequeue())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_dequeue_order_equal(seed):
    order = _mclock_trace(PORT, seed)
    assert order == _mclock_trace(REF, seed)
    assert sum(x is not None for x in order) > 200
    wpq = _wpq_trace(PORT, seed)
    assert wpq == _wpq_trace(REF, seed) and len(wpq) > 300


# -- object classes ------------------------------------------------------------------------


def _encode_ops(pkg, ops) -> bytes:
    enc = pkg.messages.Encoder()
    for op in ops:
        op.encode(enc)
    return enc.bytes()


def _apply_effects(pkg, st, c, o, effects) -> None:
    """Fold a method's effect ops into the object, as the primary does."""
    m = pkg.messages
    t = pkg.store.Transaction().touch(c, o)
    for op in effects:
        if op.op == m.OP_WRITE_FULL:
            t.truncate(c, o, 0).write(c, o, 0, op.data)
        elif op.op == m.OP_SETXATTR:
            t.setattrs(c, o, {"u_" + op.name: op.data})
        elif op.op == m.OP_OMAP_SETKEYS:
            t.omap_setkeys(c, o, op.kv)
        elif op.op == m.OP_OMAP_RMKEYS:
            t.omap_rmkeys(c, o, op.keys)
    st.queue_transaction(t)


#: (class, method, input) calls, in order, on one object
CLS_CALLS = [
    ("hello", "say_hello", b""), ("hello", "say_hello", "wörld".encode()),
    ("version", "read", b""), ("version", "inc", b""), ("version", "inc", b""),
    ("version", "read", b""),
    ("lock", "get_info", b""),
    ("lock", "lock", b'{"name": "L", "type": "shared", "cookie": "c1", "owner": "client.1"}'),
    ("lock", "lock", b'{"name": "L", "type": "shared", "cookie": "c2", "owner": "client.2"}'),
    ("lock", "lock", b'{"name": "L", "type": "exclusive", "cookie": "c3", "owner": "client.3"}'),
    ("lock", "lock", b'{"name": "M", "type": "shared", "owner": "client.4"}'),
    ("lock", "unlock", b'{"name": "L", "cookie": "c1", "owner": "client.1"}'),
    ("lock", "unlock", b'{"name": "L", "cookie": "zz", "owner": "client.1"}'),
    ("lock", "break_lock", b'{"owner": "client.2"}'),
    ("lock", "get_info", b""), ("lock", "lock", b"not json"),
    ("rgw", "bucket_init_index", b""),
    ("rgw", "bucket_prepare_op", b'{"tag": "t1", "key": "obj1", "op": "put"}'),
    ("rgw", "bucket_complete_op",
     b'{"tag": "t1", "key": "obj1", "op": "put", "meta": {"size": 4096, "etag": "e1"}}'),
    ("rgw", "bucket_prepare_op", b'{"tag": "t2", "key": "obj2"}'),
    ("rgw", "bucket_check_pending", b""),
    ("rgw", "bucket_complete_op", b'{"tag": "t2", "key": "obj2", "meta": {"size": 10}}'),
    ("rgw", "bucket_complete_op", b'{"tag": "t3", "key": "obj1", "op": "del"}'),
    ("rgw", "bucket_prepare_op", b'{"tag": "", "key": "x"}'),
    ("rgw", "bucket_prepare_op", b'{"tag": "t4", "key": "obj3"}'),
    ("rgw", "bucket_abort_op", b'{"tag": "t4", "key": "obj3"}'),
    ("rgw", "bucket_complete_op", b'{"tag": "t5", "key": "obj4", "op": "bad"}'),
    ("rgw", "bucket_list", b'{"max": 1}'), ("rgw", "bucket_list", b'{"marker": "obj1"}'),
    ("rgw", "bucket_stats", b""), ("nope", "x", b""), ("hello", "nope", b""),
]


def _cls_run(pkg) -> list:
    st = pkg.store.MemStore()
    c, o = pkg.store.coll_t(1, 0), pkg.store.ghobject_t("obj")
    st.queue_transaction(pkg.store.Transaction().create_collection(c))
    out = []
    for klass, method, indata in CLS_CALLS:
        ctx = pkg.cls.MethodContext(st, c, o)
        rc, data = pkg.cls.call(klass, method, ctx, indata)
        out.append((rc, data, _encode_ops(pkg, ctx.effects),
                    pkg.cls.method_is_write(klass, method)))
        if rc == 0:
            _apply_effects(pkg, st, c, o, ctx.effects)
    out.append(sorted(st.omap_get(c, o).items()))
    return out


def test_cls_methods_equal():
    got = _cls_run(PORT)
    assert got == _cls_run(REF)
    assert sorted(cls._CLASSES) == sorted(ref_cls._CLASSES) == ["hello", "lock", "rgw",
                                                                 "version"]
    for name, klass in cls._CLASSES.items():
        assert {m: f for m, (f, _) in klass.methods.items()} == {
            m: f for m, (f, _) in ref_cls._CLASSES[name].methods.items()}
    assert {rc for rc, *_ in got[:-1]} >= {0, -16, -2, -22, -95}


def test_method_context_writes_and_reads_equal():
    outs = []
    for pkg in (REF, PORT):
        st = pkg.store.MemStore()
        c, o = pkg.store.coll_t(2, 1), pkg.store.ghobject_t("o2")
        st.queue_transaction(pkg.store.Transaction().create_collection(c))
        ctx = pkg.cls.MethodContext(st, c, o)
        ctx.write_full(b"payload")
        ctx.setxattr("k", b"v")
        ctx.omap_set({"a": b"1", "b": b"2"})
        ctx.omap_rm_keys(["a"])
        _apply_effects(pkg, st, c, o, ctx.effects)
        ctx2 = pkg.cls.MethodContext(st, c, o)
        outs.append((_encode_ops(pkg, ctx.effects), ctx2.exists(), ctx2.read(2, 3),
                     ctx2.getxattr("k"), ctx2.getxattr("missing"), ctx2.omap_get(),
                     ctx2.omap_get_vals_by_keys(["b", "zz"])))
    assert outs[0] == outs[1]


# -- snaps ---------------------------------------------------------------------------------


def test_snapset_bytes_and_snap_context_equal():
    rng = np.random.default_rng(77)
    for _ in range(20):
        seq = int(rng.integers(1, 1 << 40))
        snap_ids = sorted({int(x) for x in rng.integers(1, seq + 1, 4)}, reverse=True)
        out = []
        for pkg in (REF, PORT):
            ss = pkg.snaps.SnapSet()
            snapc = pkg.snaps.SnapContext(seq=seq, snaps=snap_ids)
            if ss.needs_cow(snapc):
                ss.make_clone(snapc, head_size=int(seq % 4096))
            ss.advance_seq(pkg.snaps.SnapContext(seq=seq + 3))
            raw = ss.to_bytes()
            back = pkg.snaps.SnapSet.from_bytes(raw)
            out.append((raw, pkg.snaps.encode_snaps(snap_ids), back.resolve(snap_ids[-1]),
                        back.resolve(pkg.snaps.NOSNAP), snapc.valid(),
                        pkg.snaps.decode_snaps(pkg.snaps.encode_snaps(snap_ids))))
        assert out[0] == out[1]
    for name in ("NOSNAP", "SS_ATTR", "SNAPS_ATTR", "WHITEOUT_ATTR"):
        assert getattr(snaps, name) == getattr(ref_snaps, name)
    pools = [pkg.types.PgPool(id=1, snap_seq=9, removed_snaps={4}, pool_snaps={"a": 2, "b": 4,
                                                                                "c": 9})
             for pkg in (REF, PORT)]
    ref_sc, sc = (p.get_snap_context() for p in pools)
    assert (sc.seq, sc.snaps) == (ref_sc.seq, ref_sc.snaps) == (9, [9, 2])
    assert type(sc) is snaps.SnapContext
    empty = osd_types.PgPool(id=2).get_snap_context()
    assert (empty.seq, empty.snaps) == (0, [])


# -- the PG log ----------------------------------------------------------------------------


def pglog_history(pkg, st, seed: int) -> dict:
    """A seeded PG-log history over ``st``: appends with gaps, fills,
    trims, a backfill tail, an adopted tail, a split and a merge, a
    divergent rollback.  Returns the logs, keyed by collection."""
    rng = np.random.default_rng(seed)
    P, T = pkg.pglog, pkg.store.Transaction
    ev, entry = P.eversion_t, P.pg_log_entry_t
    logs = {}
    for shard in range(3):
        c = pkg.store.coll_t(1, 4, shard)
        st.queue_transaction(T().create_collection(c))
        lg = logs[c] = P.PGLog(c)
        v = 0
        for i in range(int(rng.integers(20, 40))):
            v += int(rng.choice([1, 1, 1, 2]))  # a skipped counter pins the floor
            t = T()
            lg.append(t, entry(int(rng.choice([P.MODIFY, P.DELETE])),
                               f"obj{int(rng.integers(0, 12))}", ev(3 + v // 10, v),
                               ev(3, max(v - 1, 0)), f"client.{shard}:{i}"))
            st.queue_transaction(t)
        t = T()
        lg.fill(t, entry(P.MODIFY, "filled", ev(3, 0), reqid="fill.0"))
        lg.trim(t, int(rng.integers(5, 15)))
        st.queue_transaction(t)
    a, b, c = (logs[k] for k in sorted(logs, key=lambda k: k.shard))
    t = T()
    a.set_tail(t, ev(a.info.log_tail.epoch, a.info.log_tail.version + 2))
    b.adopt_tail(t, ev(b.info.last_update.epoch, b.info.last_update.version + 5),
                 [entry(P.MODIFY, "adopted", ev(9, 999), reqid="adopt.1")])
    c.clear_contig_floor(t)
    c.rollback_divergent(t, "obj3", ev(3, 4))
    st.queue_transaction(t)
    child_c = pkg.store.coll_t(1, 20, 0)
    st.queue_transaction(T().create_collection(child_c))
    child = logs[child_c] = P.PGLog(child_c)
    t = T()
    a.split_into(t, child, lambda oid: int(oid[3:] or 0) % 2 == 1 if oid[3:].isdigit() else False)
    st.queue_transaction(t)
    t = T()
    b.merge_from(t, child)
    st.queue_transaction(t)
    return logs


def _log_view(lg) -> tuple:
    return (sorted(lg.entries.items()), lg.info, lg.contig_floor, list(lg.reqids.items()),
            lg.effective_last_update())


def test_pglog_omap_bytes_and_peering_equal():
    ref_st, st = ref_store.MemStore(), store.MemStore()
    ref_logs, logs = pglog_history(REF, ref_st, 11), pglog_history(PORT, st, 11)
    assert [str(c) for c in logs] == [str(c) for c in ref_logs]
    for c, ref_c in zip(logs, ref_logs):
        meta, ref_meta = logs[c].meta, ref_logs[ref_c].meta
        assert st.omap_get(c, meta) == ref_st.omap_get(ref_c, ref_meta)
        # the port loads the same log back; its peering answers agree
        lg, ref_lg = pglog.PGLog(c), ref_pglog.PGLog(ref_c)
        lg.load(st)
        ref_lg.load(ref_st)
        assert repr(_log_view(lg)) == repr(_log_view(ref_lg))
        # (the reqid window shrinks to the log across a reload)
        assert repr(_log_view(lg)[:3]) == repr(_log_view(logs[c])[:3])
        for e, v in ((0, 0), (3, 5), (4, 12), (9, 999), (3, 10**6)):
            want = ref_lg.missing_from(ref_pglog.eversion_t(e, v))
            got = lg.missing_from(pglog.eversion_t(e, v))
            assert repr(got) == repr(want)
            assert lg.covers(pglog.eversion_t(e, v)) == ref_lg.covers(ref_pglog.eversion_t(e, v))
    assert pglog.pg_info_t(pglog.eversion_t(2, 3)).encode() == ref_pglog.pg_info_t(
        ref_pglog.eversion_t(2, 3)).encode()
