"""The host foundation against ceph_tpu: the same bytes, answers and orders.

``ceph_tpu_torch``'s ``common/``, ``kv/``, ``msg/denc`` and
``store/filestore``'s journal encoding on inputs made from a seed with
numpy, beside the JAX package's (tolerance 0): the ``OPTIONS`` table
(equal but for the two defaults that name the port's engines), one
``CEPH_TPU_*`` environment variable seen alike, ``denc`` output,
``WriteBatch.encode``, ``encode_txn``, ``TraceContext`` bytes,
``prometheus_text``, ``caps.capable`` over a sweep of cap strings and
the task-step order of ``interleave.run_interleaved`` for seeds 0-19,
and ``native.xor_region`` with its library and without it.
Each encoding is also decoded by the other package.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from ceph_tpu.common import caps as ref_caps
from ceph_tpu.common import config as ref_config
from ceph_tpu.common import interleave as ref_interleave
from ceph_tpu.common import metrics as ref_metrics
from ceph_tpu.common import optracker as ref_optracker
from ceph_tpu.common import tracing as ref_tracing
from ceph_tpu import kv as ref_kv
from ceph_tpu import native as ref_native
from ceph_tpu.msg import denc as ref_denc
from ceph_tpu.store import filestore as ref_filestore
from ceph_tpu.store import objectstore as ref_objectstore
from ceph_tpu_torch.common import caps, config, interleave, metrics, optracker, tracing
from ceph_tpu_torch import kv, native
from ceph_tpu_torch.msg import denc
from ceph_tpu_torch.store import filestore, objectstore

#: the two departures of the port's option table, recorded in CHANGES.md
DEPARTURES = {
    "osd_erasure_code_plugins": {"default": "cuda jerasure isa clay shec lrc"},
    "mgr_analytics_backend": {"default": "cuda", "enum": ("cuda", "numpy")},
}
#: the options whose help text named XLA or JAX and now names the port's
#: counterpart (defaults and semantics unchanged): those four, and the
#: analytics backend whose enum is a departure
REWORDED_HELP = {"ms_connection_ready_timeout", "osd_ec_encode_farm", "osd_ec_warmup",
                 "mgr_stats_window", "mgr_analytics_backend"}
FIELDS = ("name", "type", "default", "level", "desc", "min", "max", "see_also", "enum")


def test_options_table_equal_but_for_the_departures():
    assert list(config.OPTIONS) == list(ref_config.OPTIONS)
    assert config.SOURCES == ref_config.SOURCES
    assert (config.LEVEL_BASIC, config.LEVEL_ADVANCED, config.LEVEL_DEV) == (
        ref_config.LEVEL_BASIC, ref_config.LEVEL_ADVANCED, ref_config.LEVEL_DEV)
    differing = {}
    for name, ref in ref_config.OPTIONS.items():
        ours = config.OPTIONS[name]
        diff = {f for f in FIELDS if getattr(ours, f) != getattr(ref, f)}
        if diff - {"desc"}:
            differing[name] = {f: getattr(ours, f) for f in diff - {"desc"}}
        if "desc" in diff:
            assert name in REWORDED_HELP, name
            for word in ("XLA", "jax", "ceph_tpu/"):
                assert word not in ours.desc, (name, word)
    assert differing == DEPARTURES
    for name in REWORDED_HELP:
        assert config.OPTIONS[name].desc != ref_config.OPTIONS[name].desc
    # the enum departure keeps the reference's host backend and casts alike
    assert config.OPTIONS["mgr_analytics_backend"].cast("numpy") == "numpy"
    with pytest.raises(ValueError):
        config.OPTIONS["mgr_analytics_backend"].cast("jax")
    from ceph_tpu_torch.mgr.analytics import BACKENDS

    assert config.OPTIONS["mgr_analytics_backend"].enum == BACKENDS


@pytest.mark.parametrize("name,raw,want", [
    ("osd_pool_default_size", "5", 5),
    ("osd_read_error_repair", "off", False),
    ("osd_scrub_chunk_max", "7", 7),
    ("mgr_analytics_backend", "numpy", "numpy"),
])
def test_environment_variable_seen_alike(monkeypatch, name, raw, want):
    monkeypatch.setenv("CEPH_TPU_" + name.upper(), raw)
    ours, ref = config.ConfigProxy(), ref_config.ConfigProxy()
    assert ours[name] == ref[name] == want
    ours.set(name, raw, source="file")
    ref.set(name, raw, source="file")
    assert ours.show() == {**ref.show(), **{n: d["default"] for n, d in DEPARTURES.items()
                                            if n != name}}


def _denc_stream(mod, rng: np.random.Generator) -> bytes:
    enc = mod.Encoder()
    vals = rng.integers(0, 2 ** 63, 8, dtype=np.int64)
    with enc.versioned(3, 2):
        enc.u8(int(vals[0]) & 0xFF)
        enc.u16(int(vals[1]) & 0xFFFF)
        enc.u32(int(vals[2]) & 0xFFFFFFFF)
        enc.u64(int(vals[3]))
        enc.i32(int(vals[4] % 2 ** 31) - 2 ** 30)
        enc.i64(-int(vals[5]))
        enc.bool_(bool(vals[6] & 1))
        enc.bytes_(rng.integers(0, 256, int(vals[7] % 300), dtype=np.uint8).tobytes())
        enc.str_("obj-" + "".join(chr(0x61 + int(c)) for c in rng.integers(0, 26, 12)) + "é")
        with enc.versioned(1, 1):
            enc.raw(rng.integers(0, 256, 17, dtype=np.uint8).tobytes())
    return enc.bytes()


def _denc_read(mod, raw: bytes) -> tuple:
    dec = mod.Decoder(raw)
    with dec.versioned(compat=2):
        out = (dec.u8(), dec.u16(), dec.u32(), dec.u64(), dec.i32(), dec.i64(),
               dec.bool_(), dec.bytes_(), dec.str_())
        with dec.versioned(compat=1):
            out += (dec.raw(17),)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_denc_bytes_equal(seed):
    ours = _denc_stream(denc, np.random.default_rng(seed))
    ref = _denc_stream(ref_denc, np.random.default_rng(seed))
    assert ours == ref
    assert _denc_read(denc, ref) == _denc_read(ref_denc, ours)
    # a decoder older than the struct's compat (2) refuses both alike
    for mod in (denc, ref_denc):
        dec = mod.Decoder(ours)
        with pytest.raises(mod.EncodingError, match="compat 2 > supported 1"):
            with dec.versioned(compat=1):
                pass


def _keys(rng: np.random.Generator, n: int) -> list[str]:
    return ["".join(chr(int(c)) for c in rng.integers(0x21, 0x7F, int(rng.integers(1, 12))))
            for _ in range(n)]


def _batch(mod, rng: np.random.Generator):
    b = mod.WriteBatch()
    for key in _keys(rng, 24):
        op = int(rng.integers(0, 4))
        if op == 0:
            b.set("O", key, rng.integers(0, 256, int(rng.integers(0, 64)), dtype=np.uint8).tobytes())
        elif op == 1:
            b.rmkey("X", key)
        elif op == 2:
            b.rm_range("M", key, key + "~")
        else:
            b.rm_prefix("R" + key[:1])
    return b


@pytest.mark.parametrize("seed", range(4))
def test_writebatch_encode_equal(seed):
    ours = _batch(kv, np.random.default_rng(seed)).encode()
    ref = _batch(ref_kv, np.random.default_rng(seed)).encode()
    assert ours == ref
    assert kv.WriteBatch.decode(ref).encode() == ref_kv.WriteBatch.decode(ours).encode() == ours


def make_txn(store_mod, rng: np.random.Generator):
    """A transaction with every op kind, from ``rng``; ``store_mod`` is
    either package's ``store.objectstore``."""
    T, C, O = store_mod.Transaction, store_mod.coll_t, store_mod.ghobject_t
    c = C(int(rng.integers(0, 9)), int(rng.integers(0, 64)), int(rng.integers(-1, 11)))
    c2 = C(c.pool, c.ps + 1, c.shard)
    names = _keys(rng, 6)
    objs = [O(n, snap=int(rng.integers(0, 2 ** 40)), shard=c.shard) for n in names[:4]]
    data = rng.integers(0, 256, int(rng.integers(1, 9000)), dtype=np.uint8).tobytes()
    t = T().create_collection(c).create_collection(c2)
    t.touch(c, objs[0]).write(c, objs[0], int(rng.integers(0, 4096)), data)
    t.zero(c, objs[0], 3, int(rng.integers(1, 100))).truncate(c, objs[0], 5000)
    t.setattrs(c, objs[0], {k: k.encode() * 3 for k in names[2:]})
    t.rmattr(c, objs[0], names[2])
    t.omap_setkeys(c, objs[1], {k: bytes(len(k)) for k in names})
    t.omap_rmkeys(c, objs[1], names[:2]).omap_clear(c, objs[2])
    t.clone(c, objs[0], objs[3]).collection_move_rename(c, objs[3], c2, objs[3])
    t.remove(c, objs[1]).remove_collection(c2)
    return t


@pytest.mark.parametrize("seed", range(4))
def test_encode_txn_equal(seed):
    ours = filestore.encode_txn(make_txn(objectstore, np.random.default_rng(seed)))
    ref = ref_filestore.encode_txn(make_txn(ref_objectstore, np.random.default_rng(seed)))
    assert ours == ref
    assert filestore.encode_txn(filestore.decode_txn(ref)) == ref
    assert ref_filestore.encode_txn(ref_filestore.decode_txn(ours)) == ours


@pytest.mark.parametrize("seed", range(4))
def test_trace_context_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    tid, sid = (int(v) for v in rng.integers(0, 2 ** 63, 2, dtype=np.int64))
    args = (tid, sid, bool(seed & 1), f"client.{seed}:{tid % 1000}")
    ours_enc, ref_enc = denc.Encoder(), ref_denc.Encoder()
    tracing.TraceContext(*args).encode(ours_enc)
    ref_tracing.TraceContext(*args).encode(ref_enc)
    assert ours_enc.bytes() == ref_enc.bytes()
    back = tracing.TraceContext.decode(denc.Decoder(ref_enc.bytes()))
    assert back == tracing.TraceContext(*args)
    assert ref_tracing.TraceContext.decode(ref_denc.Decoder(ours_enc.bytes())) == \
        ref_tracing.TraceContext(*args)
    # a span opened from the context joins its trace in both tracers
    for mod in (tracing, ref_tracing):
        tr = mod.Tracer(f"osd.{seed}", sample_rate=0.0, tail_slow_s=None)
        with tr.span("sub_write", ctx=mod.TraceContext(*args)) as sp:
            pass
        assert (sp.trace_id, sp.parent_id, sp.sampled, sp.tags["reqid"]) == (
            tid, sid, bool(seed & 1), args[3])
        assert tr.ctx_for(sp).span_id == sp.span_id


def _collections(metrics_mod, optracker_mod, rng: np.random.Generator) -> dict:
    out = {}
    for name in ("osd.3", "mon.a", "encode_farm"):
        pc = metrics_mod.PerfCounters(name)
        for key in _keys(rng, 5):
            pc.inc(key, float(rng.integers(0, 10 ** 6)))
        for key in _keys(rng, 3):
            pc.set_gauge(key, float(rng.integers(-100, 100)) / 4)
        hist = optracker_mod.LatencyHistogram()
        for s in rng.exponential(0.002, 50):
            hist.record(float(s))
        pc.register_histogram("op_latency", hist)
        out[name] = pc
    return out


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_text_equal(seed):
    ours = metrics.prometheus_text(_collections(metrics, optracker, np.random.default_rng(seed)))
    ref = ref_metrics.prometheus_text(
        _collections(ref_metrics, ref_optracker, np.random.default_rng(seed)))
    assert ours == ref
    assert "# TYPE ceph_tpu_osd_3_op_latency histogram" in ours


def _cap_strings(rng: np.random.Generator) -> list[str]:
    parts = ["allow r", "allow w", "allow rw", "allow rwx", "allow *", "allow x",
             "allow profile osd", "allow profile admin", "allow profile bogus",
             "allow rw pool=rbd", "allow r pool=cephfs_data", "allow r pool=",
             "deny r", "allow", "allow rq", "allow r color=red", "", "allow w pool=rbd"]
    out = list(parts)
    for _ in range(60):
        pick = rng.choice(len(parts), int(rng.integers(1, 4)))
        out.append(", ".join(parts[i] for i in pick))
    return out


def test_caps_capable_equal_over_a_sweep():
    rng = np.random.default_rng(12)
    answers = 0
    for capstr in _cap_strings(rng):
        for service in ("osd", "mon"):
            for need in ("r", "w", "rw", "x", "rwx"):
                for pool in (None, "rbd", "cephfs_data"):
                    grant = {service: capstr}
                    got = caps.capable(grant, service, need, pool)
                    assert got == ref_caps.capable(grant, service, need, pool), (
                        capstr, service, need, pool)
                    answers += got
        try:
            ref_caps.validate({"osd": capstr})
        except ref_caps.CapsError:
            with pytest.raises(caps.CapsError):
                caps.validate({"osd": capstr})
        else:
            caps.validate({"osd": capstr})
    assert answers > 0
    assert caps.capable(None, "osd", "rwx") and caps.ADMIN_CAPS == ref_caps.ADMIN_CAPS


def _scenario(order: list):
    """Four tasks that each log their steps around awaits of different
    kinds, sharing one lock and one queue."""
    async def scenario():
        lock, q = asyncio.Lock(), asyncio.Queue()

        async def worker(i: int):
            for step in range(4):
                order.append((i, step))
                if step % 2:
                    async with lock:
                        order.append((i, "locked"))
                        await asyncio.sleep(0)
                else:
                    await q.put((i, step))
                    await asyncio.sleep(0)

        async def drain():
            for _ in range(8):
                order.append(("q", await q.get()))

        await asyncio.gather(*(worker(i) for i in range(4)), drain())
    return scenario


def test_interleave_task_step_order_equal_for_seeds():
    orders = set()
    for seed in range(20):
        ours, ref = [], []
        interleave.run_interleaved(_scenario(ours), seed)
        ref_interleave.run_interleaved(_scenario(ref), seed)
        assert ours == ref, seed
        orders.add(tuple(map(str, ours)))
    # the seeds reach different schedules
    assert len(orders) > 1


#: (buffer length, offset of dst, offset of src, src step): empty, short of
#: one 8-byte word, one word, past a page with a tail of 1, odd offsets
#: into a larger buffer, and a strided src (copied before the library call)
XOR_CASES = [(0, 0, 0, 1), (7, 0, 0, 1), (8, 0, 0, 1), (4097, 0, 0, 1),
             (4097, 3, 5, 1), (1000, 1, 7, 1), (333, 0, 0, 3), (4097, 5, 1, 2)]


@pytest.mark.parametrize("library", [True, False], ids=["library", "numpy"])
@pytest.mark.parametrize("n,dst_at,src_at,step", XOR_CASES)
def test_xor_region_equal(monkeypatch, library, n, dst_at, src_at, step):
    """``native.xor_region`` XORs in place what the reference's does, with
    the g++ library and with it forced absent (numpy), over lengths about
    the 8-byte loop and its tail, odd offsets and a strided src."""
    if not library:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(ref_native, "_load", lambda: None)
    else:
        assert native.available() and ref_native.available()
    rng = np.random.default_rng(n * 31 + dst_at * 7 + src_at + step)
    base_dst = rng.integers(0, 256, n + dst_at + 16, dtype=np.uint8)
    base_src = rng.integers(0, 256, (n + src_at + 16) * step, dtype=np.uint8)
    src_before = base_src.copy()
    outs = []
    for xor in (native.xor_region, ref_native.xor_region):
        buf = base_dst.copy()
        dst = buf[dst_at:dst_at + n]
        src = base_src[src_at * step:(src_at + n) * step:step]
        xor(dst, src)
        outs.append(buf)
    want = base_dst.copy()
    want[dst_at:dst_at + n] ^= base_src[src_at * step:(src_at + n) * step:step]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], want)
    np.testing.assert_array_equal(base_src, src_before)
