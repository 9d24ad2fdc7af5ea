"""OSDMap / CrushMap wire encoding + incremental deltas.

The reference versions every map struct (OSDMap::encode
src/osd/OSDMap.cc, CrushWrapper::encode src/crush/CrushWrapper.cc) so
maps can ship between daemons and persist in the mon store.  Same
contract here over the denc module: ``encode_osdmap``/``decode_osdmap``
round-trip the full cluster map — crush buckets/rules/tunables/
choose_args, pools, osd states/weights/affinity/addresses, upmap and
temp exception tables, EC profiles.

Epoch churn ships as :class:`Incremental` deltas (the reference's
``OSDMap::Incremental``, src/osd/OSDMap.h; applied by
``OSDMap::apply_incremental``, src/osd/OSDMap.cc): the monitor diffs
consecutive epochs (:func:`diff_osdmap`) and publishes the delta;
subscribers land bit-identical to the full map
(:func:`apply_incremental`, pinned by tests/test_osdmap_incremental.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.crush.types import (
    Bucket,
    BucketAlg,
    ChooseArg,
    CrushMap,
    Rule,
    RuleOp,
    RuleStep,
    Tunables,
)
from ceph_tpu_torch.msg.denc import Decoder, Encoder
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgPool, pg_t


# -- choose_args (shared by crush + osdmap sections) ------------------------

def _enc_choose_args(enc: Encoder, table: dict[int, ChooseArg]) -> None:
    enc.u32(len(table))
    for bid in sorted(table):
        arg = table[bid]
        enc.i32(bid)
        ws = arg.weight_set or []
        enc.u32(len(ws))
        for pos in ws:
            enc.u32(len(pos))
            for w in pos:
                enc.u64(w)
        ids = arg.ids
        enc.bool_(ids is not None)
        if ids is not None:
            enc.u32(len(ids))
            for i in ids:
                enc.i32(i)


def _dec_choose_args(dec: Decoder) -> dict[int, ChooseArg]:
    out: dict[int, ChooseArg] = {}
    for _ in range(dec.u32()):
        bid = dec.i32()
        nws = dec.u32()
        ws = [[dec.u64() for _ in range(dec.u32())] for _ in range(nws)]
        ids = None
        if dec.bool_():
            ids = [dec.i32() for _ in range(dec.u32())]
        out[bid] = ChooseArg(bid, weight_set=ws or None, ids=ids)
    return out


# -- crush ------------------------------------------------------------------

def encode_crush(enc: Encoder, m: CrushMap) -> None:
    # v2 appends the MSR tunables (crush.h msr_descents/collision_tries)
    with enc.versioned(2, 1):
        enc.u32(m.max_devices)
        enc.u32(len(m.buckets))
        for bid in sorted(m.buckets):
            b = m.buckets[bid]
            enc.i32(b.id)
            enc.i32(b.type)
            enc.u8(int(b.alg))
            enc.u8(b.hash)
            enc.u32(b.size)
            for it in b.items:
                enc.i32(it)
            for w in b.item_weights:
                enc.u32(w)
            for name, arr in (
                ("sum", b.sum_weights),
                ("node", b.node_weights),
                ("straw", b.straws),
            ):
                enc.u32(len(arr))
                for v in arr:
                    enc.u64(v)
        enc.u32(len(m.rules))
        for rid in sorted(m.rules):
            r = m.rules[rid]
            enc.u32(rid)
            enc.u32(r.rule_type)
            enc.bool_(r.device_class is not None)
            if r.device_class is not None:
                enc.str_(r.device_class)
            enc.u32(len(r.steps))
            for s in r.steps:
                enc.u32(int(s.op))
                enc.i32(s.arg1)
                enc.i32(s.arg2)
        enc.u32(len(m.types))
        for tid in sorted(m.types):
            enc.i32(tid)
            enc.str_(m.types[tid])
        t = m.tunables
        for v in (
            t.choose_local_tries, t.choose_local_fallback_tries,
            t.choose_total_tries, t.chooseleaf_descend_once,
            t.chooseleaf_vary_r, t.chooseleaf_stable,
            t.msr_descents, t.msr_collision_tries,
        ):
            enc.u32(v)
        _enc_choose_args(enc, m.choose_args)
        enc.u32(len(m.bucket_names))
        for name in sorted(m.bucket_names):
            enc.str_(name)
            enc.i32(m.bucket_names[name])
        enc.u32(len(m.rule_names))
        for name in sorted(m.rule_names):
            enc.str_(name)
            enc.i32(m.rule_names[name])
        enc.u32(len(m.device_classes))
        for osd in sorted(m.device_classes):
            enc.i32(osd)
            enc.str_(m.device_classes[osd])


def decode_crush(dec: Decoder) -> CrushMap:
    m = CrushMap(types={})
    with dec.versioned() as _crush_v:
        m.max_devices = dec.u32()
        for _ in range(dec.u32()):
            bid = dec.i32()
            btype = dec.i32()
            alg = BucketAlg(dec.u8())
            hash_ = dec.u8()
            size = dec.u32()
            items = [dec.i32() for _ in range(size)]
            weights = [dec.u32() for _ in range(size)]
            b = Bucket(
                id=bid, type=btype, alg=alg, hash=hash_,
                items=items, item_weights=weights,
            )
            b.sum_weights = [dec.u64() for _ in range(dec.u32())]
            b.node_weights = [dec.u64() for _ in range(dec.u32())]
            b.straws = [dec.u64() for _ in range(dec.u32())]
            m.buckets[bid] = b
        for _ in range(dec.u32()):
            rid = dec.u32()
            rtype = dec.u32()
            device_class = dec.str_() if dec.bool_() else None
            steps = [
                RuleStep(RuleOp(dec.u32()), dec.i32(), dec.i32())
                for _ in range(dec.u32())
            ]
            m.rules[rid] = Rule(
                rule_type=rtype, steps=steps, device_class=device_class
            )
        for _ in range(dec.u32()):
            tid = dec.i32()
            m.types[tid] = dec.str_()
        m.tunables = Tunables(
            choose_local_tries=dec.u32(),
            choose_local_fallback_tries=dec.u32(),
            choose_total_tries=dec.u32(),
            chooseleaf_descend_once=dec.u32(),
            chooseleaf_vary_r=dec.u32(),
            chooseleaf_stable=dec.u32(),
        )
        if _crush_v >= 2:
            m.tunables.msr_descents = dec.u32()
            m.tunables.msr_collision_tries = dec.u32()
        m.choose_args = _dec_choose_args(dec)
        for _ in range(dec.u32()):
            name = dec.str_()
            m.bucket_names[name] = dec.i32()
        for _ in range(dec.u32()):
            name = dec.str_()
            m.rule_names[name] = dec.i32()
        for _ in range(dec.u32()):
            osd = dec.i32()
            m.device_classes[osd] = dec.str_()
    return m


# -- pools ------------------------------------------------------------------

def _encode_pool(enc: Encoder, p: PgPool) -> None:
    # v2 appends snapshot state (pg_pool_t snap fields)
    with enc.versioned(2, 1):
        enc.i64(p.id)
        enc.u8(p.type)
        enc.u32(p.size)
        enc.u32(p.min_size)
        enc.i32(p.crush_rule)
        enc.u32(p.pg_num)
        enc.u32(p.pgp_num)
        enc.u32(p.flags)
        enc.str_(p.erasure_code_profile)
        enc.u32(len(p.extra))
        for k in sorted(p.extra):
            v = p.extra[k]
            if not isinstance(v, str):
                from ceph_tpu_torch.msg.denc import EncodingError

                raise EncodingError(
                    f"pool {p.id} extra[{k!r}] must be str, got {type(v).__name__}"
                )
            enc.str_(k)
            enc.str_(v)
        enc.u64(p.snap_seq)
        enc.u32(len(p.removed_snaps))
        for s in sorted(p.removed_snaps):
            enc.u64(s)
        enc.u32(len(p.pool_snaps))
        for name in sorted(p.pool_snaps):
            enc.str_(name)
            enc.u64(p.pool_snaps[name])


def _decode_pool(dec: Decoder) -> PgPool:
    with dec.versioned() as v:
        p = PgPool(
            id=dec.i64(), type=dec.u8(), size=dec.u32(), min_size=dec.u32(),
            crush_rule=dec.i32(), pg_num=dec.u32(), pgp_num=dec.u32(),
            flags=dec.u32(), erasure_code_profile=dec.str_(),
        )
        for _ in range(dec.u32()):
            k = dec.str_()
            p.extra[k] = dec.str_()
        if v >= 2:
            p.snap_seq = dec.u64()
            p.removed_snaps = {dec.u64() for _ in range(dec.u32())}
            p.pool_snaps = {dec.str_(): dec.u64() for _ in range(dec.u32())}
    return p


# -- osdmap -----------------------------------------------------------------

def _encode_pg_table(enc: Encoder, table: dict, value_enc) -> None:
    enc.u32(len(table))
    for pg in sorted(table, key=lambda g: (g.pool, g.ps)):
        enc.i64(pg.pool)
        enc.u32(pg.ps)
        value_enc(table[pg])


def _decode_pg_table(dec: Decoder, value_dec) -> dict:
    out = {}
    for _ in range(dec.u32()):
        pool = dec.i64()
        ps = dec.u32()
        out[pg_t(pool, ps)] = value_dec()
    return out


def encode_osdmap(m: OSDMap) -> bytes:
    enc = Encoder()
    with enc.versioned(1, 1):
        enc.u32(m.epoch)
        enc.u32(m.max_osd)
        for s in m.osd_state:
            enc.u8(s)
        for w in m.osd_weight:
            enc.u32(w)
        enc.bool_(m.osd_primary_affinity is not None)
        if m.osd_primary_affinity is not None:
            for a in m.osd_primary_affinity:
                enc.u32(a)
        enc.u32(len(m.pools))
        for pid in sorted(m.pools):
            _encode_pool(enc, m.pools[pid])
        _encode_pg_table(
            enc, m.pg_upmap,
            lambda v: (enc.u32(len(v)), [enc.i32(o) for o in v]),
        )
        _encode_pg_table(
            enc, m.pg_upmap_items,
            lambda v: (
                enc.u32(len(v)),
                [(enc.i32(a), enc.i32(b)) for a, b in v],
            ),
        )
        _encode_pg_table(enc, m.pg_upmap_primaries, lambda v: enc.i32(v))
        _encode_pg_table(
            enc, m.pg_temp,
            lambda v: (enc.u32(len(v)), [enc.i32(o) for o in v]),
        )
        _encode_pg_table(enc, m.primary_temp, lambda v: enc.i32(v))
        enc.u32(len(m.erasure_code_profiles))
        for name in sorted(m.erasure_code_profiles):
            enc.str_(name)
            prof = m.erasure_code_profiles[name]
            enc.u32(len(prof))
            for k in sorted(prof):
                enc.str_(k)
                enc.str_(prof[k])
        enc.u32(len(m.osd_addrs))
        for osd in sorted(m.osd_addrs):
            host, port = m.osd_addrs[osd]
            enc.i32(osd)
            enc.str_(host)
            enc.u32(port)
        enc.u32(len(m.pool_names))
        for pid in sorted(m.pool_names):
            enc.i64(pid)
            enc.str_(m.pool_names[pid])
        # the mapping pipeline consumes OSDMap.choose_args (balancer
        # overrides), which is distinct from the crush map's own table
        enc.bool_(m.choose_args is not None)
        if m.choose_args is not None:
            _enc_choose_args(enc, m.choose_args)
        encode_crush(enc, m.crush)
    return enc.bytes()


def decode_osdmap(data: bytes) -> OSDMap:
    dec = Decoder(data)
    with dec.versioned():
        epoch = dec.u32()
        max_osd = dec.u32()
        osd_state = [dec.u8() for _ in range(max_osd)]
        osd_weight = [dec.u32() for _ in range(max_osd)]
        affinity = None
        if dec.bool_():
            affinity = [dec.u32() for _ in range(max_osd)]
        pools = {}
        for _ in range(dec.u32()):
            p = _decode_pool(dec)
            pools[p.id] = p
        pg_upmap = _decode_pg_table(
            dec, lambda: [dec.i32() for _ in range(dec.u32())]
        )
        pg_upmap_items = _decode_pg_table(
            dec,
            lambda: [(dec.i32(), dec.i32()) for _ in range(dec.u32())],
        )
        pg_upmap_primaries = _decode_pg_table(dec, dec.i32)
        pg_temp = _decode_pg_table(
            dec, lambda: [dec.i32() for _ in range(dec.u32())]
        )
        primary_temp = _decode_pg_table(dec, dec.i32)
        profiles = {}
        for _ in range(dec.u32()):
            name = dec.str_()
            profiles[name] = {
                dec.str_(): dec.str_() for _ in range(dec.u32())
            }
        addrs = {}
        for _ in range(dec.u32()):
            osd = dec.i32()
            host = dec.str_()
            addrs[osd] = (host, dec.u32())
        pool_names = {}
        for _ in range(dec.u32()):
            pid = dec.i64()
            pool_names[pid] = dec.str_()
        choose_args = _dec_choose_args(dec) if dec.bool_() else None
        crush = decode_crush(dec)
    om = OSDMap(
        crush=crush, epoch=epoch, max_osd=max_osd,
        osd_state=osd_state, osd_weight=osd_weight,
        osd_primary_affinity=affinity, pools=pools,
        pg_upmap=pg_upmap, pg_upmap_items=pg_upmap_items,
        pg_upmap_primaries=pg_upmap_primaries,
        pg_temp=pg_temp, primary_temp=primary_temp,
        erasure_code_profiles=profiles, osd_addrs=addrs,
        pool_names=pool_names, choose_args=choose_args,
    )
    return om


# -- incrementals -----------------------------------------------------------

@dataclass
class Incremental:
    """Delta from epoch-1 to ``epoch`` (reference OSDMap::Incremental).

    Values are absolute (new state byte, new weight, full new pool
    struct, ...) rather than xor-deltas; removals are explicit lists.
    ``new_crush`` ships the whole crush encode when any crush field
    changed — crush churn is rare and the blob is small, mirroring the
    reference's choice to embed a full crush bufferlist.
    """

    epoch: int = 0
    new_max_osd: int | None = None
    new_state: dict[int, int] = field(default_factory=dict)
    new_weight: dict[int, int] = field(default_factory=dict)
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    affinity_present: bool | None = None  # None->list / list->None flips
    new_addrs: dict[int, tuple[str, int]] = field(default_factory=dict)
    removed_addrs: list[int] = field(default_factory=list)
    new_pools: dict[int, PgPool] = field(default_factory=dict)
    removed_pools: list[int] = field(default_factory=list)
    new_pool_names: dict[int, str] = field(default_factory=dict)
    removed_pool_names: list[int] = field(default_factory=list)
    new_profiles: dict[str, dict[str, str]] = field(default_factory=dict)
    removed_profiles: list[str] = field(default_factory=list)
    new_pg_upmap: dict[pg_t, list[int]] = field(default_factory=dict)
    removed_pg_upmap: list[pg_t] = field(default_factory=list)
    new_pg_upmap_items: dict[pg_t, list[tuple[int, int]]] = field(default_factory=dict)
    removed_pg_upmap_items: list[pg_t] = field(default_factory=list)
    new_pg_upmap_primaries: dict[pg_t, int] = field(default_factory=dict)
    removed_pg_upmap_primaries: list[pg_t] = field(default_factory=list)
    new_pg_temp: dict[pg_t, list[int]] = field(default_factory=dict)
    removed_pg_temp: list[pg_t] = field(default_factory=list)
    new_primary_temp: dict[pg_t, int] = field(default_factory=dict)
    removed_primary_temp: list[pg_t] = field(default_factory=list)
    new_choose_args: bytes | None = None  # encoded table (or b"" = clear)
    new_crush: bytes | None = None        # full crush encode


def _enc_pg_list(enc: Encoder, pgs: list[pg_t]) -> None:
    enc.u32(len(pgs))
    for pg in sorted(pgs, key=lambda g: (g.pool, g.ps)):
        enc.i64(pg.pool)
        enc.u32(pg.ps)


def _dec_pg_list(dec: Decoder) -> list[pg_t]:
    return [pg_t(dec.i64(), dec.u32()) for _ in range(dec.u32())]


def encode_incremental(inc: Incremental) -> bytes:
    enc = Encoder()
    with enc.versioned(1, 1):
        enc.u32(inc.epoch)
        enc.bool_(inc.new_max_osd is not None)
        if inc.new_max_osd is not None:
            enc.u32(inc.new_max_osd)
        for table in (inc.new_state, inc.new_weight, inc.new_primary_affinity):
            enc.u32(len(table))
            for osd in sorted(table):
                enc.i32(osd)
                enc.u32(table[osd])
        enc.u8({None: 0, False: 1, True: 2}[inc.affinity_present])
        enc.u32(len(inc.new_addrs))
        for osd in sorted(inc.new_addrs):
            host, port = inc.new_addrs[osd]
            enc.i32(osd)
            enc.str_(host)
            enc.u32(port)
        enc.u32(len(inc.removed_addrs))
        for osd in sorted(inc.removed_addrs):
            enc.i32(osd)
        enc.u32(len(inc.new_pools))
        for pid in sorted(inc.new_pools):
            _encode_pool(enc, inc.new_pools[pid])
        enc.u32(len(inc.removed_pools))
        for pid in sorted(inc.removed_pools):
            enc.i64(pid)
        enc.u32(len(inc.new_pool_names))
        for pid in sorted(inc.new_pool_names):
            enc.i64(pid)
            enc.str_(inc.new_pool_names[pid])
        enc.u32(len(inc.removed_pool_names))
        for pid in sorted(inc.removed_pool_names):
            enc.i64(pid)
        enc.u32(len(inc.new_profiles))
        for name in sorted(inc.new_profiles):
            enc.str_(name)
            prof = inc.new_profiles[name]
            enc.u32(len(prof))
            for k in sorted(prof):
                enc.str_(k)
                enc.str_(prof[k])
        enc.u32(len(inc.removed_profiles))
        for name in sorted(inc.removed_profiles):
            enc.str_(name)
        _encode_pg_table(
            enc, inc.new_pg_upmap,
            lambda v: (enc.u32(len(v)), [enc.i32(o) for o in v]),
        )
        _enc_pg_list(enc, inc.removed_pg_upmap)
        _encode_pg_table(
            enc, inc.new_pg_upmap_items,
            lambda v: (enc.u32(len(v)), [(enc.i32(a), enc.i32(b)) for a, b in v]),
        )
        _enc_pg_list(enc, inc.removed_pg_upmap_items)
        _encode_pg_table(enc, inc.new_pg_upmap_primaries, lambda v: enc.i32(v))
        _enc_pg_list(enc, inc.removed_pg_upmap_primaries)
        _encode_pg_table(
            enc, inc.new_pg_temp,
            lambda v: (enc.u32(len(v)), [enc.i32(o) for o in v]),
        )
        _enc_pg_list(enc, inc.removed_pg_temp)
        _encode_pg_table(enc, inc.new_primary_temp, lambda v: enc.i32(v))
        _enc_pg_list(enc, inc.removed_primary_temp)
        enc.bool_(inc.new_choose_args is not None)
        if inc.new_choose_args is not None:
            enc.bytes_(inc.new_choose_args)
        enc.bool_(inc.new_crush is not None)
        if inc.new_crush is not None:
            enc.bytes_(inc.new_crush)
    return enc.bytes()


def decode_incremental(data: bytes) -> Incremental:
    dec = Decoder(data)
    inc = Incremental()
    with dec.versioned():
        inc.epoch = dec.u32()
        if dec.bool_():
            inc.new_max_osd = dec.u32()
        for table in (inc.new_state, inc.new_weight, inc.new_primary_affinity):
            for _ in range(dec.u32()):
                osd = dec.i32()
                table[osd] = dec.u32()
        inc.affinity_present = {0: None, 1: False, 2: True}[dec.u8()]
        for _ in range(dec.u32()):
            osd = dec.i32()
            host = dec.str_()
            inc.new_addrs[osd] = (host, dec.u32())
        inc.removed_addrs = [dec.i32() for _ in range(dec.u32())]
        for _ in range(dec.u32()):
            p = _decode_pool(dec)
            inc.new_pools[p.id] = p
        inc.removed_pools = [dec.i64() for _ in range(dec.u32())]
        for _ in range(dec.u32()):
            pid = dec.i64()
            inc.new_pool_names[pid] = dec.str_()
        inc.removed_pool_names = [dec.i64() for _ in range(dec.u32())]
        for _ in range(dec.u32()):
            name = dec.str_()
            inc.new_profiles[name] = {
                dec.str_(): dec.str_() for _ in range(dec.u32())
            }
        inc.removed_profiles = [dec.str_() for _ in range(dec.u32())]
        inc.new_pg_upmap = _decode_pg_table(
            dec, lambda: [dec.i32() for _ in range(dec.u32())]
        )
        inc.removed_pg_upmap = _dec_pg_list(dec)
        inc.new_pg_upmap_items = _decode_pg_table(
            dec, lambda: [(dec.i32(), dec.i32()) for _ in range(dec.u32())]
        )
        inc.removed_pg_upmap_items = _dec_pg_list(dec)
        inc.new_pg_upmap_primaries = _decode_pg_table(dec, dec.i32)
        inc.removed_pg_upmap_primaries = _dec_pg_list(dec)
        inc.new_pg_temp = _decode_pg_table(
            dec, lambda: [dec.i32() for _ in range(dec.u32())]
        )
        inc.removed_pg_temp = _dec_pg_list(dec)
        inc.new_primary_temp = _decode_pg_table(dec, dec.i32)
        inc.removed_primary_temp = _dec_pg_list(dec)
        if dec.bool_():
            inc.new_choose_args = dec.bytes_()
        if dec.bool_():
            inc.new_crush = dec.bytes_()
    return inc


def _diff_dict(old: dict, new: dict, added: dict, removed: list) -> None:
    for k, v in new.items():
        if k not in old or old[k] != v:
            added[k] = v
    removed.extend(k for k in old if k not in new)


def diff_osdmap(
    old: OSDMap,
    new: OSDMap,
    old_sections: tuple[bytes | None, bytes] | None = None,
    new_sections: tuple[bytes | None, bytes] | None = None,
) -> Incremental:
    """Delta such that apply_incremental(old, delta) == new, verified
    bit-identical through encode_osdmap.  ``*_sections`` are optional
    pre-computed :func:`crush_sections` results."""
    inc = Incremental(epoch=new.epoch)
    if new.max_osd != old.max_osd:
        inc.new_max_osd = new.max_osd
    for osd in range(new.max_osd):
        olds = old.osd_state[osd] if osd < old.max_osd else None
        if olds != new.osd_state[osd]:
            inc.new_state[osd] = new.osd_state[osd]
        oldw = old.osd_weight[osd] if osd < old.max_osd else None
        if oldw != new.osd_weight[osd]:
            inc.new_weight[osd] = new.osd_weight[osd]
    if (new.osd_primary_affinity is None) != (old.osd_primary_affinity is None):
        inc.affinity_present = new.osd_primary_affinity is not None
    if new.osd_primary_affinity is not None:
        oldaff = old.osd_primary_affinity or []
        for osd in range(new.max_osd):
            o = oldaff[osd] if osd < len(oldaff) else None
            if o != new.osd_primary_affinity[osd]:
                inc.new_primary_affinity[osd] = new.osd_primary_affinity[osd]
    _diff_dict(old.osd_addrs, new.osd_addrs, inc.new_addrs, inc.removed_addrs)
    _diff_dict(old.pools, new.pools, inc.new_pools, inc.removed_pools)
    _diff_dict(
        old.pool_names, new.pool_names,
        inc.new_pool_names, inc.removed_pool_names,
    )
    _diff_dict(
        old.erasure_code_profiles, new.erasure_code_profiles,
        inc.new_profiles, inc.removed_profiles,
    )
    _diff_dict(old.pg_upmap, new.pg_upmap, inc.new_pg_upmap, inc.removed_pg_upmap)
    _diff_dict(
        old.pg_upmap_items, new.pg_upmap_items,
        inc.new_pg_upmap_items, inc.removed_pg_upmap_items,
    )
    _diff_dict(
        old.pg_upmap_primaries, new.pg_upmap_primaries,
        inc.new_pg_upmap_primaries, inc.removed_pg_upmap_primaries,
    )
    _diff_dict(old.pg_temp, new.pg_temp, inc.new_pg_temp, inc.removed_pg_temp)
    _diff_dict(
        old.primary_temp, new.primary_temp,
        inc.new_primary_temp, inc.removed_primary_temp,
    )

    oca, ocr = old_sections if old_sections is not None else crush_sections(old)
    nca, ncr = new_sections if new_sections is not None else crush_sections(new)
    if oca != nca:
        inc.new_choose_args = nca if nca is not None else b""
    if ocr != ncr:
        inc.new_crush = ncr
    return inc


def crush_sections(m: OSDMap) -> tuple[bytes | None, bytes]:
    """(choose_args blob | None, crush blob) — the two expensive
    encodes of diff_osdmap, exposed so a publisher that diffs every
    epoch can cache them instead of re-encoding both sides each time."""
    ca = None
    if m.choose_args is not None:
        e = Encoder()
        _enc_choose_args(e, m.choose_args)
        ca = e.bytes()
    e = Encoder()
    encode_crush(e, m.crush)
    return ca, e.bytes()


def apply_incremental(m: OSDMap, inc: Incremental) -> None:
    """Mutate ``m`` (at epoch N-1) into epoch N.  Raises ValueError on
    an epoch gap — callers then fetch a full map (the reference OSD
    requests the missing range, OSDMap.cc apply_incremental asserts)."""
    if inc.epoch != m.epoch + 1:
        raise ValueError(f"incremental {inc.epoch} onto map {m.epoch}")
    if inc.new_max_osd is not None:
        m.set_max_osd(inc.new_max_osd)
    for osd, s in inc.new_state.items():
        m.osd_state[osd] = s
    for osd, w in inc.new_weight.items():
        m.osd_weight[osd] = w
    if inc.affinity_present is False:
        m.osd_primary_affinity = None
    elif inc.affinity_present is True and m.osd_primary_affinity is None:
        from ceph_tpu_torch.osd.osdmap import CEPH_OSD_DEFAULT_PRIMARY_AFFINITY

        m.osd_primary_affinity = (
            [CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * m.max_osd
        )
    for osd, a in inc.new_primary_affinity.items():
        m.osd_primary_affinity[osd] = a
    m.osd_addrs.update(inc.new_addrs)
    for osd in inc.removed_addrs:
        m.osd_addrs.pop(osd, None)
    m.pools.update(inc.new_pools)
    for pid in inc.removed_pools:
        m.pools.pop(pid, None)
        m.pool_names.pop(pid, None)
    m.pool_names.update(inc.new_pool_names)
    for pid in inc.removed_pool_names:
        m.pool_names.pop(pid, None)
    m.erasure_code_profiles.update(inc.new_profiles)
    for name in inc.removed_profiles:
        m.erasure_code_profiles.pop(name, None)
    for table, new_t, rem in (
        (m.pg_upmap, inc.new_pg_upmap, inc.removed_pg_upmap),
        (m.pg_upmap_items, inc.new_pg_upmap_items, inc.removed_pg_upmap_items),
        (m.pg_upmap_primaries, inc.new_pg_upmap_primaries,
         inc.removed_pg_upmap_primaries),
        (m.pg_temp, inc.new_pg_temp, inc.removed_pg_temp),
        (m.primary_temp, inc.new_primary_temp, inc.removed_primary_temp),
    ):
        table.update(new_t)
        for pg in rem:
            table.pop(pg, None)
    if inc.new_choose_args is not None:
        if inc.new_choose_args == b"":
            m.choose_args = None
        else:
            m.choose_args = _dec_choose_args(Decoder(inc.new_choose_args))
    if inc.new_crush is not None:
        m.crush = decode_crush(Decoder(inc.new_crush))
    m.epoch = inc.epoch


def apply_map_message(osdmap: OSDMap | None, maps: dict[int, bytes],
                      incs: dict[int, bytes]) -> tuple[OSDMap | None, bool]:
    """Shared MOSDMap consumption for the OSD daemon and the client.

    Returns ``(new_map, gap)``.  ``new_map`` is always a NEW object
    when anything changed (copy-on-write swap): callers that captured
    ``self.osdmap`` mid-operation keep a stable snapshot, matching the
    replace-on-decode semantics full maps always had.  ``gap`` is True
    when an incremental didn't connect to our epoch — the caller should
    re-subscribe with its current epoch to get the missing range.
    """
    m = osdmap
    for epoch in sorted(maps):
        if m is None or epoch > m.epoch:
            m = decode_osdmap(maps[epoch])
    for epoch in sorted(incs):
        if m is None or epoch > m.epoch + 1:
            return m, True
        if epoch == m.epoch + 1:
            if m is osdmap:
                # copy before first mutation; later incs in this batch
                # mutate the same fresh copy
                m = decode_osdmap(encode_osdmap(m))
            apply_incremental(m, decode_incremental(incs[epoch]))
    return m, False
