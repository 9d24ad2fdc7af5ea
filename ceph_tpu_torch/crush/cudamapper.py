"""Batched CRUSH placement: every seed of a pool through one rule at once.

Counterpart of ``ceph_tpu/crush/jaxmapper.py``, the engine behind the
whole-cluster remap (``osd/remap.py``), the batched analogue of the
reference's thread-pooled ParallelPGMapper (src/osd/OSDMapMapping.h).
It computes exactly what the scalar interpreter (``crush/mapper.py``,
a twin of src/crush/mapper.c) computes for each seed, on the maps the
batched engine takes: straw2 buckets, rjenkins1, no local fallback
tries.  Every rule step kind, chooseleaf recursion, vary_r / stable,
device classes, choose_args weight sets, reweights and the MSR rules
are covered; other maps raise :class:`UnsupportedMap` (the remap then
uses the scalar pipeline by design, as the reference does).

:func:`compile_map` flattens a map into dense padded arrays
(:class:`CompiledCrush`); :func:`device_map` puts them on a device once
per compiled map.  :class:`BatchedRuleMapper` maps a batch of seeds:

- on the card, one launch of the hand-written kernel of
  ``ops/csrc/crush_rule.cu`` (one warp per seed, a lane per bucket item
  in straw2, the rule as a small program of steps), through the entry
  point of the rule's kind,
  :func:`crush_rule_firstn`, :func:`crush_rule_indep` or
  :func:`crush_rule_msr`, each counting its launches;
- on the CPU, the plain PyTorch version :func:`batched_rule_plain`, the
  JAX program's lanes with the vmap axis written out as a leading batch
  dimension: each ``lax.while_loop`` is a Python loop over an active
  mask, and the trace-time unrolls (rule steps, reps, MSR strides) stay
  Python loops.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ceph_tpu_torch.crush._ln_tables import LL_TBL, RH_LH_TBL
from ceph_tpu_torch.crush.mapper import _msr_scan_config_steps, _msr_scan_next
from ceph_tpu_torch.crush.types import (
    CRUSH_HASH_RJENKINS1,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    RULE_TYPE_MSR_FIRSTN,
    RULE_TYPE_MSR_INDEP,
    BucketAlg,
    ChooseArg,
    CrushMap,
    RuleOp,
)
from ceph_tpu_torch.ops.hashing import crush_hash32_2_torch, crush_hash32_3_torch
from ceph_tpu_torch.ops.rs_kernels import _on_cpu, count_launch, resolve_device

# while-loop statuses
_RUN, _PLACED, _SKIP = 0, 1, 2
# indep descent outcomes
_OUT_BREAK, _OUT_PLACE, _OUT_NONE = 0, 1, 2

_S64_MIN = -(2 ** 63)

#: the kernel's compile-time caps (``kMaxResult``, ``kMaxSteps``,
#: ``kMaxMsrLevels`` in the source): per-seed scratch is fixed-size
MAX_RESULT = 32
MAX_STEPS = 32
MAX_MSR_LEVELS = 6


class UnsupportedMap(NotImplementedError):
    """Map or rule uses a feature outside the batched engine's surface."""


@dataclasses.dataclass
class CompiledCrush:
    """Dense-array form of a CrushMap (+ one choose_args set)."""

    items: np.ndarray     # [NB, M] int32, padded with 0
    child: np.ndarray     # [NB, M] int32: dense idx of sub-bucket, -1 if device/unknown
    argids: np.ndarray    # [NB, M] int32: choose_args ids override (default items)
    weights: np.ndarray   # [NB, P, M] int64: per-position weights (16.16)
    npos: np.ndarray      # [NB] int32: valid weight positions per bucket
    size: np.ndarray      # [NB] int32
    btype: np.ndarray     # [NB] int32
    idx_of_arr: np.ndarray  # [K] int32: (-1 - bucket_id) -> dense idx, -1 unknown
    idx_of: dict          # bucket id -> dense idx
    max_devices: int
    max_depth: int
    tunables: object
    rules: dict
    device_classes: dict
    #: device -> DeviceMap, filled by device_map()
    device_maps: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


def compile_map(
    cmap: CrushMap, choose_args: dict[int, ChooseArg] | None = None
) -> CompiledCrush:
    """Flatten a CrushMap into gather-friendly arrays.

    ``choose_args`` (balancer weight-set overrides) are baked in; pass a
    different set to get a different compiled map, mirroring how the
    reference snapshots choose_args per crush_do_rule call
    (mapper.c:290-307).
    """
    ids = sorted(cmap.buckets.keys(), reverse=True)  # -1, -2, ...
    for bid in ids:
        b = cmap.buckets[bid]
        if b.alg != BucketAlg.STRAW2:
            raise UnsupportedMap(f"bucket {bid}: alg {b.alg!r} not batched")
        if b.hash != CRUSH_HASH_RJENKINS1:
            raise UnsupportedMap(f"bucket {bid}: hash {b.hash}")
    nb = max(len(ids), 1)
    m = max((cmap.buckets[i].size for i in ids), default=0)
    m = max(m, 1)
    idx_of = {bid: i for i, bid in enumerate(ids)}
    npos_all = 1
    if choose_args:
        for arg in choose_args.values():
            if arg.weight_set:
                npos_all = max(npos_all, len(arg.weight_set))

    items = np.zeros((nb, m), np.int32)
    child = np.full((nb, m), -1, np.int32)
    argids = np.zeros((nb, m), np.int32)
    weights = np.zeros((nb, npos_all, m), np.int64)
    npos = np.ones(nb, np.int32)
    size = np.zeros(nb, np.int32)
    btype = np.zeros(nb, np.int32)
    for bid in ids:
        i = idx_of[bid]
        b = cmap.buckets[bid]
        n = b.size
        size[i] = n
        btype[i] = b.type
        items[i, :n] = b.items
        argids[i, :n] = b.items
        for j, it in enumerate(b.items):
            if it < 0 and it in idx_of:
                child[i, j] = idx_of[it]
        weights[i, :, :n] = np.asarray(b.item_weights, np.int64)[None, :]
        arg = (choose_args or {}).get(bid)
        if arg is not None:
            if arg.ids is not None:
                argids[i, :n] = arg.ids
            if arg.weight_set:
                p = len(arg.weight_set)
                npos[i] = p
                for pi in range(p):
                    weights[i, pi, :n] = np.asarray(arg.weight_set[pi], np.int64)
                # positions beyond the set clamp to the last one
                for pi in range(p, npos_all):
                    weights[i, pi, :n] = weights[i, p - 1, :n]

    # depth bound for descent loops (and DAG check)
    depth: dict[int, int] = {}

    def _depth(bid: int, stack: frozenset) -> int:
        if bid in stack:
            raise UnsupportedMap("cycle in bucket graph")
        if bid in depth:
            return depth[bid]
        b = cmap.buckets[bid]
        d = 1 + max(
            (_depth(it, stack | {bid}) for it in b.items if it in cmap.buckets),
            default=0,
        )
        depth[bid] = d
        return d

    max_depth = max((_depth(bid, frozenset()) for bid in ids), default=1)

    k = max((-bid for bid in ids), default=0)
    idx_of_arr = np.full(max(k, 1), -1, np.int32)
    for bid in ids:
        idx_of_arr[-1 - bid] = idx_of[bid]

    return CompiledCrush(
        items=items, child=child, argids=argids, weights=weights,
        npos=npos, size=size, btype=btype,
        idx_of_arr=idx_of_arr, idx_of=idx_of,
        max_devices=cmap.max_devices, max_depth=max_depth,
        tunables=cmap.tunables, rules=cmap.rules,
        device_classes=dict(cmap.device_classes),
    )


# ---------------------------------------------------------------------------
# The compiled map on a device
# ---------------------------------------------------------------------------

#: uploads of a compiled map to a device (one per map and device)
stats = {"map_uploads": 0}


class DeviceMap:
    """A CompiledCrush's arrays on one device, with the crush_ln tables
    (258 RH/LH words, then 256 LL words, as one int64 block).  Immutable
    after the upload, so every rule mapper of the map shares it."""

    def __init__(self, cc: CompiledCrush, device: torch.device):
        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

        self.items = put(cc.items, torch.int32)
        self.child = put(cc.child, torch.int32)
        self.argids = put(cc.argids, torch.int32)
        self.weights = put(cc.weights, torch.int64)
        self.npos = put(cc.npos, torch.int32)
        self.size = put(cc.size, torch.int32)
        self.btype = put(cc.btype, torch.int32)
        self.idx_of_arr = put(cc.idx_of_arr, torch.int32)
        self.ln = put(np.concatenate([np.asarray(RH_LH_TBL, np.int64),
                                      np.asarray(LL_TBL, np.int64)]), torch.int64)
        assert self.ln.numel() == 258 + 256
        self.rh_lh, self.ll = self.ln[:258], self.ln[258:]
        self.nb, self.m = cc.items.shape
        self.npos_all = cc.weights.shape[1]
        self.max_devices = cc.max_devices


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_map(cc: CompiledCrush, device) -> DeviceMap:
    """The compiled map's arrays on ``device``, uploaded on first use."""
    dev = _device_key(device)
    dm = cc.device_maps.get(dev)
    if dm is None:
        dm = cc.device_maps[dev] = DeviceMap(cc, dev)
        stats["map_uploads"] += 1
    return dm


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

def crush_ln_plain(dm: DeviceMap, u: torch.Tensor) -> torch.Tensor:
    """crush_ln (mapper.c:229-271) on int32 tensors in [0, 0xffff] ->
    int64, 2^44 * log2(u + 1).  The product ``x * RH`` is taken in int64,
    which wraps to the same bits as the C code's uint64; only bits 48-55
    of it are used, so an arithmetic ``>> 48`` and ``& 0xFF`` are exact."""
    x = u.to(torch.int32) + 1
    # bit length of x <= 0x10000: exact from frexp of its float32
    bl = torch.frexp(x.to(torch.float32)).exponent.to(torch.int32)
    cond = (x & 0x18000) == 0
    bits = 16 - bl
    x2 = torch.where(cond, x << torch.where(cond, bits, 0), x)
    iexpon = torch.where(cond, 15 - bits, 15)
    index1 = ((x2 >> 8) << 1).long()
    rh = dm.rh_lh[index1 - 256]
    lh = dm.rh_lh[index1 - 255]
    xl64 = (x2.long() * rh) >> 48
    lh2 = (lh + dm.ll[xl64 & 0xFF]) >> 4
    return (iexpon.long() << 44) + lh2


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (the row width if none)."""
    ar = torch.arange(mask.shape[1], device=mask.device)
    return torch.where(mask, ar, mask.shape[1]).amin(1)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True of each row (-1 if none)."""
    ar = torch.arange(mask.shape[1], device=mask.device)
    return torch.where(mask, ar, -1).amax(1)


def _i32(v: int) -> int:
    """A Python int's low 32 bits as a signed int32 value."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


class _Lanes:
    """One batch of seeds through one rule: the vmap axis written out.
    Every per-lane value is a tensor whose first dimension is the lane."""

    def __init__(self, dm: DeviceMap, x: torch.Tensor, rew: torch.Tensor):
        self.dm = dm
        self.x = x
        self.rew = rew
        self.b = x.shape[0]
        self.device = x.device
        self.ar_m = torch.arange(dm.m, device=x.device)

    def full(self, value: int, *shape: int) -> torch.Tensor:
        return torch.full((self.b, *shape), value, dtype=torch.int32, device=self.device)

    def straw2(self, bidx, r, pos):
        """bucket_straw2_choose (mapper.c:342-365) for each lane's bucket
        ``bidx``: exponential-minimum draw per item, the first maximum
        wins.  Returns (item, child_idx)."""
        dm = self.dm
        bidx = bidx.long()
        ids = dm.argids[bidx]                                   # [B, M]
        p = torch.minimum(torch.clamp(torch.as_tensor(pos, device=self.device), min=0),
                          dm.npos[bidx] - 1).long()
        w = dm.weights[bidx, p]                                 # [B, M] int64
        if not isinstance(r, torch.Tensor):
            r = _i32(r)
        else:
            r = r[:, None]
        u = crush_hash32_3_torch(self.x[:, None], ids, r) & 0xFFFF
        num = (1 << 48) - crush_ln_plain(dm, u)                 # >= 0
        draw = torch.where(w > 0, -torch.div(num, torch.clamp(w, min=1),
                                             rounding_mode="floor"), _S64_MIN)
        in_range = self.ar_m[None, :] < dm.size[bidx][:, None]
        draw = torch.where(in_range, draw, _S64_MIN)
        hi = _first_true(draw == draw.amax(1, keepdim=True))[:, None]
        return (torch.gather(dm.items[bidx], 1, hi)[:, 0],
                torch.gather(dm.child[bidx], 1, hi)[:, 0])

    def is_out(self, item):
        """Reweight rejection, mapper.c:405-419 (is_out)."""
        dm = self.dm
        if dm.max_devices:
            w = self.rew[torch.clamp(item, 0, dm.max_devices - 1).long()]
        else:
            w = torch.zeros_like(item)
        h = crush_hash32_2_torch(self.x, item) & 0xFFFF
        return ~(w >= 0x10000) & ((w == 0) | (h >= w))

    def classify(self, item, cidx, type_):
        """(is_dev, want, descend, skip) of a drawn item."""
        dm = self.dm
        too_big = item >= dm.max_devices
        is_dev = item >= 0
        known = is_dev | (cidx >= 0)
        ityp = torch.where(is_dev | ~known, 0,
                           dm.btype[torch.clamp(cidx, 0, dm.nb - 1).long()])
        mismatch = ~known | (ityp != type_)
        want = ~too_big & ~mismatch
        descend = ~too_big & mismatch & known & ~is_dev
        skip = too_big | (mismatch & (is_dev | ~known))
        return is_dev, want, descend, skip


def _firstn_attempt(L: _Lanes, root, rep, parent_r, outpos, coll_buf, out2_buf,
                    active, *, type_, tries, local_retries, recurse,
                    recurse_tries, vary_r, stable):
    """One replica attempt of crush_choose_firstn (mapper.c:441-629), the
    retry_descent / retry_bucket machinery as a loop over the lanes still
    running.  Returns (placed, item, leaf)."""
    dm = L.dm
    cap = coll_buf.shape[1]
    ar = torch.arange(cap, device=L.device)
    status = torch.where(active, _RUN, _SKIP).to(torch.int32)
    in_idx = root.clone()
    flocal = L.full(0)
    ftotal = L.full(0)
    item0 = L.full(0)
    leaf0 = L.full(0)
    while True:
        run = status == _RUN
        if not bool(run.any()):
            break
        size = dm.size[in_idx.long()]
        r = rep + parent_r + ftotal
        item, cidx = L.straw2(in_idx, r, outpos)
        empty = size == 0
        is_dev, want, descend, skip_now = L.classify(item, cidx, type_)
        want = want & ~empty
        descend = descend & ~empty
        skip_now = skip_now & ~empty
        collide = want & ((ar[None, :] < outpos[:, None])
                          & (coll_buf == item[:, None])).any(1)
        if recurse:
            sub_root = torch.where(cidx >= 0, cidx, in_idx)
            sub_rep = 0 if stable else outpos
            sub_parent_r = (r >> (vary_r - 1)) if vary_r else 0
            do_rec = run & want & ~collide & ~is_dev
            leaf_ok, leaf_item, _ = _firstn_attempt(
                L, sub_root, sub_rep, sub_parent_r, outpos, out2_buf, out2_buf,
                do_rec, type_=0, tries=recurse_tries,
                local_retries=local_retries, recurse=False, recurse_tries=0,
                vary_r=vary_r, stable=stable)
            leaf_reject = do_rec & ~leaf_ok
            leaf_val = torch.where(is_dev, item, leaf_item)
        else:
            leaf_reject = torch.zeros_like(run)
            leaf_val = item
        if type_ == 0:
            out_rej = want & ~collide & ~leaf_reject & is_dev & L.is_out(item)
        else:
            out_rej = torch.zeros_like(run)
        fail = empty | (want & (collide | leaf_reject | out_rej))
        place = want & ~collide & ~leaf_reject & ~out_rej
        ftotal2 = ftotal + fail.int()
        flocal2 = flocal + fail.int()
        retry_same = fail & collide & (flocal2 <= local_retries)
        retry_root = fail & ~retry_same & (ftotal2 < tries)
        give_up = fail & ~retry_same & ~retry_root
        new_status = torch.where(place, _PLACED,
                                 torch.where(skip_now | give_up, _SKIP, _RUN))
        new_in = torch.where(descend, torch.clamp(cidx, 0, dm.nb - 1),
                             torch.where(retry_root, root, in_idx))
        status = torch.where(run, new_status, status).to(torch.int32)
        in_idx = torch.where(run, new_in, in_idx)
        flocal = torch.where(run, torch.where(retry_root, 0, flocal2), flocal)
        ftotal = torch.where(run, ftotal2, ftotal)
        item0 = torch.where(run & place, item, item0)
        leaf0 = torch.where(run & place, leaf_val, leaf0)
    return status == _PLACED, item0, leaf0


def _firstn_window(L: _Lanes, root, valid, numrep, out_size, cap, **kw):
    """One input bucket's output window of crush_choose_firstn: up to
    ``numrep`` attempts, placements bounded by ``out_size`` (avail).
    Returns (out[B, cap], out2[B, cap], n_placed[B])."""
    out = L.full(CRUSH_ITEM_UNDEF, cap)
    out2 = L.full(CRUSH_ITEM_UNDEF, cap)
    outpos = L.full(0)
    ar = torch.arange(cap, device=L.device)
    for rep in range(numrep):
        active = valid & (outpos < out_size)
        if not bool(active.any()):
            break  # outpos only grows: no later rep is active either
        placed, item, leaf = _firstn_attempt(
            L, root, rep, 0, outpos, out, out2, active, **kw)
        commit = active & placed
        slot = (ar[None, :] == outpos[:, None]) & commit[:, None]
        out = torch.where(slot, item[:, None], out)
        out2 = torch.where(slot, leaf[:, None], out2)
        outpos = outpos + commit.int()
    return out, out2, outpos


def _indep_descent(L: _Lanes, root, rep, numrep, ftotal, parent_r, pos, out_buf,
                   act, active, *, type_, recurse, recurse_tries):
    """One slot descent of crush_choose_indep (mapper.c:660-800 body) for
    the ``active`` lanes.  Returns (outcome, item, leaf)."""
    dm = L.dm
    status = torch.where(active, _RUN, 1).to(torch.int32)
    in_idx = root.clone()
    oc0 = L.full(_OUT_BREAK)
    item0 = L.full(0)
    leaf0 = L.full(0)
    while True:
        run = status == _RUN
        if not bool(run.any()):
            break
        size = dm.size[in_idx.long()]
        r = rep + parent_r + numrep * ftotal
        item, cidx = L.straw2(in_idx, r, pos)
        empty = size == 0
        is_dev, want, descend, skip_now = L.classify(item, cidx, type_)
        want = want & ~empty
        descend = descend & ~empty
        place_none = skip_now & ~empty
        collide = want & (act & (out_buf == item[:, None])).any(1)
        if recurse:
            sub_root = torch.where(cidx >= 0, cidx, in_idx)
            do_rec = run & want & ~collide & ~is_dev
            leaf_item = _indep_leaf(L, sub_root, rep, numrep, r, do_rec,
                                    recurse_tries=recurse_tries)
            leaf_fail = do_rec & (leaf_item == CRUSH_ITEM_NONE)
            leaf_val = torch.where(is_dev, item, leaf_item)
        else:
            leaf_fail = torch.zeros_like(run)
            leaf_val = item
        if type_ == 0:
            out_rej = want & ~collide & ~leaf_fail & is_dev & L.is_out(item)
        else:
            out_rej = torch.zeros_like(run)
        brk = empty | (want & (collide | leaf_fail | out_rej))
        place = want & ~collide & ~leaf_fail & ~out_rej
        outcome = torch.where(place, _OUT_PLACE,
                              torch.where(place_none, _OUT_NONE, _OUT_BREAK))
        done = place | place_none | brk
        status = torch.where(run & done, 1, status).to(torch.int32)
        in_idx = torch.where(run & descend, torch.clamp(cidx, 0, dm.nb - 1), in_idx)
        oc0 = torch.where(run & done, outcome, oc0).to(torch.int32)
        item0 = torch.where(run & place, item, item0)
        leaf0 = torch.where(run & place, leaf_val, leaf0)
    return oc0, item0, leaf0


def _indep_leaf(L: _Lanes, sub_root, rep, numrep, parent_r, active, *, recurse_tries):
    """The chooseleaf recursion of crush_choose_indep: a 1-slot indep
    window at type 0 with its own ftotal loop (tries=recurse_tries,
    choose-arg position = rep).  Returns the leaf item or NONE."""
    leaf = L.full(CRUSH_ITEM_UNDEF)
    dummy = L.full(CRUSH_ITEM_UNDEF, 1)
    no_act = torch.zeros((L.b, 1), dtype=torch.bool, device=L.device)
    ftotal = 0
    running = active & (ftotal < recurse_tries)
    while bool(running.any()):
        oc, item, _ = _indep_descent(
            L, sub_root, rep, numrep, ftotal, parent_r, rep, dummy, no_act,
            running, type_=0, recurse=False, recurse_tries=0)
        leaf2 = torch.where(oc == _OUT_PLACE, item,
                            torch.where(oc == _OUT_NONE, CRUSH_ITEM_NONE, leaf))
        leaf = torch.where(running, leaf2, leaf)
        ftotal += 1
        running = running & (leaf == CRUSH_ITEM_UNDEF) & (ftotal < recurse_tries)
    return torch.where(leaf == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE, leaf)


def _indep_window(L: _Lanes, root, valid, numrep, left0, nw, *, type_, tries,
                  recurse, recurse_tries):
    """crush_choose_indep over one window: positionally stable,
    breadth-first rounds bounded by ``tries``.  Returns (out[B, nw],
    out2[B, nw]) with NONE holes."""
    ar = torch.arange(nw, device=L.device)
    act = (ar[None, :] < left0[:, None]) & valid[:, None]
    out = L.full(CRUSH_ITEM_UNDEF, nw)
    out2 = L.full(CRUSH_ITEM_UNDEF, nw)
    ftotal = 0
    running = (act & (out == CRUSH_ITEM_UNDEF)).any(1) & (ftotal < tries)
    while bool(running.any()):
        for rep in range(nw):
            need = running & act[:, rep] & (out[:, rep] == CRUSH_ITEM_UNDEF)
            if not bool(need.any()):
                continue
            oc, item, leaf = _indep_descent(
                L, root, rep, numrep, ftotal, 0, 0, out, act, need,
                type_=type_, recurse=recurse, recurse_tries=recurse_tries)
            place = need & (oc == _OUT_PLACE)
            pnone = need & (oc == _OUT_NONE)
            out = out.clone()
            out2 = out2.clone()
            out[:, rep] = torch.where(place, item,
                                      torch.where(pnone, CRUSH_ITEM_NONE, out[:, rep]))
            out2[:, rep] = torch.where(place, leaf,
                                       torch.where(pnone, CRUSH_ITEM_NONE, out2[:, rep]))
        ftotal += 1
        running = running & (act & (out == CRUSH_ITEM_UNDEF)).any(1) & (ftotal < tries)
    out = torch.where(act & (out != CRUSH_ITEM_UNDEF), out, CRUSH_ITEM_NONE)
    out2 = torch.where(act & (out2 != CRUSH_ITEM_UNDEF), out2, CRUSH_ITEM_NONE)
    return out, out2


def _append(acc, cnt, vals, n, rm):
    """result.extend(vals[:n]) per lane, with a dump slot at index rm."""
    ln = vals.shape[1]
    ar = torch.arange(ln, device=acc.device)
    idx = cnt[:, None] + ar[None, :]
    ok = (ar[None, :] < n[:, None]) & (idx < rm)
    tgt = torch.where(ok, idx, rm).long()
    acc = acc.scatter(1, tgt, torch.where(ok, vals, acc[:, rm:rm + 1]))
    cnt = torch.minimum(cnt + torch.clamp(n, min=0), torch.full_like(cnt, rm))
    return acc, cnt


def _classic_plain(mapper: "BatchedRuleMapper", L: _Lanes):
    """crush_do_rule over the lanes for a classic (non-MSR) rule; the steps
    are interpreted in Python as the JAX program traces them."""
    cc, rm, dm = mapper.cc, mapper.result_max, L.dm
    t = cc.tunables
    choose_tries = t.choose_total_tries + 1
    choose_leaf_tries = 0
    local_retries = t.choose_local_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    res = L.full(CRUSH_ITEM_NONE, rm + 1)
    res_cnt = L.full(0)
    w: tuple = ("empty",)
    for step in mapper.rule.steps:
        op = step.op
        if op == RuleOp.TAKE:
            ok = (0 <= step.arg1 < cc.max_devices) or step.arg1 in cc.idx_of
            w = ("static", step.arg1) if ok else ("empty",)
        elif op == RuleOp.SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == RuleOp.SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                local_retries = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN,
                    RuleOp.CHOOSE_INDEP, RuleOp.CHOOSELEAF_INDEP):
            if w[0] == "empty":
                continue
            firstn = op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN)
            leafy = op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP)
            if firstn:
                if choose_leaf_tries:
                    recurse_tries = choose_leaf_tries
                elif t.chooseleaf_descend_once:
                    recurse_tries = 1
                else:
                    recurse_tries = choose_tries
            else:
                recurse_tries = choose_leaf_tries if choose_leaf_tries else 1

            if w[0] == "static":
                wi = w[1]
                if wi >= 0 or wi not in cc.idx_of:
                    sources = []
                else:
                    sources = [(L.full(cc.idx_of[wi]),
                                torch.ones(L.b, dtype=torch.bool, device=L.device))]
            else:
                vals, cnt = w[1], w[2]
                sources = []
                for j in range(rm):
                    wi = vals[:, j]
                    key = torch.clamp(-1 - wi, 0, dm.idx_of_arr.shape[0] - 1)
                    cidx = dm.idx_of_arr[key.long()]
                    valid = (j < cnt) & (wi < 0) & (cidx >= 0)
                    if bool(valid.any()):
                        sources.append((torch.clamp(cidx, 0, dm.nb - 1), valid))

            o = L.full(CRUSH_ITEM_NONE, rm + 1)
            o_cnt = L.full(0)
            for root, valid in sources:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += rm
                    if numrep <= 0:
                        continue
                avail = rm - o_cnt
                nw = min(numrep, rm)
                if firstn:
                    out, out2, n = _firstn_window(
                        L, root, valid, numrep, torch.clamp(avail, max=numrep), nw,
                        type_=step.arg2, tries=choose_tries,
                        local_retries=local_retries, recurse=leafy,
                        recurse_tries=recurse_tries, vary_r=vary_r, stable=stable)
                else:
                    left0 = torch.clamp(torch.clamp(avail, max=numrep), 0, nw)
                    out, out2 = _indep_window(
                        L, root, valid, numrep, left0, nw, type_=step.arg2,
                        tries=choose_tries, recurse=leafy,
                        recurse_tries=recurse_tries)
                    n = left0
                n = torch.where(valid, n, 0)
                o, o_cnt = _append(o, o_cnt, out2 if leafy else out, n, rm)
            w = ("lanes", o[:, :rm], o_cnt)
        elif op == RuleOp.EMIT:
            if w[0] == "static":
                res, res_cnt = _append(res, res_cnt, L.full(w[1], 1), L.full(1), rm)
            elif w[0] == "lanes":
                res, res_cnt = _append(res, res_cnt, w[1], w[2], rm)
            w = ("empty",)
    return res[:, :rm], res_cnt


def _msr_descend(L: _Lanes, bidx0, type_, r: int, pos: int, enabled):
    """crush_msr_descend (mapper.c:1274) for the ``enabled`` lanes: draw
    at each level until a device or a bucket of ``type_``.  Returns
    (item, child_idx); NONE encodes every map-integrity reject (empty
    bucket, dangling child, oversized device id)."""
    dm = L.dm
    bidx = bidx0.clone()
    done = ~enabled
    item = L.full(CRUSH_ITEM_NONE)
    ci = L.full(-1)
    depth = 0
    while depth < dm.nb + 2:
        run = ~done
        if not bool(run.any()):
            break
        empty = dm.size[bidx.long()] == 0
        it, cidx = L.straw2(bidx, r, pos)
        is_dev = it >= 0
        dev_ok = is_dev & (it < dm.max_devices)
        known = cidx >= 0
        btype = dm.btype[torch.clamp(cidx, 0, dm.nb - 1).long()]
        hit_type = ~is_dev & known & (btype == type_)
        stop = run & (empty | is_dev | ~known | hit_type)
        new_it = torch.where(empty | (is_dev & ~dev_ok) | (~is_dev & ~known),
                             CRUSH_ITEM_NONE, it)
        item = torch.where(stop, new_it, item)
        ci = torch.where(stop, torch.where(hit_type, cidx, -1), ci)
        bidx = torch.where(run & ~stop, cidx, bidx)
        done = done | stop
        depth += 1
    return item, ci


def _msr_valid(vec, lo, hi, s_lo, s_hi, cand):
    """crush_msr_valid_candidate: a candidate used elsewhere in [lo, hi)
    is invalid unless that use is inside our own stride [s_lo, s_hi)."""
    hit = vec[:, lo:hi] == cand[:, None]
    ar = torch.arange(lo, hi, device=vec.device)
    inside = (ar >= s_lo) & (ar < s_hi)
    return ~(hit & ~inside[None, :]).any(1)


def _msr_push(vec, s_lo, s_hi, cand, do):
    """crush_msr_push_used: set the first UNDEF slot of the stride window
    unless the candidate is already there.  Returns (vec, pushed)."""
    win = vec[:, s_lo:s_hi]
    present = (win == cand[:, None]).any(1)
    slots = win == CRUSH_ITEM_UNDEF
    pos = _first_true(slots)
    pushed = do & ~present & slots.any(1)
    ar = torch.arange(s_hi - s_lo, device=vec.device)
    vec = vec.clone()
    vec[:, s_lo:s_hi] = torch.where(pushed[:, None] & (ar[None, :] == pos[:, None]),
                                    cand[:, None], win)
    return vec, pushed


def _msr_pop(vec, s_lo, s_hi, cand, do):
    """crush_msr_pop_used: clear the last slot == cand of the window."""
    win = vec[:, s_lo:s_hi]
    eq = win == cand[:, None]
    pos = _last_true(eq)
    ar = torch.arange(s_hi - s_lo, device=vec.device)
    vec = vec.clone()
    vec[:, s_lo:s_hi] = torch.where((do & eq.any(1))[:, None] & (ar[None, :] == pos[:, None]),
                                    CRUSH_ITEM_UNDEF, win)
    return vec


def _msr_plain(mapper: "BatchedRuleMapper", L: _Lanes):
    """Batched crush_msr_do_rule (mapper.c:1809): the stride tree is
    static (from the steps' counts and result_max), so the multi-step
    descent unrolls in Python; whole-descent retries (msr_descents),
    per-stride collision retries and the bucket-graph descent loop over
    the lanes still running.  Every running lane of a loop has the same
    trip count (they all start together), so ``tryno``, ``lt`` and the
    descent depth are Python ints."""
    cc, rm, rule, dm = mapper.cc, mapper.result_max, mapper.rule, L.dm
    firstn = rule.rule_type == RULE_TYPE_MSR_FIRSTN
    t = cc.tunables
    start_stepno, descents, collision_tries = _msr_scan_config_steps(rule)
    if descents is None:
        descents = t.msr_descents
    if collision_tries is None:
        collision_tries = t.msr_collision_tries

    ar1 = torch.arange(rm + 1, device=L.device)
    out = L.full(CRUSH_ITEM_NONE, rm + 1)
    returned = L.full(0)

    def emit(out, returned, cand, position, do):
        pos = returned if firstn else torch.full_like(returned, position)
        out = torch.where((ar1[None, :] == pos[:, None]) & do[:, None], cand[:, None], out)
        return out, returned + do.int()

    def choose(vecs, out, returned, bidx, tryno, enabled, lo, hi, total,
               stepno, seg_start, emit_stepno):
        """_msr_choose (mapper.c:1507): one level, strides unrolled; a
        lane that is not ``enabled`` changes nothing."""
        curstep = rule.steps[stepno]
        num_strides = curstep.arg1 if curstep.arg1 else rm
        mapped = L.full(0)
        if num_strides <= 0 or total % num_strides != 0:
            return out, returned, mapped  # malformed: skip
        length = total // num_strides
        if length <= 0:
            return out, returned, mapped
        level = stepno - seg_start
        leaf_level = emit_stepno - seg_start - 1
        is_leaf = curstep.arg2 == 0
        undos = []
        for sidx, s_lo in enumerate(range(lo, hi, length)):
            s_hi = min(s_lo + length, hi)
            filled = (vecs[leaf_level][:, s_lo:s_hi] != CRUSH_ITEM_UNDEF).all(1)
            running = enabled & ~filled
            found = torch.zeros_like(running)
            cand = L.full(CRUSH_ITEM_NONE)
            cand_ci = L.full(-1)
            lt = 0
            while lt < collision_tries and bool(running.any()):
                r = (((tryno * rm) + sidx) << 16) + lt
                c, ci = _msr_descend(L, bidx, curstep.arg2, r, sidx, running)
                valid = running & (c != CRUSH_ITEM_NONE) & _msr_valid(
                    vecs[level], lo, hi, s_lo, s_hi, c)
                cand = torch.where(valid, c, cand)
                cand_ci = torch.where(valid, ci, cand_ci)
                found = found | valid
                running = running & ~valid
                lt += 1
            if is_leaf:
                # leaf: stride_length must be 1 and this must be the last
                # step (static malformed-rule guards)
                if length != 1 or stepno + 1 != emit_stepno:
                    continue
                do = found & ~L.is_out(cand)
                vecs[level], _ = _msr_push(vecs[level], s_lo, s_hi, cand, do)
                out, returned = emit(out, returned, cand, s_lo, do)
                mapped = mapped + do.int()
            else:
                if stepno + 1 >= emit_stepno:
                    continue  # malformed
                en_child = found & (cand < 0)
                out, returned, child_mapped = choose(
                    vecs, out, returned, torch.clamp(cand_ci, 0, dm.nb - 1), tryno,
                    en_child, s_lo, s_hi, length, stepno + 1, seg_start, emit_stepno)
                vecs[level], pushed = _msr_push(vecs[level], s_lo, s_hi, cand, en_child)
                # a pushed interior candidate whose subtree mapped nothing
                # is popped, but only after every stride at this level ran
                undos.append((s_lo, s_hi, cand, pushed & (child_mapped == 0)))
                mapped = mapped + child_mapped
        for s_lo, s_hi, cand, flag in undos:
            vecs[level] = _msr_pop(vecs[level], s_lo, s_hi, cand, flag)
        return out, returned, mapped

    none_result = (L.full(CRUSH_ITEM_NONE, rm), L.full(0))
    stepno = start_stepno
    start_index = 0
    while stepno < len(rule.steps):
        scan = _msr_scan_next(rule, rm, stepno)
        if scan is None:
            return none_result  # invalid rule: "return whatever we have"
        total_children, emit_stepno = scan
        take_step = rule.steps[stepno]
        if take_step.arg1 >= 0:
            if stepno + 1 != emit_stepno:
                return none_result
            # as the scalar twin: no start_index advance after a device take
            out, returned = emit(out, returned, L.full(take_step.arg1), start_index,
                                 torch.ones(L.b, dtype=torch.bool, device=L.device))
        elif take_step.arg1 in cc.idx_of:
            root = L.full(cc.idx_of[take_step.arg1])
            seg_start = stepno + 1
            end_index = min(start_index + total_children, rm)
            vecs = [L.full(CRUSH_ITEM_UNDEF, rm) for _ in range(emit_stepno - seg_start)]
            return_limit = returned + (end_index - start_index)
            tryno = 0
            running = returned < return_limit
            while tryno < descents and bool(running.any()):
                out, returned, _ = choose(
                    vecs, out, returned, root, tryno, running, start_index,
                    end_index, total_children, seg_start, seg_start, emit_stepno)
                tryno += 1
                running = running & (returned < return_limit)
            start_index = end_index
        stepno = emit_stepno + 1
    if firstn:
        return out[:, :rm], returned
    return out[:, :rm], L.full(rm)


def batched_rule_plain(mapper: "BatchedRuleMapper", xs: torch.Tensor,
                       rew: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (B,) int32 seeds (the uint32 bits) and the
    (D,) int32 reweights, already class-masked, on one device -> ((B,
    result_max) int32 placements with NONE padding and holes, (B,) int32
    counts)."""
    L = _Lanes(device_map(mapper.cc, xs.device), xs, rew)
    if mapper.is_msr:
        return _msr_plain(mapper, L)
    return _classic_plain(mapper, L)


# ---------------------------------------------------------------------------
# The CUDA kernel: argument block, launch, entry points
# ---------------------------------------------------------------------------

_POINTERS = ("xs", "rew", "vals", "counts", "items", "child", "argids", "weights",
             "npos", "size", "btype", "idx_of", "ln")
_INTS = ("batch", "result_max", "nb", "m", "npos_all", "n_idx", "max_devices",
         "nsteps", "choose_total_tries", "choose_local_tries",
         "chooseleaf_descend_once", "chooseleaf_vary_r", "chooseleaf_stable",
         "msr_descents", "msr_collision_tries", "msr_firstn")


class _Args(ctypes.Structure):
    """``struct Args`` of ``crush_rule.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int32) for n in _INTS]
                + [("steps", ctypes.c_int32 * (3 * MAX_STEPS))])


#: kernel mode of each rule kind (``kFirstn``, ``kIndep``, ``kMsr``)
MODES = {"firstn": 0, "indep": 1, "msr": 2}
_fn = None


def _kernel():
    """ctypes handle of ``ceph_crush_rule``, built on first use."""
    global _fn
    if _fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.library("crush_rule").ceph_crush_rule
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        _fn = fn
    return _fn


def launch_geometry(batch: int) -> dict[str, int]:
    """The kernel's launch for ``batch`` seeds, as the library computes
    it: a warp per seed, ``warps_per_block`` warps a block, ``blocks``
    blocks (builds the kernel on first use)."""
    from ceph_tpu_torch.ops import _build

    lib = _build.library("crush_rule")
    wpb, blocks = ctypes.c_int(), ctypes.c_int()
    lib.ceph_crush_rule_geometry(ctypes.c_int(batch), ctypes.byref(wpb), ctypes.byref(blocks))
    return {"warps_per_block": wpb.value, "blocks": blocks.value}


def check_caps(mapper: "BatchedRuleMapper") -> None:
    """Raise if the rule is past the kernel's per-seed caps."""
    if mapper.result_max > MAX_RESULT:
        raise ValueError(f"result_max {mapper.result_max} > the kernel's "
                         f"cap of {MAX_RESULT}")
    if len(mapper.rule.steps) > MAX_STEPS:
        raise ValueError(f"{len(mapper.rule.steps)} rule steps > the kernel's "
                         f"cap of {MAX_STEPS}")
    if mapper.msr_levels > MAX_MSR_LEVELS:
        raise ValueError(f"{mapper.msr_levels} CHOOSE_MSR steps in a segment > "
                         f"the kernel's cap of {MAX_MSR_LEVELS}")


def kernel_args(mapper: "BatchedRuleMapper", xs: torch.Tensor, rew: torch.Tensor,
                vals: torch.Tensor, counts: torch.Tensor) -> _Args:
    """The kernel's argument block: the tensors' addresses, the compiled
    map's on their device, the sizes, tunables and rule steps."""
    check_caps(mapper)
    dm = device_map(mapper.cc, xs.device)
    cc, t = mapper.cc, mapper.cc.tunables
    steps = [v for s in mapper.rule.steps for v in (int(s.op), s.arg1, s.arg2)]
    args = _Args(
        *(p.data_ptr() for p in (xs, rew, vals, counts, dm.items, dm.child,
                                 dm.argids, dm.weights, dm.npos, dm.size,
                                 dm.btype, dm.idx_of_arr, dm.ln)),
        xs.shape[0], mapper.result_max, dm.nb, dm.m, dm.npos_all,
        dm.idx_of_arr.shape[0], cc.max_devices, len(mapper.rule.steps),
        t.choose_total_tries, t.choose_local_tries, t.chooseleaf_descend_once,
        t.chooseleaf_vary_r, t.chooseleaf_stable, t.msr_descents,
        t.msr_collision_tries, int(mapper.rule.rule_type == RULE_TYPE_MSR_FIRSTN),
        (ctypes.c_int32 * (3 * MAX_STEPS))(*steps))
    return args


def _launch(mapper: "BatchedRuleMapper", xs: torch.Tensor, rew: torch.Tensor,
            vals: torch.Tensor, counts: torch.Tensor) -> None:
    """One launch on the current stream; raises if it is refused."""
    for name, t in (("xs", xs), ("rew", rew), ("vals", vals), ("counts", counts)):
        if not t.is_cuda or not t.is_contiguous() or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a contiguous int32 CUDA tensor")
    index = xs.get_device()
    if any(t.get_device() != index for t in (rew, vals, counts)):
        raise ValueError("xs, rew, vals and counts must be on one device")
    args = kernel_args(mapper, xs, rew, vals, counts)
    with torch.cuda.device(index):
        err = _kernel()(MODES[mapper.kind], ctypes.byref(args),
                        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"crush_rule kernel launch failed: cudaError {err} "
                           f"(B={xs.shape[0]}, kind={mapper.kind})")


def _map(mapper: "BatchedRuleMapper", xs: torch.Tensor, rew: torch.Tensor, entry):
    if xs.dim() != 1 or rew.dim() != 1:
        raise ValueError("xs and rew must be 1-D")
    rew = mapper.class_masked(rew)
    if _on_cpu(xs):
        return batched_rule_plain(mapper, xs, rew)
    vals = torch.empty((xs.shape[0], mapper.result_max), dtype=torch.int32,
                       device=xs.device)
    counts = torch.empty((xs.shape[0],), dtype=torch.int32, device=xs.device)
    if xs.shape[0]:
        _launch(mapper, xs, rew, vals, counts)
        count_launch(entry)
    return vals, counts


def crush_rule_firstn(mapper: "BatchedRuleMapper", xs: torch.Tensor,
                      rew: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A classic rule with firstn choose steps only (replicated pools)
    over a batch of seeds: one launch on the card (replaces the jitted
    ``BatchedRuleMapper._build`` of ceph_tpu/crush/jaxmapper.py:997-1015)."""
    return _map(mapper, xs, rew, crush_rule_firstn)


def crush_rule_indep(mapper: "BatchedRuleMapper", xs: torch.Tensor,
                     rew: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A classic rule with an indep choose step (erasure pools; firstn
    steps may join it): one launch on the card."""
    return _map(mapper, xs, rew, crush_rule_indep)


def crush_rule_msr(mapper: "BatchedRuleMapper", xs: torch.Tensor,
                   rew: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An MSR rule (crush_msr_do_rule, msr_firstn or msr_indep): one
    launch on the card."""
    return _map(mapper, xs, rew, crush_rule_msr)


KERNEL_ENTRY_POINTS = (crush_rule_firstn, crush_rule_indep, crush_rule_msr)
_ENTRY = {"firstn": crush_rule_firstn, "indep": crush_rule_indep, "msr": crush_rule_msr}


def reset_launch_counts() -> None:
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNEL_ENTRY_POINTS}


reset_launch_counts()


def rule_kind(rule) -> str:
    """``msr`` for an MSR rule, ``indep`` for a classic rule with an indep
    choose step, else ``firstn``."""
    if rule.rule_type in (RULE_TYPE_MSR_FIRSTN, RULE_TYPE_MSR_INDEP):
        return "msr"
    if any(s.op in (RuleOp.CHOOSE_INDEP, RuleOp.CHOOSELEAF_INDEP) for s in rule.steps):
        return "indep"
    return "firstn"


class BatchedRuleMapper:
    """crush_do_rule over a batch of inputs, for one (map, choose_args,
    rule, result_max) on one device (the card unless ``device`` says
    otherwise)."""

    def __init__(self, cc: CompiledCrush, ruleno: int, result_max: int, device=None):
        if ruleno not in cc.rules:
            raise KeyError(f"no rule {ruleno}")
        self.cc = cc
        self.rule = cc.rules[ruleno]
        self.result_max = result_max
        self._validate()
        self.device = resolve_device(device)
        self.kind = rule_kind(self.rule)
        self.is_msr = self.kind == "msr"
        self.msr_levels = _msr_levels(self.rule) if self.is_msr else 0
        self._class_masks: dict[torch.device, torch.Tensor | None] = {}
        #: seconds of the last __call__'s launch on the card (CUDA events)
        self.last_kernel_s: float | None = None

    def _validate(self):
        t = self.cc.tunables
        if t.choose_local_fallback_tries:
            raise UnsupportedMap("choose_local_fallback_tries > 0")
        if self.rule.rule_type in (RULE_TYPE_MSR_FIRSTN, RULE_TYPE_MSR_INDEP):
            # only MSR step kinds may appear (crush_msr_do_rule rejects others)
            for s in self.rule.steps:
                if s.op not in (
                    RuleOp.NOOP, RuleOp.TAKE, RuleOp.EMIT,
                    RuleOp.CHOOSE_MSR, RuleOp.SET_MSR_DESCENTS,
                    RuleOp.SET_MSR_COLLISION_TRIES,
                ):
                    raise UnsupportedMap(f"MSR rule op {s.op!r}")
            return
        for s in self.rule.steps:
            if s.op == RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES and s.arg1 > 0:
                raise UnsupportedMap("rule sets local_fallback_tries")
            if s.op in (RuleOp.CHOOSE_MSR, RuleOp.SET_MSR_DESCENTS,
                        RuleOp.SET_MSR_COLLISION_TRIES):
                raise UnsupportedMap("MSR step in a non-MSR rule")
            if s.op not in (
                RuleOp.NOOP, RuleOp.TAKE, RuleOp.EMIT,
                RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP,
                RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP,
                RuleOp.SET_CHOOSE_TRIES, RuleOp.SET_CHOOSELEAF_TRIES,
                RuleOp.SET_CHOOSE_LOCAL_TRIES,
                RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                RuleOp.SET_CHOOSELEAF_VARY_R, RuleOp.SET_CHOOSELEAF_STABLE,
            ):
                raise UnsupportedMap(f"rule op {s.op!r}")

    def class_masked(self, rew: torch.Tensor) -> torch.Tensor:
        """The reweights with the devices outside the rule's device class
        zeroed, so is_out rejects them."""
        if self.rule.device_class is None:
            return rew
        dev = _device_key(rew.device)
        mask = self._class_masks.get(dev)
        if mask is None:
            cc = self.cc
            m = np.zeros(max(cc.max_devices, 1), bool)
            for osd, cls in cc.device_classes.items():
                if cls == self.rule.device_class and osd < cc.max_devices:
                    m[osd] = True
            mask = self._class_masks[dev] = torch.from_numpy(m).to(dev)
        return torch.where(mask, rew, 0)

    def reweights(self, reweights=None) -> np.ndarray:
        """The int32 reweight vector of length max(max_devices, 1)."""
        cc = self.cc
        if reweights is None:
            return np.full(max(cc.max_devices, 1), 0x10000, np.int32)
        rew = np.zeros(max(cc.max_devices, 1), np.int32)
        rw = np.asarray(reweights, np.int64)
        rew[: len(rw)] = rw[: len(rew)]
        return rew

    def map_tensors(self, xs: torch.Tensor, rew: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B,) int32 seeds and (D,) int32 reweights on one device -> (vals,
        counts) there: the kernel on a CUDA tensor, the plain version on
        a CPU tensor."""
        return _ENTRY[self.kind](self, xs, rew)

    def __call__(self, xs, reweights=None):
        """Map a batch of placement seeds.

        Returns (vals [B, result_max] int32 with CRUSH_ITEM_NONE
        padding/holes, counts [B] int32) as numpy arrays: per lane the
        rule result is vals[i, :counts[i]], exactly crush_do_rule's
        output.  The seeds and reweights go up once each, and the
        placements come back in one copy."""
        xs = torch.from_numpy(np.asarray(xs, np.uint32).astype(np.int32)).to(self.device)
        rew = torch.from_numpy(self.reweights(reweights)).to(self.device)
        if self.device.type != "cuda":
            vals, cnt = self.map_tensors(xs, rew)
            return vals.numpy(), cnt.numpy()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vals, cnt = self.map_tensors(xs, rew)
        end.record()
        vals, cnt = vals.cpu().numpy(), cnt.cpu().numpy()
        self.last_kernel_s = start.elapsed_time(end) * 1e-3
        return vals, cnt


def _msr_levels(rule) -> int:
    """The most CHOOSE_MSR steps between a TAKE and its EMIT."""
    most = run = 0
    for s in rule.steps:
        run = run + 1 if s.op == RuleOp.CHOOSE_MSR else 0
        most = max(most, run)
    return most
