"""Scalar CRUSH placement interpreter — the behavioral oracle twin.

Bit-identical re-implementation of the reference placement function
(src/crush/mapper.c): straw2 exponential-minimum draws over the fixed
point crush_ln (mapper.c:229-271,342-365), the firstn rejection-retry
descent (mapper.c:441-629), the positionally-stable indep variant
(mapper.c:636-824) and the rule-step interpreter
(crush_do_rule_no_retry, mapper.c:826-1032), including the uniform
bucket's cached permutation (bucket_perm_choose, mapper.c:54-119) and
the legacy list/tree/straw bucket algorithms.

This scalar version is the oracle for the batched engine
(ceph_tpu_torch/crush/cudamapper.py) and serves small/one-off lookups on the
host control plane; golden vectors generated from the reference's own C
pin it down (tests/test_crush_golden.py).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.crush._ln_tables import LL_TBL, RH_LH_TBL
from ceph_tpu_torch.crush.types import (
    RULE_TYPE_MSR_FIRSTN,
    RULE_TYPE_MSR_INDEP,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    Bucket,
    BucketAlg,
    ChooseArg,
    CrushMap,
    Rule,
    RuleOp,
)
from ceph_tpu_torch.ops.hashing import (
    crush_hash32_2,
    crush_hash32_3,
    crush_hash32_4,
)

S64_MIN = -(2 ** 63)


def crush_ln(xin: int) -> int:
    """2^44 * log2(xin + 1), fixed point (mapper.c:229-271)."""
    x = (xin + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        # __builtin_clz(x & 0x1FFFF) - 16  ==  16 - bit_length
        bits = 16 - int(x & 0x1FFFF).bit_length()
        x = (x << bits) & 0xFFFFFFFF
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    RH = int(RH_LH_TBL[index1 - 256])
    LH = int(RH_LH_TBL[index1 + 1 - 256])
    xl64 = (x * RH) >> 48
    result = iexpon << 44
    index2 = xl64 & 0xFF
    LL = int(LL_TBL[index2])
    LH = LH + LL
    LH >>= (48 - 12 - 32)
    return result + LH


def _div64(a: int, b: int) -> int:
    """C-style truncating signed 64-bit division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def straw2_draw(hash_alg: int, x: int, item_id: int, r: int, weight: int) -> int:
    """generate_exponential_distribution (mapper.c:315-340)."""
    u = int(crush_hash32_3(x, item_id, r)) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    return _div64(ln, weight)


class _Work:
    """Per-lookup scratch: the uniform-bucket permutation cache
    (struct crush_work_bucket, mapper.c:54-112)."""

    def __init__(self) -> None:
        self.perm_x: dict[int, int] = {}
        self.perm_n: dict[int, int] = {}
        self.perm: dict[int, list[int]] = {}


def _choose_arg_weights(bucket: Bucket, arg: ChooseArg | None, position: int) -> list[int]:
    if arg is None or arg.weight_set is None:
        return bucket.item_weights
    if position >= len(arg.weight_set):
        position = len(arg.weight_set) - 1
    return arg.weight_set[position]


def _choose_arg_ids(bucket: Bucket, arg: ChooseArg | None) -> list[int]:
    if arg is None or arg.ids is None:
        return bucket.items
    return arg.ids


_STRAW2_NATIVE = None
_STRAW2_PROBED = False


def _straw2_native():
    """The native straw2 choose (ceph_tpu_torch/native/crush_hash.cc) or
    None; probed once.  Moves the per-item hash+ln+div+argmax loop to
    one C call per bucket level — the Python loop costs ~25us/item,
    which stalls daemon event loops on per-PG mapping (bench cfg 5)."""
    global _STRAW2_NATIVE, _STRAW2_PROBED
    if not _STRAW2_PROBED:
        _STRAW2_PROBED = True
        try:
            from ceph_tpu_torch import native

            _STRAW2_NATIVE = native.straw2_lib()
        except Exception:
            _STRAW2_NATIVE = None
    return _STRAW2_NATIVE


#: straw2 draws made here, one per item of every straw2 bucket choose: the
#: work a batch of seeds needs, counted beside the batched kernel's time
straw2_draws = 0


def bucket_straw2_choose(
    bucket: Bucket, x: int, r: int, arg: ChooseArg | None, position: int
) -> int:
    global straw2_draws
    weights = _choose_arg_weights(bucket, arg, position)
    ids = _choose_arg_ids(bucket, arg)
    n = bucket.size
    straw2_draws += n
    lib = _straw2_native()
    if lib is not None and n:
        ids_a = np.asarray(ids[:n], dtype=np.int32)
        w_a = np.asarray(weights[:n], dtype=np.uint32)
        i = lib.ceph_tpu_torch_straw2_choose(
            x & 0xFFFFFFFF, r & 0xFFFFFFFF,
            ids_a.ctypes.data, w_a.ctypes.data, n)
        return bucket.items[i]
    high = 0
    high_draw = 0
    for i in range(n):
        if weights[i]:
            draw = straw2_draw(bucket.hash, x, ids[i], r, weights[i])
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_perm_choose(bucket: Bucket, work: _Work, x: int, r: int) -> int:
    """Pseudo-random permutation choose for uniform buckets
    (mapper.c:54-112), including the cached-permutation and the magic
    0xffff first-slot fast path."""
    bid = bucket.id
    pr = r % bucket.size
    if work.perm_x.get(bid) != x or work.perm_n.get(bid, 0) == 0:
        work.perm_x[bid] = x
        if pr == 0:
            s = int(crush_hash32_3(x, bid, 0)) % bucket.size
            work.perm[bid] = [s] + [0] * (bucket.size - 1)
            work.perm_n[bid] = 0xFFFF
            return bucket.items[s]
        work.perm[bid] = list(range(bucket.size))
        work.perm_n[bid] = 0
    elif work.perm_n[bid] == 0xFFFF:
        p = work.perm[bid]
        for i in range(1, bucket.size):
            p[i] = i
        p[p[0]] = 0
        work.perm_n[bid] = 1
    perm = work.perm[bid]
    while work.perm_n[bid] <= pr:
        p = work.perm_n[bid]
        if p < bucket.size - 1:
            i = int(crush_hash32_3(x, bid, p)) % (bucket.size - p)
            if i:
                perm[p + i], perm[p] = perm[p], perm[p + i]
        work.perm_n[bid] += 1
    return bucket.items[perm[pr]]


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    for i in range(bucket.size - 1, -1, -1):
        w = int(crush_hash32_4(x, bucket.items[i], r, bucket.id)) & 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    n = len(bucket.node_weights) >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (int(crush_hash32_4(x, n, r, bucket.id)) * w) >> 32
        h = 0
        nn = n
        while (nn & 1) == 0:
            h += 1
            nn >>= 1
        left = n - (1 << (h - 1))
        n = left if t < bucket.node_weights[left] else n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    high = 0
    high_draw = -1
    for i in range(bucket.size):
        draw = (int(crush_hash32_3(x, bucket.items[i], r)) & 0xFFFF) * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def crush_bucket_choose(
    bucket: Bucket, work: _Work, x: int, r: int, arg: ChooseArg | None, position: int
) -> int:
    if bucket.size == 0:
        raise ValueError("empty bucket")
    if bucket.alg == BucketAlg.STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    if bucket.alg == BucketAlg.UNIFORM:
        return bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == BucketAlg.LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == BucketAlg.TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == BucketAlg.STRAW:
        return bucket_straw_choose(bucket, x, r)
    return bucket.items[0]


def is_out(map_: CrushMap, weights: list[int], item: int, x: int) -> bool:
    """Device overload rejection (mapper.c:405-419); ``weights`` is the
    OSD reweight vector (16.16), distinct from CRUSH weights."""
    if item >= len(weights):
        return True
    w = weights[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (int(crush_hash32_2(x, item)) & 0xFFFF) >= w


def _choose_firstn(
    map_: CrushMap, work: _Work, bucket: Bucket, weights: list[int],
    x: int, numrep: int, type_: int, out: list[int], outpos: int,
    out_size: int, tries: int, recurse_tries: int, local_retries: int,
    local_fallback_retries: int, recurse_to_leaf: bool, vary_r: int,
    stable: int, out2: list[int] | None, parent_r: int,
    choose_args: dict[int, ChooseArg] | None,
) -> int:
    """crush_choose_firstn (mapper.c:441-629)."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_ = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                r = rep + parent_r + ftotal
                if in_.size == 0:
                    reject = True
                    collide = False
                    item = 0
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_.size >> 1)
                            and flocal > local_fallback_retries):
                        item = bucket_perm_choose(in_, work, x, r)
                    else:
                        arg = (choose_args or {}).get(in_.id)
                        item = crush_bucket_choose(in_, work, x, r, arg, outpos)
                    if item >= map_.max_devices:
                        skip_rep = True
                        break
                    known = item >= 0 or item in map_.buckets
                    itemtype = map_.buckets[item].type if (item < 0 and known) else 0
                    if not known or itemtype != type_:
                        if item >= 0 or not known:
                            skip_rep = True
                            break
                        in_ = map_.buckets[item]
                        retry_bucket = True
                        continue
                    collide = any(out[i] == item for i in range(outpos))
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if _choose_firstn(
                                map_, work, map_.buckets[item], weights, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0,
                                local_retries, local_fallback_retries,
                                False, vary_r, stable, None, sub_r,
                                choose_args,
                            ) <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(map_, weights, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def _choose_indep(
    map_: CrushMap, work: _Work, bucket: Bucket, weights: list[int],
    x: int, left: int, numrep: int, type_: int, out: list[int],
    outpos: int, tries: int, recurse_tries: int, recurse_to_leaf: bool,
    out2: list[int] | None, parent_r: int,
    choose_args: dict[int, ChooseArg] | None,
) -> None:
    """crush_choose_indep (mapper.c:636-824): breadth-first positionally
    stable selection used by erasure-coded pools."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_ = bucket
            while True:
                r = rep + parent_r
                if (in_.alg == BucketAlg.UNIFORM
                        and in_.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_.size == 0:
                    break
                arg = (choose_args or {}).get(in_.id)
                item = crush_bucket_choose(in_, work, x, r, arg, outpos)
                if item >= map_.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                known = item >= 0 or item in map_.buckets
                itemtype = map_.buckets[item].type if (item < 0 and known) else 0
                if not known or itemtype != type_:
                    if item >= 0 or not known:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_ = map_.buckets[item]
                    continue
                if any(out[i] == item for i in range(outpos, endpos)):
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(
                            map_, work, map_.buckets[item], weights, x,
                            1, numrep, 0, out2, rep, recurse_tries, 0,
                            False, None, r, choose_args,
                        )
                        if out2 is not None and out2[rep] == CRUSH_ITEM_NONE:
                            break
                    elif out2 is not None:
                        out2[rep] = item
                if itemtype == 0 and is_out(map_, weights, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


# ---------------------------------------------------------------------------
# MSR (multi-step-retry) rules — crush_msr_do_rule (mapper.c:1723-1930)
# ---------------------------------------------------------------------------
#
# msr_firstn / msr_indep rules retry the WHOLE descent when a leaf is
# rejected, so marking an OSD out can remap to a different failure
# domain even when the rule places several OSDs per domain (wide EC on
# small clusters — mapper.c:1633-1720 commentary).  Statement-level
# transliteration like the classic interpreter above: bit-identical
# placements are pinned by golden vectors compiled from the reference C
# (tools/golden/crush_oracle.c).

def _msr_scan_config_steps(rule: Rule) -> tuple[int, int | None, int | None]:
    """mapper.c:1088 — returns (next stepno, descents, collision_tries)."""
    descents = tries = None
    for stepno, step in enumerate(rule.steps):
        if step.op == RuleOp.SET_MSR_DESCENTS:
            descents = step.arg1
        elif step.op == RuleOp.SET_MSR_COLLISION_TRIES:
            tries = step.arg1
        else:
            return stepno, descents, tries
    return len(rule.steps), descents, tries


def _msr_scan_next(
    rule: Rule, result_max: int, stepno: int
) -> tuple[int, int] | None:
    """mapper.c:1139 — (total_children, emit stepno) or None (invalid)."""
    if stepno + 1 >= len(rule.steps):
        return None
    if rule.steps[stepno].op != RuleOp.TAKE:
        return None
    stepno += 1
    total_children = 1
    while stepno < len(rule.steps):
        step = rule.steps[stepno]
        if step.op == RuleOp.EMIT:
            break
        if step.op != RuleOp.CHOOSE_MSR:
            return None
        total_children *= step.arg1 if step.arg1 else result_max
        stepno += 1
    if stepno >= len(rule.steps):
        return None
    return total_children, stepno


def _msr_retry_value(
    result_max: int, index: int, tryno: int, local_tryno: int
) -> int:
    """mapper.c:1249 crush_msr_get_retry_value."""
    return (((tryno * result_max) + index) << 16) + local_tryno


def _msr_descend(
    map_: CrushMap, work: _Work, bucket: Bucket, type_: int,
    x: int, result_max: int, tryno: int, local_tryno: int, index: int,
    choose_args: dict[int, ChooseArg] | None,
) -> int | None:
    """mapper.c:1274 — descend until a device or a bucket of type_.

    Returns None on a map-integrity failure (empty bucket, dangling
    child id, out-of-range device) — the classic interpreter's bad-item
    guards (mapper.c reject paths); the caller treats it as a collision
    and retries."""
    while True:
        if bucket.size == 0:
            return None
        arg = (choose_args or {}).get(bucket.id)
        candidate = crush_bucket_choose(
            bucket, work, x,
            _msr_retry_value(result_max, index, tryno, local_tryno),
            arg, index,
        )
        if candidate >= 0:
            if candidate >= map_.max_devices:
                return None  # dangling device id
            return candidate
        nxt = map_.buckets.get(candidate)
        if nxt is None:
            return None  # dangling child bucket id
        bucket = nxt
        if bucket.type == type_:
            return bucket.id


def _msr_valid_candidate(
    vec: list[int],
    exclude_start: int, exclude_end: int,
    include_start: int, include_end: int,
    candidate: int,
) -> bool:
    """mapper.c:1331 — already-in-stride ok; used by another stride no."""
    for i in range(exclude_start, exclude_end):
        if vec[i] == candidate:
            return include_start <= i < include_end
    return True


def _msr_push_used(
    vec: list[int], stride_start: int, stride_end: int, candidate: int
) -> bool:
    """mapper.c:1388."""
    for i in range(stride_start, stride_end):
        if vec[i] == candidate:
            return False
        if vec[i] == CRUSH_ITEM_UNDEF:
            vec[i] = candidate
            return True
    raise AssertionError("impossible")


def _msr_pop_used(
    vec: list[int], stride_start: int, stride_end: int, candidate: int
) -> None:
    """mapper.c:1425."""
    for i in range(stride_end - 1, stride_start - 1, -1):
        if vec[i] != CRUSH_ITEM_UNDEF:
            assert vec[i] == candidate
            vec[i] = CRUSH_ITEM_UNDEF
            return
    raise AssertionError("impossible")


class _MsrOutput:
    """mapper.c:1067 crush_msr_output."""

    def __init__(self, result_max: int):
        self.out = [CRUSH_ITEM_NONE] * result_max
        self.returned_so_far = 0

    def emit(self, rule_type: int, position: int, result: int) -> None:
        if rule_type == RULE_TYPE_MSR_FIRSTN:
            self.out[self.returned_so_far] = result
            self.returned_so_far += 1
        else:
            self.out[position] = result
            self.returned_so_far += 1


def _msr_choose(
    map_: CrushMap, rule: Rule, work: _Work, step_vecs: list[list[int]],
    output: _MsrOutput, bucket: Bucket, total_descendants: int,
    start_index: int, end_index: int,
    current_stepno: int, start_stepno: int, end_stepno: int,
    tryno: int, x: int, result_max: int, weights: list[int],
    collision_tries: int, choose_args: dict[int, ChooseArg] | None,
) -> int:
    """mapper.c:1507 crush_msr_choose — one descent pass for one
    CHOOSE_MSR step over its strides."""
    curstep = rule.steps[current_stepno]
    assert curstep.op == RuleOp.CHOOSE_MSR
    num_strides = curstep.arg1 if curstep.arg1 else result_max
    assert total_descendants % num_strides == 0
    stride_length = total_descendants // num_strides
    vec = step_vecs[current_stepno - start_stepno]
    leaf_vec = step_vecs[end_stepno - start_stepno - 1]

    undo = [CRUSH_ITEM_UNDEF] * num_strides
    mapped = 0
    stride_index = 0
    stride_start = start_index
    while stride_start < end_index:
        stride_end = min(stride_start + stride_length, end_index)
        if all(
            leaf_vec[i] != CRUSH_ITEM_UNDEF
            for i in range(stride_start, stride_end)
        ):
            stride_start += stride_length
            stride_index += 1
            continue
        found = False
        candidate = 0
        for local_tryno in range(collision_tries):
            candidate = _msr_descend(
                map_, work, bucket, curstep.arg2, x, result_max,
                tryno, local_tryno, stride_index, choose_args,
            )
            if candidate is None:
                continue  # map-integrity reject: retry like a collision
            if _msr_valid_candidate(
                vec, start_index, end_index,
                stride_start, stride_end, candidate,
            ):
                found = True
                break
        if not found:
            stride_start += stride_length
            stride_index += 1
            continue
        if curstep.arg2 == 0:  # leaf step
            if stride_length != 1 or current_stepno + 1 != end_stepno:
                pass  # malformed rule: skip stride
            elif is_out(map_, weights, candidate, x):
                pass  # crush_msr_do_rule retries, msr_descents permitting
            else:
                pushed = _msr_push_used(
                    vec, stride_start, stride_end, candidate)
                assert pushed
                output.emit(rule.rule_type, stride_start, candidate)
                mapped += 1
        else:  # interior step
            if current_stepno + 1 >= end_stepno or candidate >= 0:
                pass  # malformed rule / device where an interior type
                      # was requested: skip the stride
            else:
                child_bucket = map_.buckets[candidate]
                child_mapped = _msr_choose(
                    map_, rule, work, step_vecs, output, child_bucket,
                    stride_length, stride_start, stride_end,
                    current_stepno + 1, start_stepno, end_stepno,
                    tryno, x, result_max, weights, collision_tries,
                    choose_args,
                )
                pushed = _msr_push_used(
                    vec, stride_start, stride_end, candidate)
                if pushed and child_mapped == 0:
                    undo[stride_index] = candidate
                else:
                    mapped += child_mapped
        stride_start += stride_length
        stride_index += 1

    stride_index = 0
    stride_start = start_index
    while stride_start < end_index:
        if undo[stride_index] != CRUSH_ITEM_UNDEF:
            stride_end = min(stride_start + stride_length, end_index)
            _msr_pop_used(
                vec, stride_start, stride_end, undo[stride_index])
        stride_start += stride_length
        stride_index += 1
    return mapped


def _msr_do_rule(
    map_: CrushMap, rule: Rule, x: int, result_max: int,
    weights: list[int], choose_args: dict[int, ChooseArg] | None,
) -> list[int]:
    """mapper.c:1809 crush_msr_do_rule."""
    t = map_.tunables
    start_stepno, descents, collision_tries = _msr_scan_config_steps(rule)
    if descents is None:
        descents = t.msr_descents
    if collision_tries is None:
        collision_tries = t.msr_collision_tries

    work = _Work()
    output = _MsrOutput(result_max)
    start_index = 0
    while start_stepno < len(rule.steps):
        scan = _msr_scan_next(rule, result_max, start_stepno)
        if scan is None:
            return []  # invalid rule: "return whatever we have" (= none)
        total_children, emit_stepno = scan
        take_step = rule.steps[start_stepno]
        assert take_step.op == RuleOp.TAKE
        if take_step.arg1 >= 0:
            if start_stepno + 1 != emit_stepno:
                return []
            output.emit(rule.rule_type, start_index, take_step.arg1)
        else:
            root_bucket = map_.buckets[take_step.arg1]
            start_stepno += 1
            n_steps = emit_stepno - start_stepno
            step_vecs = [
                [CRUSH_ITEM_UNDEF] * result_max for _ in range(n_steps)
            ]
            end_index = min(start_index + total_children, result_max)
            return_limit = output.returned_so_far + (end_index - start_index)
            tries_so_far = 0
            while (tries_so_far < descents
                   and output.returned_so_far < return_limit):
                _msr_choose(
                    map_, rule, work, step_vecs, output, root_bucket,
                    total_children, start_index, end_index,
                    start_stepno, start_stepno, emit_stepno,
                    tries_so_far, x, result_max, weights,
                    collision_tries, choose_args,
                )
                tries_so_far += 1
            start_index = end_index
        start_stepno = emit_stepno + 1

    if rule.rule_type == RULE_TYPE_MSR_FIRSTN:
        return output.out[: output.returned_so_far]
    return output.out


def crush_do_rule(
    map_: CrushMap,
    ruleno: int,
    x: int,
    result_max: int,
    weights: list[int] | None = None,
    choose_args: dict[int, ChooseArg] | None = None,
) -> list[int]:
    """crush_do_rule_no_retry (mapper.c:826-1032).

    ``weights`` is the OSD reweight vector (16.16; defaults to all-in).
    Returns the raw result vector (may contain CRUSH_ITEM_NONE holes for
    indep rules).
    """
    if ruleno not in map_.rules:
        return []
    rule = map_.rules[ruleno]
    if weights is None:
        weights = [0x10000] * map_.max_devices
    if rule.device_class is not None:
        # class-restricted rule: OSDs of other classes get weight 0,
        # which is_out() rejects — selecting exactly the same OSD set
        # the reference reaches via per-class shadow hierarchies
        # (CrushWrapper::populate_classes); draw order may differ from
        # the shadow-tree draw, which is fine for a from-scratch map.
        weights = [
            w if map_.device_classes.get(osd) == rule.device_class else 0
            for osd, w in enumerate(weights)
        ]
    if rule.rule_type in (RULE_TYPE_MSR_FIRSTN, RULE_TYPE_MSR_INDEP):
        return _msr_do_rule(
            map_, rule, x, result_max, weights, choose_args)

    t = map_.tunables
    work = _Work()

    choose_tries = t.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    result: list[int] = []
    w: list[int] = []
    for step in rule.steps:
        op = step.op
        if op == RuleOp.TAKE:
            if (0 <= step.arg1 < map_.max_devices) or step.arg1 in map_.buckets:
                w = [step.arg1]
        elif op == RuleOp.SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == RuleOp.SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif op == RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN,
                    RuleOp.CHOOSE_INDEP, RuleOp.CHOOSELEAF_INDEP):
            if not w:
                continue
            firstn = op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN)
            recurse_to_leaf = op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP)
            # the reference hands each input bucket an *offset* output
            # window (o+osize with j=0, mapper.c:970,992): r-values,
            # collision scans and choose_args positions are all relative
            # to the window, so model it with per-bucket slices
            o: list[int] = []
            c: list[int] = []
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or wi not in map_.buckets:
                    continue
                bucket = map_.buckets[wi]
                avail = result_max - len(o)
                o_i = [0] * avail
                c_i = [0] * avail
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    n_i = _choose_firstn(
                        map_, work, bucket, weights, x, numrep, step.arg2,
                        o_i, 0, avail, choose_tries,
                        recurse_tries, choose_local_retries,
                        choose_local_fallback_retries, recurse_to_leaf,
                        vary_r, stable, c_i, 0, choose_args,
                    )
                else:
                    n_i = min(numrep, avail)
                    _choose_indep(
                        map_, work, bucket, weights, x, n_i, numrep,
                        step.arg2, o_i, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, c_i, 0, choose_args,
                    )
                o.extend(o_i[:n_i])
                c.extend(c_i[:n_i])
            w = c if recurse_to_leaf else o
        elif op == RuleOp.EMIT:
            result.extend(w[: result_max - len(result)])
            w = []
    return result
