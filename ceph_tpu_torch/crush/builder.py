"""CRUSH map construction — the CrushWrapper/builder analogue.

Covers the mutation surface the control plane needs (reference:
src/crush/builder.c, src/crush/CrushWrapper.cc): bucket creation
(straw2/uniform/list; tree with its heap-array weights), hierarchy
assembly, device reweighting, and the two standard rule shapes —
replicated chooseleaf-firstn (CrushWrapper::add_simple_rule) and the
erasure indep rule created for EC profiles
(ErasureCode::create_rule -> add_simple_rule(..., "indep", ...),
reference src/erasure-code/ErasureCode.cc:70-102).
"""

from __future__ import annotations

from ceph_tpu_torch.crush.types import (
    RULE_TYPE_MSR_INDEP,
    Bucket,
    BucketAlg,
    CrushMap,
    Rule,
    RuleOp,
    RuleStep,
)


def make_bucket(
    map_: CrushMap,
    alg: BucketAlg,
    type_: int,
    items: list[int],
    weights: list[int],
    bucket_id: int | None = None,
) -> Bucket:
    """Create and add a bucket; derives the per-alg auxiliary arrays
    (list prefix sums, tree heap weights)."""
    if bucket_id is None:
        bucket_id = min(map_.buckets.keys(), default=0) - 1
    assert bucket_id < 0 and bucket_id not in map_.buckets
    b = Bucket(id=bucket_id, type=type_, alg=alg,
               items=list(items), item_weights=list(weights))
    if alg == BucketAlg.LIST:
        total = 0
        b.sum_weights = []
        for w in weights:
            total += w
            b.sum_weights.append(total)
    elif alg == BucketAlg.TREE:
        b.node_weights = _tree_node_weights(items, weights)
    elif alg == BucketAlg.UNIFORM:
        # uniform buckets carry one weight for all items
        if weights:
            b.item_weights = [weights[0]] * len(items)
    map_.buckets[bucket_id] = b
    for it in items:
        if it >= 0:
            map_.max_devices = max(map_.max_devices, it + 1)
    return b


def _tree_node_weights(items: list[int], weights: list[int]) -> list[int]:
    """Binary-heap node weights for tree buckets (builder.c
    crush_make_tree_bucket layout: leaves at odd indices)."""
    n = len(items)
    depth = max(1, (n - 1).bit_length() + 1) if n > 1 else 1
    num_nodes = 1 << depth
    node_weights = [0] * num_nodes
    for j, w in enumerate(weights):
        node_weights[(j << 1) + 1] = w

    # interior sums level by level (a node with h trailing zero bits has
    # height h; children sit +/- 2^(h-1))
    for h in range(1, depth + 1):
        for node in range(1 << h, num_nodes, 1 << (h + 1)):
            left = node - (1 << (h - 1))
            right = node + (1 << (h - 1))
            node_weights[node] = node_weights[left] + (
                node_weights[right] if right < num_nodes else 0
            )
    return node_weights


def build_hierarchy(
    map_: CrushMap,
    osds_per_host: int,
    n_hosts: int,
    osd_weight: int = 0x10000,
    alg: BucketAlg = BucketAlg.STRAW2,
    host_type: int = 1,
    root_type: int = 10,
) -> Bucket:
    """Standard root -> host -> osd tree; returns the root bucket."""
    host_ids = []
    host_weights = []
    for h in range(n_hosts):
        osds = list(range(h * osds_per_host, (h + 1) * osds_per_host))
        hb = make_bucket(map_, alg, host_type, osds, [osd_weight] * osds_per_host)
        map_.bucket_names.setdefault(f"host{h}", hb.id)
        host_ids.append(hb.id)
        host_weights.append(hb.weight)
    root = make_bucket(map_, alg, root_type, host_ids, host_weights)
    map_.bucket_names.setdefault("default", root.id)
    return root


def build_rack_hierarchy(
    map_: CrushMap,
    osds_per_host: int,
    hosts_per_rack: int,
    n_racks: int,
    osd_weight: int = 0x10000,
    alg: BucketAlg = BucketAlg.STRAW2,
    host_type: int = 1,
    rack_type: int = 3,
    root_type: int = 10,
) -> Bucket:
    """root -> rack -> host -> osd tree (the rack-scale failure-domain
    shape); registers ``rack{r}``/``host{h}``/``default`` bucket names.
    OSD ids are dense: host h holds osds [h*per_host, (h+1)*per_host)."""
    rack_ids = []
    rack_weights = []
    for r in range(n_racks):
        host_ids = []
        host_weights = []
        for hh in range(hosts_per_rack):
            h = r * hosts_per_rack + hh
            osds = list(range(h * osds_per_host, (h + 1) * osds_per_host))
            hb = make_bucket(
                map_, alg, host_type, osds, [osd_weight] * osds_per_host)
            map_.bucket_names.setdefault(f"host{h}", hb.id)
            host_ids.append(hb.id)
            host_weights.append(hb.weight)
        rb = make_bucket(map_, alg, rack_type, host_ids, host_weights)
        map_.bucket_names.setdefault(f"rack{r}", rb.id)
        rack_ids.append(rb.id)
        rack_weights.append(rb.weight)
    root = make_bucket(map_, alg, root_type, rack_ids, rack_weights)
    map_.bucket_names.setdefault("default", root.id)
    return root


def add_simple_rule(
    map_: CrushMap,
    root_id: int,
    failure_domain_type: int,
    rule_type: int = 1,
    mode: str = "firstn",
    rule_id: int | None = None,
    num: int = 0,
) -> int:
    """CrushWrapper::add_simple_rule: take root; chooseleaf <mode> <num>
    <failure-domain>; emit.  ``num=0`` selects pool-size items;
    ``mode='indep'`` with rule_type=3 is the shape EC profiles create
    (ErasureCode.cc:76-100)."""
    if rule_id is None:
        rule_id = max(map_.rules.keys(), default=-1) + 1
    steps = []
    if mode == "indep":
        steps.append(RuleStep(RuleOp.SET_CHOOSELEAF_TRIES, 5, 0))
    steps.append(RuleStep(RuleOp.TAKE, root_id, 0))
    op = RuleOp.CHOOSELEAF_FIRSTN if mode == "firstn" else RuleOp.CHOOSELEAF_INDEP
    if failure_domain_type == 0:
        op = RuleOp.CHOOSE_FIRSTN if mode == "firstn" else RuleOp.CHOOSE_INDEP
    steps.append(RuleStep(op, num, failure_domain_type))
    steps.append(RuleStep(RuleOp.EMIT, 0, 0))
    map_.rules[rule_id] = Rule(rule_type=rule_type, steps=steps)
    return rule_id


def set_device_class(map_: CrushMap, osd: int, device_class: str) -> None:
    """Tag an OSD with a device class (CrushWrapper class_map analogue);
    class-restricted rules select only matching OSDs."""
    map_.device_classes[osd] = device_class


def create_ec_rule(
    map_: CrushMap,
    name: str,
    root_name: str = "default",
    failure_domain: str = "host",
    num_failure_domains: int = 0,
    osds_per_failure_domain: int = 0,
    device_class: str | None = None,
    mode: str = "indep",
) -> int:
    """Name-resolving EC rule creation — the seam
    ErasureCode::create_rule drives (reference ErasureCode.cc:70-102 →
    CrushWrapper::add_simple_rule / add_indep_multi_osd_per_failure_
    domain_rule).  Returns the new rule id; registers ``name``.

    A one-OSD-per-domain indep rule also carries Ceph's
    ``set_choose_tries 100`` (CrushWrapper::add_simple_rule_at), which
    ``ceph_tpu``'s omits: here a PG keeps no hole where a retry past the
    map's 50 fills it.

    ``device_class`` restricts choice to OSDs of that class.  The
    reference materializes per-class shadow hierarchies
    (CrushWrapper::populate_classes); here class filtering is applied by
    the mapper via per-device class membership (same resulting OSD set).
    """
    if name in map_.rule_names:
        raise ValueError(f"rule {name!r} already exists")
    if root_name not in map_.bucket_names:
        raise LookupError(f"root item {root_name!r} does not exist")
    root_id = map_.bucket_names[root_name]
    try:
        fd_type = map_.type_id(failure_domain)
    except KeyError:
        raise LookupError(f"unknown type {failure_domain!r}") from None
    if osds_per_failure_domain <= 1:
        rid = add_simple_rule(
            map_, root_id, fd_type,
            rule_type=3, mode=mode, num=num_failure_domains,
        )
        if mode == "indep":
            # Ceph's erasure rule also raises the descent's retry budget
            # (CrushWrapper::add_simple_rule_at: set_choose_tries 100):
            # with the map's 50, a PG as wide as the hosts left after one
            # goes out keeps a hole one time in 60
            map_.rules[rid].steps.insert(1, RuleStep(RuleOp.SET_CHOOSE_TRIES, 100, 0))
    else:
        rid = add_osd_multi_per_domain_rule(
            map_, root_id, fd_type,
            num_per_domain=osds_per_failure_domain,
            num_domains=num_failure_domains,
        )
    if device_class:
        map_.rules[rid].device_class = device_class
    map_.rule_names[name] = rid
    return rid


def add_two_level_indep_rule(
    map_: CrushMap,
    root_id: int,
    failure_domain_type: int,
    num_per_domain: int,
    rule_type: int = 3,
    rule_id: int | None = None,
    num_domains: int = 0,
) -> int:
    """Classic (pre-MSR) two-level indep rule: choose indep
    <num_domains> domains then chooseleaf indep <num_per_domain> osds —
    kept for LRC layer rules and the reference-pinned golden vectors;
    EC profiles with crush-osds-per-failure-domain now get the MSR rule
    (add_osd_multi_per_domain_rule), as the reference does."""
    if rule_id is None:
        rule_id = max(map_.rules.keys(), default=-1) + 1
    map_.rules[rule_id] = Rule(rule_type=rule_type, steps=[
        RuleStep(RuleOp.SET_CHOOSELEAF_TRIES, 5, 0),
        RuleStep(RuleOp.TAKE, root_id, 0),
        RuleStep(RuleOp.CHOOSE_INDEP, num_domains, failure_domain_type),
        RuleStep(RuleOp.CHOOSELEAF_INDEP, num_per_domain, 0),
        RuleStep(RuleOp.EMIT, 0, 0),
    ])
    return rule_id


def add_osd_multi_per_domain_rule(
    map_: CrushMap,
    root_id: int,
    failure_domain_type: int,
    num_per_domain: int,
    rule_type: int | None = None,
    rule_id: int | None = None,
    num_domains: int = 0,
) -> int:
    """CrushWrapper::add_indep_multi_osd_per_failure_domain_rule
    (CrushWrapper.cc:2376,2466): an MSR rule — take root; choosemsr
    <num_domains> <failure-domain>; choosemsr <num_per_domain> osd;
    emit.  MSR descent retries the whole path on a rejected leaf, so
    an out OSD can remap to ANOTHER failure domain even with several
    OSDs per domain (wide EC on small clusters, mapper.c:1633-1720)."""
    if rule_type is None:
        rule_type = RULE_TYPE_MSR_INDEP
    if rule_id is None:
        rule_id = max(map_.rules.keys(), default=-1) + 1
    map_.rules[rule_id] = Rule(rule_type=rule_type, steps=[
        RuleStep(RuleOp.TAKE, root_id, 0),
        RuleStep(RuleOp.CHOOSE_MSR, num_domains, failure_domain_type),
        RuleStep(RuleOp.CHOOSE_MSR, num_per_domain, 0),
        RuleStep(RuleOp.EMIT, 0, 0),
    ])
    return rule_id


def _refresh_aux(b: Bucket) -> None:
    """Recompute the per-alg auxiliary arrays after an items change
    (make_bucket derivations, builder.c crush_bucket_add/remove_item)."""
    if b.alg == BucketAlg.LIST:
        total = 0
        b.sum_weights = []
        for w in b.item_weights:
            total += w
            b.sum_weights.append(total)
    elif b.alg == BucketAlg.TREE:
        b.node_weights = _tree_node_weights(b.items, b.item_weights)
    elif b.alg == BucketAlg.UNIFORM:
        if b.item_weights:
            b.item_weights = [b.item_weights[0]] * len(b.items)


def add_bucket(
    map_: CrushMap, name: str, type_name: str,
    alg: BucketAlg = BucketAlg.STRAW2,
) -> Bucket:
    """CrushWrapper::add_bucket + set_item_name: a new EMPTY named
    bucket, unattached until `osd crush move` places it."""
    if name in map_.bucket_names:
        return map_.buckets[map_.bucket_names[name]]
    b = make_bucket(map_, alg, map_.type_id(type_name), [], [])
    map_.bucket_names[name] = b.id
    return b


def detach_item(map_: CrushMap, item: int) -> int:
    """Unlink ``item`` from whichever bucket holds it (builder.c
    crush_bucket_remove_item), propagating the weight loss up.
    Returns the weight it had (16.16), or -1 if unattached."""
    for b in map_.buckets.values():
        for i, it in enumerate(b.items):
            if it == item:
                w = b.item_weights[i]
                del b.items[i]
                del b.item_weights[i]
                _refresh_aux(b)
                if w:
                    _propagate_weight(map_, b.id, -w)
                return w
    return -1


def attach_item(
    map_: CrushMap, item: int, parent: int, weight: int,
) -> None:
    """Link ``item`` under bucket ``parent`` at ``weight``
    (builder.c crush_bucket_add_item)."""
    b = map_.buckets[parent]
    b.items.append(item)
    b.item_weights.append(weight)
    _refresh_aux(b)
    if weight:
        _propagate_weight(map_, b.id, weight)
    if item >= 0:
        map_.max_devices = max(map_.max_devices, item + 1)


def would_cycle(map_: CrushMap, item: int, parent: int) -> bool:
    """True when linking bucket ``item`` under ``parent`` would create
    a cycle (parent is item or sits inside item's subtree)."""
    if item >= 0:
        return False
    seen = set()
    cur = parent
    while cur is not None and cur not in seen:
        if cur == item:
            return True
        seen.add(cur)
        cur = next(
            (b.id for b in map_.buckets.values() if cur in b.items),
            None,
        )
    return False


def move_item(
    map_: CrushMap, item: int, parent: int, weight: int | None = None,
) -> bool:
    """CrushWrapper::move_bucket / create-or-move semantics: unlink
    from the current parent (keeping the weight unless overridden) and
    relink under ``parent``.  Refuses a move that would create a cycle
    (moving a bucket under its own subtree).  Returns False on cycle."""
    if would_cycle(map_, item, parent):
        return False
    old_w = detach_item(map_, item)
    if weight is None:
        weight = old_w if old_w >= 0 else (
            map_.buckets[item].weight if item < 0 else 0x10000)
    attach_item(map_, item, parent, weight)
    return True


def remove_item(map_: CrushMap, item: int) -> bool:
    """CrushWrapper::remove_item: unlink everywhere; a bucket is also
    deleted from the map (caller enforces emptiness)."""
    found = detach_item(map_, item) >= 0
    if item < 0 and item in map_.buckets:
        del map_.buckets[item]
        for name, bid in list(map_.bucket_names.items()):
            if bid == item:
                del map_.bucket_names[name]
        found = True
    return found


def reweight_item(map_: CrushMap, item: int, weight: int) -> bool:
    """CrushWrapper::adjust_item_weightf: set an item's CRUSH weight
    (16.16 fixed) wherever it appears, propagating the delta up through
    ancestor buckets.  Returns True when the item was found."""
    found = False
    for b in map_.buckets.values():
        for i, it in enumerate(b.items):
            if it == item:
                delta = weight - b.item_weights[i]
                b.item_weights[i] = weight
                found = True
                if delta:
                    _propagate_weight(map_, b.id, delta)
    return found


def _propagate_weight(map_: CrushMap, child: int, delta: int) -> None:
    for b in map_.buckets.values():
        for i, it in enumerate(b.items):
            if it == child:
                b.item_weights[i] += delta
                _propagate_weight(map_, b.id, delta)
                return
