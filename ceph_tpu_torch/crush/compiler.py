"""CRUSH map (de)compiler: a readable on-disk text form.

The reference compiles a text grammar to the binary map and back
(src/crush/CrushCompiler.cc, grammar.h; `crushtool -c/-d`).  Here the
text form is JSON with the same vocabulary (devices, types, buckets
with alg/hash/items, rules with step programs, tunables), which keeps
maps diffable and hand-editable while staying trivially parseable.

Counterpart of ``ceph_tpu/crush/compiler.py``: the same text and the same
maps.
"""

from __future__ import annotations

import json

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


def decompile(m: CrushMap) -> str:
    """CrushCompiler::decompile: map -> text."""
    doc = {
        "tunables": {
            "choose_local_tries": m.tunables.choose_local_tries,
            "choose_local_fallback_tries": m.tunables.choose_local_fallback_tries,
            "choose_total_tries": m.tunables.choose_total_tries,
            "chooseleaf_descend_once": m.tunables.chooseleaf_descend_once,
            "chooseleaf_vary_r": m.tunables.chooseleaf_vary_r,
            "chooseleaf_stable": m.tunables.chooseleaf_stable,
            "msr_descents": m.tunables.msr_descents,
            "msr_collision_tries": m.tunables.msr_collision_tries,
        },
        "types": {str(tid): name for tid, name in sorted(m.types.items())},
        "devices": [
            {"id": osd, "class": m.device_classes.get(osd)}
            for osd in range(m.max_devices)
        ],
        "buckets": [
            {
                "id": b.id,
                "name": next(
                    (n for n, i in m.bucket_names.items() if i == b.id), None
                ),
                "type": b.type,
                "alg": b.alg.name.lower(),
                "hash": b.hash,
                "items": [
                    {"id": it, "weight": w}
                    for it, w in zip(b.items, b.item_weights)
                ],
            }
            for b in sorted(m.buckets.values(), key=lambda b: -b.id)
        ],
        "rules": [
            {
                "id": rid,
                "name": next(
                    (n for n, i in m.rule_names.items() if i == rid), None
                ),
                "type": r.rule_type,
                "device_class": r.device_class,
                "steps": [
                    {"op": s.op.name.lower(), "arg1": s.arg1, "arg2": s.arg2}
                    for s in r.steps
                ],
            }
            for rid, r in sorted(m.rules.items())
        ],
        "choose_args": {
            str(bid): {
                "weight_set": arg.weight_set,
                "ids": arg.ids,
            }
            for bid, arg in sorted(m.choose_args.items())
        },
    }
    return json.dumps(doc, indent=2)


def compile_text(text: str) -> CrushMap:
    """CrushCompiler::compile: text -> map (with sanity checks)."""
    doc = json.loads(text)
    m = CrushMap(types={})
    t = doc.get("tunables", {})
    m.tunables = Tunables(**{
        k: int(v) for k, v in t.items()
        if k in Tunables.__dataclass_fields__
    })
    for tid, name in doc.get("types", {}).items():
        m.types[int(tid)] = name
    for dev in doc.get("devices", []):
        m.max_devices = max(m.max_devices, int(dev["id"]) + 1)
        if dev.get("class"):
            m.device_classes[int(dev["id"])] = dev["class"]
    for b in doc.get("buckets", []):
        bid = int(b["id"])
        if bid >= 0:
            raise ValueError(f"bucket id {bid} must be negative")
        bucket = Bucket(
            id=bid,
            type=int(b["type"]),
            alg=BucketAlg[b.get("alg", "straw2").upper()],
            hash=int(b.get("hash", 0)),
            items=[int(i["id"]) for i in b.get("items", [])],
            item_weights=[int(i["weight"]) for i in b.get("items", [])],
        )
        m.buckets[bid] = bucket
        if b.get("name"):
            m.bucket_names[b["name"]] = bid
        for i in bucket.items:
            if i >= 0:
                m.max_devices = max(m.max_devices, i + 1)
    for r in doc.get("rules", []):
        steps = [
            RuleStep(
                RuleOp[s["op"].upper()], int(s.get("arg1", 0)),
                int(s.get("arg2", 0)),
            )
            for s in r.get("steps", [])
        ]
        rid = int(r["id"])
        m.rules[rid] = Rule(
            rule_type=int(r.get("type", 1)), steps=steps,
            device_class=r.get("device_class"),
        )
        if r.get("name"):
            m.rule_names[r["name"]] = rid
    for bid, arg in doc.get("choose_args", {}).items():
        m.choose_args[int(bid)] = ChooseArg(
            int(bid), weight_set=arg.get("weight_set"), ids=arg.get("ids"),
        )
    # sanity: referenced children must exist (compiler sanity checks)
    for b in m.buckets.values():
        for it in b.items:
            if it < 0 and it not in m.buckets:
                raise ValueError(f"bucket {b.id} references unknown {it}")
    return m
