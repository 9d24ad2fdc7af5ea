"""CRUSH map data model.

Behavioral twin of the reference map model (src/crush/crush.h: struct
crush_map / crush_bucket_* / crush_rule), re-expressed as plain Python
dataclasses (host control plane) that compile to dense arrays for the
batched engine (ceph_tpu_torch/crush/cudamapper.py).

Weights are 16.16 fixed point (0x10000 == 1.0) exactly as in the
reference; bucket ids are negative, devices non-negative.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field


class BucketAlg(enum.IntEnum):
    # values match crush.h CRUSH_BUCKET_*
    UNIFORM = 1
    LIST = 2
    TREE = 3
    STRAW = 4
    STRAW2 = 5


class RuleOp(enum.IntEnum):
    # values match crush.h CRUSH_RULE_* step opcodes
    NOOP = 0
    TAKE = 1
    CHOOSE_FIRSTN = 2
    CHOOSE_INDEP = 3
    EMIT = 4
    CHOOSELEAF_FIRSTN = 6
    CHOOSELEAF_INDEP = 7
    SET_CHOOSE_TRIES = 8
    SET_CHOOSELEAF_TRIES = 9
    SET_CHOOSE_LOCAL_TRIES = 10
    SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
    SET_CHOOSELEAF_VARY_R = 12
    SET_CHOOSELEAF_STABLE = 13
    SET_MSR_DESCENTS = 14
    SET_MSR_COLLISION_TRIES = 15
    CHOOSE_MSR = 16


# rule types (crush.h crush_rule_type): 1/3 are the classic
# replicated/erasure interpreter rules; 4/5 are multi-step-retry rules
# served by crush_msr_do_rule (mapper.c:1809)
RULE_TYPE_REPLICATED = 1
RULE_TYPE_ERASURE = 3
RULE_TYPE_MSR_FIRSTN = 4
RULE_TYPE_MSR_INDEP = 5

CRUSH_ITEM_UNDEF = 0x7FFFFFFE  # mid-choose reservation (crush.h)
CRUSH_ITEM_NONE = 0x7FFFFFFF   # permanent hole, EC positional
CRUSH_HASH_RJENKINS1 = 0


@dataclass
class Bucket:
    """One interior node.  ``weight``/``item_weights`` are 16.16 fixed."""

    id: int                      # negative
    type: int                    # user-defined type id (host, rack, root, ...)
    alg: BucketAlg = BucketAlg.STRAW2
    hash: int = CRUSH_HASH_RJENKINS1
    items: list[int] = field(default_factory=list)
    item_weights: list[int] = field(default_factory=list)
    # legacy-alg extras:
    sum_weights: list[int] = field(default_factory=list)   # LIST prefix sums
    node_weights: list[int] = field(default_factory=list)  # TREE heap array
    straws: list[int] = field(default_factory=list)        # STRAW scaled draws

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.item_weights)


@dataclass
class RuleStep:
    op: RuleOp
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    rule_type: int               # pg_pool type: 1 replicated / 3 erasure
    steps: list[RuleStep] = field(default_factory=list)
    # restrict selection to OSDs of this device class (the reference
    # rewrites TAKE args to per-class shadow buckets; we filter by class
    # membership in the mapper — same resulting OSD set)
    device_class: str | None = None


@dataclass
class Tunables:
    """Defaults == the reference's "jewel" optimal profile, the modern
    default (src/crush/crush.c set_optimal_crush_map / CrushWrapper
    set_tunables_jewel)."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    # MSR rule tunables (crush.h msr_descents/msr_collision_tries;
    # defaults CrushWrapper::set_default_msr_tunables)
    msr_descents: int = 100
    msr_collision_tries: int = 100


@dataclass
class ChooseArg:
    """Per-bucket weight_set/ids overrides (pg-upmap balancer machinery,
    src/crush/crush.h struct crush_choose_arg)."""

    bucket_id: int
    weight_set: list[list[int]] | None = None  # [position][item] 16.16
    ids: list[int] | None = None


@dataclass
class CrushMap:
    buckets: dict[int, Bucket] = field(default_factory=dict)  # by id (negative)
    rules: dict[int, Rule] = field(default_factory=dict)
    types: dict[int, str] = field(
        default_factory=lambda: {0: "osd", 1: "host", 3: "rack", 10: "root"})
    max_devices: int = 0
    tunables: Tunables = field(default_factory=Tunables)
    choose_args: dict[int, ChooseArg] = field(default_factory=dict)
    # name tables (CrushWrapper name_map/rule_name_map, class_map)
    bucket_names: dict[str, int] = field(default_factory=dict)
    rule_names: dict[str, int] = field(default_factory=dict)
    device_classes: dict[int, str] = field(default_factory=dict)  # osd -> class

    def bucket(self, bid: int) -> Bucket:
        return self.buckets[bid]

    def type_id(self, name: str) -> int:
        for tid, tname in self.types.items():
            if tname == name:
                return tid
        raise KeyError(f"unknown CRUSH type {name!r}")

    def copy(self) -> "CrushMap":
        return dataclasses.replace(
            self,
            buckets={k: dataclasses.replace(
                v,
                items=list(v.items), item_weights=list(v.item_weights),
                sum_weights=list(v.sum_weights),
                node_weights=list(v.node_weights), straws=list(v.straws),
            ) for k, v in self.buckets.items()},
            rules={k: Rule(v.rule_type, [dataclasses.replace(s) for s in v.steps],
                           v.device_class)
                   for k, v in self.rules.items()},
            types=dict(self.types),
            tunables=dataclasses.replace(self.tunables),
            choose_args=dict(self.choose_args),
            bucket_names=dict(self.bucket_names),
            rule_names=dict(self.rule_names),
            device_classes=dict(self.device_classes),
        )
