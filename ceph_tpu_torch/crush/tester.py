"""CrushTester: offline placement-quality analysis.

Behavioral twin of the reference's CrushTester
(src/crush/CrushTester.{h,cc}, driven by `crushtool --test`): simulate
placements for a range of inputs against one rule, and report
per-device utilization, expected-vs-actual deviation, and bad (short)
mappings.  The batch runs through the batched engine
(crush/cudamapper.py) on the card — the whole x-range is one kernel
launch — unless the map is outside its surface by design
(``UnsupportedMap``: legacy bucket algorithms, local fallback tries),
which the scalar interpreter maps.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush.cudamapper import (
    BatchedRuleMapper,
    UnsupportedMap,
    compile_map,
)
from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, CrushMap
from ceph_tpu_torch.ops.rs_kernels import resolve_device


@dataclass
class TestResult:
    rule: int
    num_rep: int
    total_mappings: int
    bad_mappings: list[int] = field(default_factory=list)
    device_counts: dict[int, int] = field(default_factory=dict)
    mappings: dict[int, list[int]] = field(default_factory=dict)

    @property
    def expected_per_device(self) -> float:
        used = len(self.device_counts)
        return (self.total_mappings * self.num_rep / used) if used else 0.0

    def statistics(self) -> dict:
        counts = np.array(sorted(self.device_counts.values())) if self.device_counts else np.zeros(0)
        return {
            "rule": self.rule,
            "num_rep": self.num_rep,
            "mappings": self.total_mappings,
            "bad_mappings": len(self.bad_mappings),
            "devices_used": len(self.device_counts),
            "expected_per_device": round(self.expected_per_device, 2),
            "min": int(counts.min()) if counts.size else 0,
            "max": int(counts.max()) if counts.size else 0,
            "stddev": round(float(counts.std()), 2) if counts.size else 0.0,
        }


class CrushTester:
    def __init__(self, crush: CrushMap, device=None):
        self.crush = crush
        self.device = resolve_device(device)

    def test(
        self,
        rule: int,
        num_rep: int,
        min_x: int = 0,
        max_x: int = 1023,
        weights: list[int] | None = None,
        keep_mappings: bool = False,
    ) -> TestResult:
        """CrushTester::test (CrushTester.h:351): place x in
        [min_x, max_x], collect stats; a mapping shorter than num_rep
        (or with holes) is 'bad' (--show-bad-mappings semantics)."""
        xs = np.arange(min_x, max_x + 1, dtype=np.uint32)
        res = TestResult(rule=rule, num_rep=num_rep, total_mappings=len(xs))
        rows: list[list[int]] = []
        try:
            bm = BatchedRuleMapper(compile_map(self.crush), rule, num_rep,
                                   device=self.device)
        except (UnsupportedMap, KeyError):
            bm = None
        if bm is not None:
            vals, cnt = bm(xs, weights)
            for i in range(len(xs)):
                rows.append([int(v) for v in vals[i, : cnt[i]]])
        else:
            for x in xs:
                rows.append(
                    crush_do_rule(self.crush, rule, int(x), num_rep, weights)
                )
        for x, row in zip(xs, rows):
            devices = [o for o in row if o != CRUSH_ITEM_NONE]
            if len(devices) < num_rep:
                res.bad_mappings.append(int(x))
            for o in devices:
                res.device_counts[o] = res.device_counts.get(o, 0) + 1
            if keep_mappings:
                res.mappings[int(x)] = row
        return res
