"""CRUSH map (de)compiler: a map's text form compiles back to a map that
places every input as the original does.

The port's twin of the compiler cases of tests/test_tools.py
(``TestCompiler``): the same cases over ``ceph_tpu_torch``.  Its
cross-package parity (byte-equal text, equal maps and placements through
the batched mapper) is in tests/test_torch_services_parity.py.
"""

from __future__ import annotations

import json

import pytest

from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.compiler import compile_text, decompile
from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.crush.types import CrushMap


@pytest.fixture(scope="module")
def simple_map():
    m = CrushMap()
    root = B.build_hierarchy(m, osds_per_host=2, n_hosts=8)
    B.add_simple_rule(m, root.id, 1, mode="firstn", rule_id=0)
    B.add_simple_rule(m, root.id, 1, mode="indep", rule_type=3, rule_id=1)
    return m


class TestCompiler:
    def test_roundtrip_preserves_placement(self, simple_map):
        text = decompile(simple_map)
        m2 = compile_text(text)
        for x in range(64):
            assert crush_do_rule(m2, 0, x, 3) == crush_do_rule(
                simple_map, 0, x, 3
            )
            assert crush_do_rule(m2, 1, x, 5) == crush_do_rule(
                simple_map, 1, x, 5
            )

    def test_bad_reference_rejected(self):
        with pytest.raises(ValueError):
            compile_text(json.dumps({
                "buckets": [{"id": -1, "type": 1, "items": [{"id": -9, "weight": 1}]}],
            }))
