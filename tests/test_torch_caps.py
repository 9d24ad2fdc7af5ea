"""MonCap/OSDCap grammar + matching unit tests (the role of
src/test/mon/moncap.cc and src/test/osd/osdcap.cc).

The port's twin of tests/test_caps.py: the same cases over
``ceph_tpu_torch``.
"""

from __future__ import annotations

import pytest

from ceph_tpu_torch.common.caps import (
    ADMIN_CAPS,
    CapsError,
    Grant,
    capable,
    parse,
    validate,
)


class TestParse:
    def test_basic_grants(self):
        assert parse("allow r") == [Grant(frozenset("r"), None)]
        assert parse("allow rwx") == [Grant(frozenset("rwx"), None)]
        assert parse("allow *") == [Grant(frozenset("rwx"), None)]
        assert parse("allow rw pool=data") == [
            Grant(frozenset("rw"), "data")]
        assert parse("allow r, allow w pool=x") == [
            Grant(frozenset("r"), None), Grant(frozenset("w"), "x")]

    def test_profiles(self):
        assert parse("allow profile osd") == [Grant(frozenset("rwx"), None)]
        assert parse("allow profile admin") == [Grant(frozenset("rwx"), None)]

    def test_rejects(self):
        for bad in ("deny r", "allow", "allow q", "allow r pool=",
                    "allow r foo=bar", "allow profile nope", ""):
            with pytest.raises(CapsError):
                parse(bad)

    def test_validate(self):
        validate({"mon": "allow r", "osd": "allow rw pool=a"})
        with pytest.raises(CapsError):
            validate({"bogus-service": "allow r"})
        with pytest.raises(CapsError):
            validate({"osd": "nonsense"})


class TestCapable:
    def test_pool_scoping(self):
        caps = {"osd": "allow rw pool=data, allow r"}
        assert capable(caps, "osd", "w", pool="data")
        assert capable(caps, "osd", "rw", pool="data")
        assert not capable(caps, "osd", "w", pool="other")
        assert capable(caps, "osd", "r", pool="other")

    def test_single_grant_must_cover(self):
        # reference semantics: separate r and w grants don't combine
        caps = {"osd": "allow r, allow w"}
        assert capable(caps, "osd", "r")
        assert capable(caps, "osd", "w")
        assert not capable(caps, "osd", "rw")

    def test_missing_service_denies(self):
        assert not capable({"mon": "allow *"}, "osd", "r")
        assert not capable({}, "mon", "r")

    def test_none_means_auth_off(self):
        assert capable(None, "osd", "rwx", pool="anything")

    def test_admin(self):
        assert capable(ADMIN_CAPS, "mon", "rw")
        assert capable(ADMIN_CAPS, "osd", "rwx", pool="p")

    def test_x_for_class_calls(self):
        caps = {"osd": "allow rwx pool=meta"}
        assert capable(caps, "osd", "wx", pool="meta")
        assert not capable({"osd": "allow rw pool=meta"}, "osd", "wx",
                           pool="meta")


class TestUnionRequirements:
    def test_write_only_cannot_bundle_read(self):
        # a single grant must cover the union: 'allow w' denies r+w
        caps = {"osd": "allow w pool=data"}
        assert capable(caps, "osd", "w", pool="data")
        assert not capable(caps, "osd", "rw", pool="data")
