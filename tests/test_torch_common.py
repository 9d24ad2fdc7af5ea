"""Config, metrics, compressor subsystem tests (reference analogues:
config unit tests over md_config_t, perf counter tests, compressor
plugin round-trips).

The port's twin of tests/test_common.py: the same cases over
``ceph_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import urllib.request

import pytest

from ceph_tpu_torch import compressor
from ceph_tpu_torch.common import (
    ConfigProxy,
    MetricsServer,
    Option,
    PerfCounters,
    prometheus_text,
)
from ceph_tpu_torch.common.config import OPTIONS


class TestConfig:
    def test_defaults_and_types(self):
        conf = ConfigProxy()
        assert conf["osd_pool_default_size"] == 3
        assert isinstance(conf["osd_beacon_report_interval"], float)

    def test_source_precedence(self):
        conf = ConfigProxy()
        conf.set("osd_pool_default_size", 5, source="file")
        assert conf["osd_pool_default_size"] == 5
        conf.set("osd_pool_default_size", 7, source="mon")
        assert conf["osd_pool_default_size"] == 7
        conf.set("osd_pool_default_size", 9, source="file")  # lower wins not
        assert conf["osd_pool_default_size"] == 7
        conf.set("osd_pool_default_size", 2, source="override")
        assert conf["osd_pool_default_size"] == 2
        conf.rm("osd_pool_default_size", source="override")
        assert conf["osd_pool_default_size"] == 7

    def test_bounds_and_bool_parse(self):
        conf = ConfigProxy()
        with pytest.raises(ValueError):
            conf.set("debug_osd", 99)
        with pytest.raises(KeyError):
            conf.set("not_an_option", 1)
        opt = Option("x", bool, False)
        assert opt.cast("true") is True
        assert opt.cast("0") is False
        with pytest.raises(ValueError):
            opt.cast("maybe")

    def test_observers_fire_on_apply_changes(self):
        conf = ConfigProxy()
        seen = {}
        conf.add_observer(
            ("osd_recovery_max_active",), lambda ch: seen.update(ch)
        )
        conf.apply_changes({"osd_recovery_max_active": 8})
        assert seen == {"osd_recovery_max_active": 8}
        conf.apply_changes({"debug_osd": 3})  # not watched
        assert len(seen) == 1

    def test_show_filters_by_level(self):
        conf = ConfigProxy()
        basic = conf.show(level="basic")
        assert "osd_pool_default_size" in basic
        assert "ms_inject_socket_failures" not in basic
        assert set(conf.show()) == set(OPTIONS)

    def test_cmdline_overrides(self):
        conf = ConfigProxy({"osd_min_pg_log_entries": 4})
        assert conf["osd_min_pg_log_entries"] == 4


class TestMetrics:
    def test_counters_and_prometheus_text(self):
        pc = PerfCounters("osd.99")
        pc.inc("op", 3)
        pc.inc("op_in_bytes", 1024)
        pc.set_gauge("pg_count", 7)
        text = prometheus_text({"osd.99": pc})
        assert "ceph_tpu_osd_99_op 3.0" in text
        assert "ceph_tpu_osd_99_op_in_bytes 1024.0" in text
        assert "ceph_tpu_osd_99_pg_count 7" in text

    def test_metrics_http_endpoint(self):
        async def go():
            pc = PerfCounters("mon.0")
            pc.inc("epochs", 5)
            srv = MetricsServer({"mon.0": pc})
            host, port = await srv.start()
            body = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=5
                ).read(),
            )
            assert b"ceph_tpu_mon_0_epochs 5.0" in body
            await srv.stop()

        asyncio.new_event_loop().run_until_complete(go())


class TestCompressor:
    def test_roundtrip_all_available(self):
        blob = b"ceph_tpu" * 1000 + bytes(range(256))
        for name in compressor.available():
            c = compressor.create(name)
            comp = c.compress(blob)
            assert c.decompress(comp) == blob
            if name not in ("none",):
                assert len(comp) < len(blob)

    def test_zlib_and_zstd_registered(self):
        avail = compressor.available()
        assert "zlib" in avail
        assert "none" in avail
        try:
            import zstandard  # noqa: F401
        except ImportError:
            # no zstandard wheel: the registry must degrade cleanly —
            # stdlib codecs stay available, zstd simply unregistered
            assert "zstd" not in avail
        else:
            assert "zstd" in avail

    def test_unknown_name_lists_available(self):
        with pytest.raises(KeyError) as e:
            compressor.create("snappy-unavailable")
        assert "available" in str(e.value)
