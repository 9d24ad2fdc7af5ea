"""FaultInjector (reference src/common/fault_injector.h twin):
deterministic error/delay/abort at named points.

The port's twin of tests/test_fault_injector.py: the same cases over
``ceph_tpu_torch``.  The injected cluster fault case (a
mini-cluster write through the client) waits for the port's daemons.
"""

import asyncio
import errno

import pytest

from ceph_tpu_torch.common.fault_injector import (
    FAULTS,
    FaultInjector,
    InjectedAbort,
    InjectedError,
)


@pytest.fixture(autouse=True)
def clean():
    FAULTS.clear()
    yield
    FAULTS.clear()


class TestInjector:
    def test_error_count_semantics(self):
        async def go():
            fi = FaultInjector()
            fi.inject("p", error=errno.EIO, count=2)
            for _ in range(2):
                with pytest.raises(InjectedError) as ei:
                    await fi.check("p")
                assert ei.value.errno == errno.EIO
            await fi.check("p")  # exhausted: no-op
            assert fi.fired("p") == 2

        asyncio.run(go())

    def test_delay_and_abort(self):
        async def go():
            fi = FaultInjector()
            fi.inject("d", delay=0.05)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            await fi.check("d")
            assert loop.time() - t0 >= 0.045
            fi.inject("a", abort=True)
            with pytest.raises(InjectedAbort):
                await fi.check("a")
            # abort is NOT an OSError: blanket except OSError won't eat it
            assert not issubclass(InjectedAbort, OSError)

        asyncio.run(go())

    def test_unarmed_points_are_noops(self):
        async def go():
            await FAULTS.check("never.armed")
            FAULTS.check_sync("never.armed")

        asyncio.run(go())

    def test_check_and_check_sync_parity(self):
        """Both flavors share one count budget and raise identically."""
        async def go():
            fi = FaultInjector()
            fi.inject("p", error=errno.EIO, count=2)
            with pytest.raises(InjectedError) as e1:
                await fi.check("p")
            with pytest.raises(InjectedError) as e2:
                fi.check_sync("p")
            assert e1.value.errno == e2.value.errno == errno.EIO
            # budget spent across BOTH: third hit is a no-op either way
            await fi.check("p")
            fi.check_sync("p")
            assert fi.fired("p") == 2
            fi.inject("a", abort=True, count=None)
            with pytest.raises(InjectedAbort):
                await fi.check("a")
            with pytest.raises(InjectedAbort):
                fi.check_sync("a")

        asyncio.run(go())

    def test_sticky_count_none_fires_until_cleared(self):
        fi = FaultInjector()
        fi.inject("s", error=errno.EIO, count=None)
        for _ in range(5):
            with pytest.raises(InjectedError):
                fi.check_sync("s")
        assert fi.fired("s") == 5
        fi.clear("s")
        fi.check_sync("s")  # cleared: no-op
        assert fi.fired("s") == 0

    def test_clear_one_key_keeps_others(self):
        fi = FaultInjector()
        fi.inject("a", error=errno.EIO)
        fi.inject("b", error=errno.EIO)
        fi.clear("a")
        fi.check_sync("a")
        with pytest.raises(InjectedError):
            fi.check_sync("b")

    def test_data_faults_skip_check_points_and_vice_versa(self):
        """A bitflip/torn spec is invisible to check/check_sync (it
        must corrupt data, not raise) and an error spec is invisible
        to data_fault — one key serves both styles unambiguously."""
        fi = FaultInjector()
        fi.inject("k", bitflip=True, count=1)
        fi.check_sync("k")                      # no raise, no consume
        assert fi.fired("k") == 0
        spec = fi.data_fault("k")
        assert spec is not None and spec["bitflip"]
        assert fi.data_fault("k") is None       # count=1 consumed
        fi.inject("k", error=errno.EIO, count=1)
        assert fi.data_fault("k") is None       # error spec: wrong channel
        with pytest.raises(InjectedError):
            fi.check_sync("k")

    def test_peek_does_not_consume(self):
        fi = FaultInjector()
        fi.inject("k", torn=True, count=1)
        assert fi.peek("k")["torn"]
        assert fi.peek("k")["torn"]
        assert fi.data_fault("k")["torn"]
        assert fi.peek("k") is None  # exhausted

    def test_dump_lists_armed_and_fired(self):
        fi = FaultInjector()
        fi.inject("x", error=errno.EIO, count=2)
        with pytest.raises(InjectedError):
            fi.check_sync("x")
        d = fi.dump()
        assert d["x"]["fired"] == 1 and d["x"]["count"] == 2
        assert d["x"]["error"] == errno.EIO
