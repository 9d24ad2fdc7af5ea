"""The manager's plane (the ceph-mgr role), as far as the port carries
it:

- :mod:`analytics` — cluster-wide p50/p95/p99, EWMA trends and outlier
  daemons as one kernel launch over the whole (daemons x metrics x
  window) store, launched once at mgr start (cold_launches == 0), beside
  a bit-identical numpy host path;
- :mod:`daemon` — the time-series store the reports land in, and the
  digest's summary keyed back to daemon and metric names.  The
  ``MgrDaemon`` process is not ported yet;
- :mod:`client` — MgrClient, embedded in the OSD and mon daemons:
  watches the MgrMap, re-opens its session after failover, ships
  perf-counter deltas + log2 latency histograms + status;
- :mod:`modules` — the module framework's registry (`ceph mgr module
  ls/enable/disable` on the mon) and its modules;
- :mod:`tracer` — the cluster-wide span-tree assembly the mon's
  ``trace show`` renders.
"""

from ceph_tpu_torch.mgr.analytics import AnalyticsEngine, analyze_numpy  # noqa: F401
from ceph_tpu_torch.mgr.client import MgrClient  # noqa: F401
from ceph_tpu_torch.mgr.daemon import (  # noqa: F401
    SAMPLE_CLAMP,
    TimeSeriesStore,
    analytics_summary,
)
from ceph_tpu_torch.mgr.modules import (  # noqa: F401
    DEFAULT_MODULES,
    MODULE_REGISTRY,
    MgrModule,
)
