"""The manager's plane (the ceph-mgr role), as far as the port carries
it:

- :mod:`analytics` — cluster-wide p50/p95/p99, EWMA trends and outlier
  daemons as one kernel launch over the whole (daemons x metrics x
  window) store, launched once at mgr start (cold_launches == 0), beside
  a bit-identical numpy host path;
- :mod:`daemon` — the MgrDaemon process: beacons into the mon
  (active/standby is the MgrMonitor's call), hosts the report plane
  (every daemon's MgrClient streams MMgrReport telemetry into the
  fixed-shape time-series store) and the analytics engine, and digests
  back to the mon (MMonMgrReport — `ceph osd perf`, dashboard views,
  health checks);
- :mod:`client` — MgrClient, embedded in the OSD and mon daemons:
  watches the MgrMap, re-opens its session after failover, ships
  perf-counter deltas + log2 latency histograms + status;
- :mod:`modules` — the module framework's registry (`ceph mgr module
  ls/enable/disable` on the mon) and its modules;
- :mod:`tracer` — the cluster-wide span-tree assembly the mon's
  ``trace show`` renders;
- :mod:`dashboard` — the read-only web UI (serves the mgr's
  aggregated series when a mgr is active).
"""

from ceph_tpu_torch.mgr.analytics import AnalyticsEngine, analyze_numpy  # noqa: F401
from ceph_tpu_torch.mgr.client import MgrClient  # noqa: F401
from ceph_tpu_torch.mgr.daemon import (  # noqa: F401
    ANALYTICS_COLUMNS,
    SAMPLE_CLAMP,
    MgrDaemon,
    TimeSeriesStore,
    analytics_summary,
)
from ceph_tpu_torch.mgr.modules import (  # noqa: F401
    DEFAULT_MODULES,
    MODULE_REGISTRY,
    MgrModule,
)
