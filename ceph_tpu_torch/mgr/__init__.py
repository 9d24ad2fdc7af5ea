"""The manager's analytics plane (the ceph-mgr role), as far as the port
carries it:

- :mod:`analytics` — cluster-wide p50/p95/p99, EWMA trends and outlier
  daemons as one kernel launch over the whole (daemons x metrics x
  window) store, launched once at mgr start (cold_launches == 0), beside
  a bit-identical numpy host path;
- :mod:`daemon` — the time-series store the reports land in, and the
  digest's summary keyed back to daemon and metric names.  The
  ``MgrDaemon`` process waits for the messenger.
"""

from ceph_tpu_torch.mgr.analytics import AnalyticsEngine, analyze_numpy  # noqa: F401
from ceph_tpu_torch.mgr.daemon import (  # noqa: F401
    SAMPLE_CLAMP,
    TimeSeriesStore,
    analytics_summary,
)
