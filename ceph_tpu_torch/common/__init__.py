"""Shared daemon infrastructure (reference src/common/): typed config,
perf counters and their prometheus exposition, span tracing with the
wire context, op tracking, admin sockets, leveled dout logging, crash
dumps, caps, the fault injector, the reservers and the interleaving
scheduler.

The port's twin of ceph_tpu/common/ with the same exports, the cluster
log's ``LogClient`` and ``format_entry`` included.  ``transfer_guard``
is the port's own (it judges torch copies), and so is ``launches`` (the
kernel wrappers' counts of a process, served as ``dump_launches``);
``cpumesh`` pins JAX to a virtual CPU platform and has no twin here."""

from ceph_tpu_torch.common.admin_socket import AdminSocket, admin_command
from ceph_tpu_torch.common.config import OPTIONS, ConfigProxy, Option, declare
from ceph_tpu_torch.common.crash import record_crash, scan_crashes
from ceph_tpu_torch.common.dout import DoutLogger
from ceph_tpu_torch.common.logclient import LogClient, format_entry
from ceph_tpu_torch.common.optracker import OpTracker, TrackedOp
from ceph_tpu_torch.common.metrics import (
    MetricsServer,
    PerfCounters,
    all_collections,
    get_perf_counters,
    prometheus_text,
)

__all__ = [
    "AdminSocket",
    "DoutLogger",
    "LogClient",
    "OPTIONS",
    "OpTracker",
    "TrackedOp",
    "admin_command",
    "ConfigProxy",
    "MetricsServer",
    "Option",
    "PerfCounters",
    "all_collections",
    "declare",
    "format_entry",
    "get_perf_counters",
    "prometheus_text",
    "record_crash",
    "scan_crashes",
]
