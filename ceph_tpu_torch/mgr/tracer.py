"""TraceCollector: cross-daemon trace assembly on the active mgr.

The jaeger-collector role for the cluster's tracing plane
(common/tracing.py): every daemon's MgrClient drains its tracers'
export buffers into ``MMgrReport.spans``; the active mgr lands them
here, keyed by trace_id.  On demand (``ceph trace ls/show``, the
dashboard, the digest) the collector assembles each trace's span tree,
computes the **critical path** and a **per-stage latency breakdown**
(net / queue / device / store / other), and keeps a bounded history of
slow traces — the cluster-wide analogue of the op tracker's
``dump_historic_slow_ops``.

Ordering: spans are sorted by their monotonic start stamps when they
come from the same process (shared clock) and by wall-clock start
otherwise, so cross-daemon assembly never produces negative-latency
children from clock skew.

Assembly tolerates missing parents: the client's root span never
reaches the mgr (clients carry no MgrClient), so a span whose
parent_id is unknown becomes a child of a SYNTHESIZED root labelled
from the wire context's reqid — the tree still reads client -> primary
-> shards -> store commit.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque

from ceph_tpu_torch.common.tracing import STAGES


def _stage_of(span: dict) -> str:
    st = str(span.get("tags", {}).get("stage", "other"))
    return st if st in STAGES else "other"


class TraceCollector:
    def __init__(self, max_traces: int = 256, slow_history: int = 32,
                 slow_s: float = 1.0):
        self.max_traces = max_traces
        self.slow_s = slow_s
        #: trace_id -> {"spans": [span dicts], "first", "last", "reqid"}
        self.traces: "OrderedDict[int, dict]" = OrderedDict()
        #: assembled slow-trace records (bounded)
        self.slow: deque = deque(maxlen=slow_history)
        self._slow_seen: set[int] = set()
        #: device-launch profiling spans (xla_launch): standalone
        #: roots by design — kept in their own ring so thousands of
        #: launches cannot evict real request traces from the LRU
        self.device: deque = deque(maxlen=512)
        self.stats = {
            "spans_rx": 0, "traces_evicted": 0, "orphan_spans": 0,
            "device_spans": 0,
        }

    # -- ingest --------------------------------------------------------

    def ingest(self, daemon: str, spans: list[dict]) -> None:
        now = time.monotonic()
        for sp in spans:
            tid = sp.get("trace_id")
            if not tid:
                continue
            if sp.get("daemon") == "device" or sp.get("name") == "xla_launch":
                self.device.append(dict(sp))
                self.stats["device_spans"] += 1
                continue
            rec = self.traces.get(tid)
            if rec is None:
                rec = self.traces[tid] = {
                    "spans": [], "first": now, "reqid": "",
                }
                while len(self.traces) > self.max_traces:
                    self.traces.popitem(last=False)
                    self.stats["traces_evicted"] += 1
            else:
                self.traces.move_to_end(tid)
            sp = dict(sp)
            sp.setdefault("daemon", daemon)
            rec["spans"].append(sp)
            rec["last"] = now
            if not rec["reqid"] and sp.get("tags", {}).get("reqid"):
                rec["reqid"] = str(sp["tags"]["reqid"])
            self.stats["spans_rx"] += 1
            # tail capture: a slow trace is archived once its slow
            # span count stabilizes (re-assembled lazily on access)
            dur = sp.get("duration_ms") or 0.0
            if dur >= self.slow_s * 1e3 and tid not in self._slow_seen:
                self._slow_seen.add(tid)
                self.slow.append(tid)

    # -- assembly ------------------------------------------------------

    @staticmethod
    def _sort_key(sp: dict):
        return (sp.get("start") or 0.0, sp.get("start_mono") or 0.0)

    def assemble(self, trace_id: int) -> dict | None:
        """Build the span tree + critical path + stage breakdown for
        one trace.  Returns None for an unknown trace_id."""
        rec = self.traces.get(trace_id)
        if rec is None:
            return None
        spans = sorted(rec["spans"], key=self._sort_key)
        by_id = {sp["span_id"]: sp for sp in spans}
        children: dict[int, list[dict]] = {}
        roots: list[dict] = []
        synthetic: dict | None = None
        for sp in spans:
            pid = sp.get("parent_id")
            if pid is None:
                roots.append(sp)
            elif pid in by_id:
                children.setdefault(pid, []).append(sp)
            else:
                # parent never reached us (the client's root, or an
                # evicted/raced report): hang it under a synthesized
                # root so the tree stays connected
                self.stats["orphan_spans"] += 1
                if synthetic is None:
                    synthetic = {
                        "name": "client_op*", "span_id": pid,
                        "parent_id": None, "trace_id": trace_id,
                        "daemon": "client", "synthetic": True,
                        "start": sp.get("start"),
                        "start_mono": sp.get("start_mono"),
                        "end_mono": sp.get("end_mono"),
                        "duration_ms": None,
                        "tags": {"reqid": rec["reqid"]},
                    }
                    roots.append(synthetic)
                    by_id[pid] = synthetic
                children.setdefault(pid, []).append(sp)
        if synthetic is not None:
            # bound the synthetic root by its known descendants
            kids = children.get(synthetic["span_id"], [])
            if kids:
                starts = [k.get("start_mono") or 0.0 for k in kids]
                ends = [k.get("end_mono") or 0.0 for k in kids]
                synthetic["start_mono"] = min(starts)
                synthetic["end_mono"] = max(ends)
                synthetic["start"] = min(
                    k.get("start") or 0.0 for k in kids)
                synthetic["duration_ms"] = round(
                    (synthetic["end_mono"] - synthetic["start_mono"])
                    * 1e3, 3)
        if not roots:
            return None
        root = max(
            roots,
            key=lambda sp: (sp.get("duration_ms") or 0.0),
        )

        def _node(sp: dict) -> dict:
            return {
                "name": sp["name"],
                "daemon": sp.get("daemon", ""),
                "span_id": sp["span_id"],
                "stage": _stage_of(sp),
                "start": sp.get("start"),
                "start_mono": sp.get("start_mono"),
                "end_mono": sp.get("end_mono"),
                "duration_ms": sp.get("duration_ms"),
                "tags": dict(sp.get("tags", {})),
                "children": [
                    _node(c) for c in sorted(
                        children.get(sp["span_id"], ()),
                        key=self._sort_key)
                ],
            }

        tree = _node(root)
        path, stages = self._critical_path(tree)
        return {
            "trace_id": trace_id,
            "reqid": rec["reqid"],
            "root": tree["name"],
            "daemons": sorted({sp.get("daemon", "") for sp in spans}),
            "n_spans": len(spans),
            "duration_ms": tree["duration_ms"],
            "stages_ms": stages,
            "critical_path": path,
            "tree": tree,
        }

    @staticmethod
    def _critical_path(tree: dict) -> tuple[list[dict], dict]:
        """Walk the dominant child chain: at each node follow the child
        that ends LATEST (the op cannot have completed before it); the
        node's exclusive time — its duration minus the on-path child's
        — lands in the node's stage bucket.  Returns (path, stage_ms).
        """
        stages = {s: 0.0 for s in STAGES}
        path: list[dict] = []
        node = tree
        while node is not None:
            dur = node.get("duration_ms") or 0.0
            kids = [
                c for c in node.get("children", ())
                if c.get("end_mono") is not None
            ]
            nxt = max(
                kids, key=lambda c: c["end_mono"], default=None)
            child_dur = (nxt.get("duration_ms") or 0.0) if nxt else 0.0
            exclusive = max(dur - child_dur, 0.0)
            stages[_stage_of(node)] += exclusive
            path.append({
                "name": node["name"], "daemon": node.get("daemon", ""),
                "stage": _stage_of(node),
                "duration_ms": dur,
                "exclusive_ms": round(exclusive, 3),
            })
            node = nxt
        return path, {k: round(v, 3) for k, v in stages.items()}

    # -- query surface -------------------------------------------------

    def ls(self, limit: int = 32) -> list[dict]:
        """Newest-first trace summaries (`ceph trace ls`)."""
        out = []
        for tid in list(reversed(self.traces.keys()))[:limit]:
            a = self.assemble(tid)
            if a is None:
                continue
            out.append({
                "trace_id": tid,
                "reqid": a["reqid"],
                "root": a["root"],
                "daemons": a["daemons"],
                "n_spans": a["n_spans"],
                "duration_ms": a["duration_ms"],
                "slow": tid in self._slow_seen,
            })
        return out

    def slow_traces(self, limit: int = 8) -> list[dict]:
        out = []
        for tid in list(self.slow)[-limit:]:
            a = self.assemble(tid)
            if a is not None:
                out.append(a)
        return out

    def device_launches(self, limit: int = 64) -> list[dict]:
        """Most recent device-launch profiling spans (bucket shape,
        occupancy, cold verdict, block-until-ready duration)."""
        return list(self.device)[-limit:]

    def dump(self) -> dict:
        return {
            "stats": dict(self.stats),
            "n_traces": len(self.traces),
            "slow": [int(t) for t in self.slow],
            "device_launches": len(self.device),
        }


def render_tree(tree: dict, indent: int = 0) -> list[str]:
    """Human-readable span-tree lines (the `ceph trace show` view)."""
    dur = tree.get("duration_ms")
    line = "{}{} [{}] {}{}".format(
        "  " * indent, tree["name"], tree.get("daemon", "?"),
        f"{dur:.3f}ms" if dur is not None else "?",
        f" stage={tree.get('stage')}" if tree.get("stage") else "",
    )
    out = [line]
    for c in tree.get("children", ()):
        out.extend(render_tree(c, indent + 1))
    return out
