"""Span tracing at the §3 seam points (reference blkin/otel spans,
src/osd/osd_tracer.cc + ECCommon.cc:440-445 per-shard child spans) —
now cluster-wide: wire-propagated contexts, mgr-side assembly, the
critical-path breakdown and the `ceph trace` verbs.

The port's twin of tests/integration/test_tracing.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

import asyncio
import json

from tests.test_torch_mini_cluster import Cluster, run


class TestSpans:
    def test_ec_write_opens_child_spans_per_shard(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "3", "m": "2"})
                await c.client.pool_create(
                    "tp", pg_num=4, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("tp")
                await io.write_full("traced", b"x" * 20000)
                assert await io.read("traced") == b"x" * 20000

                roots = []
                for osd in c.osds:
                    roots += [
                        s for s in osd.tracer.find(oid="traced")
                        if s.name == "do_op"
                    ]
                assert roots, "no do_op span recorded"
                write_root = next(
                    s for s in roots if s.tags.get("reqid"))
                osd = next(
                    o for o in c.osds
                    if write_root in o.tracer.find(oid="traced"))
                children = [
                    s for s in osd.tracer.find(reqid=write_root.tags["reqid"])
                    if s.name == "ec_sub_write"
                    and s.parent_id == write_root.span_id
                ]
                # remote shards get child spans (primary applies locally)
                assert len(children) >= 3, [s.dump() for s in children]
                assert all(s.duration is not None for s in children)
                # admin-socket shaped dump round-trips
                dump = osd.tracer.dump()
                assert any(d["name"] == "do_op" for d in dump)
                # wire propagation: the sub-write spans share the
                # CLIENT's trace_id (one op, one cluster-wide trace)
                client_roots = [
                    s for s in c.client.tracer.find(oid="traced")
                    if s.name == "client_op" and s.tags.get("write")
                ]
                assert client_roots
                assert write_root.trace_id == client_roots[0].trace_id
                assert all(
                    s.trace_id == write_root.trace_id for s in children)

        run(go())


def _tree_names(tree: dict) -> list[str]:
    out = [f"{tree['name']}@{tree['daemon']}"]
    for ch in tree.get("children", ()):
        out.extend(_tree_names(ch))
    return out


class TestClusterTraceAssembly:
    def test_ec_write_assembles_cross_daemon_trace(self):
        """One EC client write -> ONE assembled cross-daemon trace at
        the mgr whose span tree covers client -> primary do_op ->
        per-shard sub-writes on replica OSDs -> store commit, with a
        critical-path/stage breakdown and ZERO in-path XLA compiles —
        the tracing tentpole's acceptance path."""

        async def go():
            from ceph_tpu_torch.chaos.runner import _cold_launch_snapshot

            async with Cluster(n_osds=6, n_mgrs=1) as c:
                mgr = c.mgrs[0]
                for _ in range(200):
                    if mgr.active and (
                        mgr._warm_task is None or mgr._warm_task.done()
                    ):
                        break
                    await asyncio.sleep(0.05)
                assert mgr.active, "mgr never became active"
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "3", "m": "2"})
                await c.client.pool_create(
                    "tp", pg_num=4, pool_type="erasure",
                    erasure_code_profile="p")
                # EC-profile prewarm must land before the traced write
                # so the op path compiles nothing
                for _ in range(600):
                    if all(not o._warm_tasks for o in c.osds):
                        break
                    await asyncio.sleep(0.05)
                cold_before = _cold_launch_snapshot(c.device)

                io = c.client.ioctx("tp")
                await io.write_full("traced-ec", b"x" * 20000)

                cold_after = _cold_launch_snapshot(c.device)
                assert cold_after == cold_before, (
                    "the traced write minted an in-path XLA compile")

                root = next(
                    s for s in c.client.tracer.find(oid="traced-ec")
                    if s.name == "client_op")
                tid = root.trace_id
                # the client carries no MgrClient: feed its spans to
                # the collector directly (the synthetic-root path is
                # covered by assemble() for headless deployments).
                # Drain FULLY — the process-global client tracer may
                # hold thousands of spans from earlier tests — and
                # keep only this trace's
                client_spans: list[dict] = []
                while True:
                    batch = c.client.tracer.drain_export(limit=1024)
                    if not batch:
                        break
                    client_spans.extend(
                        s for s in batch if s["trace_id"] == tid)
                mgr.trace_collector.ingest("client.4242", client_spans)

                # daemon spans arrive on the report cadence
                assembled = None
                for _ in range(100):
                    assembled = mgr.trace_collector.assemble(tid)
                    if assembled is not None:
                        names = _tree_names(assembled["tree"])
                        if (
                            any(n.startswith("do_op@") for n in names)
                            and sum(
                                n.startswith("ec_sub_write@")
                                for n in names) >= 4
                            and sum(
                                n.startswith("store_commit@")
                                for n in names) >= 5
                        ):
                            break
                    await asyncio.sleep(0.1)
                assert assembled is not None, "trace never assembled"
                names = _tree_names(assembled["tree"])
                # the tree covers client -> primary -> shards -> store
                assert assembled["tree"]["name"] == "client_op"
                assert assembled["tree"]["daemon"] == "client.4242"
                do_ops = [n for n in names if n.startswith("do_op@")]
                assert len(do_ops) == 1, names
                primary = do_ops[0].split("@", 1)[1]
                # k+m = 5 shards, one local to the primary: >= 4 remote
                # sub-writes, each with a store commit on ANOTHER osd
                sub_writes = [
                    n for n in names if n.startswith("ec_sub_write@")]
                assert len(sub_writes) >= 4, names
                commits = [
                    n.split("@", 1)[1] for n in names
                    if n.startswith("store_commit@")
                ]
                assert len(commits) >= 5, names  # every shard commits
                assert any(d != primary for d in commits)
                assert primary in commits  # the primary's own shard
                # >= 3 daemons participated (client + primary + shards)
                assert len(assembled["daemons"]) >= 4, assembled["daemons"]
                # critical path + per-stage breakdown
                stages = assembled["stages_ms"]
                assert set(stages) == {
                    "net", "queue", "device", "store", "other"}
                assert assembled["duration_ms"] > 0
                path = assembled["critical_path"]
                assert path[0]["name"] == "client_op"
                assert any(p["stage"] == "store" for p in path) or any(
                    p["stage"] == "net" for p in path)
                # device-stage encode span joined the trace
                assert any(n.startswith("ec_encode@") for n in names)

                # the digest carries it to the mon: `ceph trace ls` +
                # `ceph trace show` serve the same assembly
                got = shown = None
                for _ in range(60):
                    code, _rs, data = await c.client.command(
                        {"prefix": "trace ls"})
                    if code == 0 and data:
                        doc = json.loads(data)
                        if any(t["trace_id"] == tid
                               for t in doc.get("traces", [])):
                            got = doc
                            # a digest minted BEFORE the daemon
                            # reports landed lists the trace with only
                            # the client-side spans — keep polling
                            # until the mon serves a tree assembled
                            # from the full span set (the next digest
                            # tick carries it)
                            code, rs, data = await c.client.command(
                                {"prefix": "trace show",
                                 "trace_id": str(tid)})
                            if code == 0:
                                cand = json.loads(data)
                                if any(
                                    n.startswith("ec_sub_write@")
                                    for n in _tree_names(cand["tree"])
                                ):
                                    shown = cand
                                    break
                    await asyncio.sleep(0.2)
                assert got is not None, "trace never reached the mon"
                assert shown is not None, (
                    "mon digest never grew the daemon spans")
                assert shown["trace_id"] == tid
                assert shown["stages_ms"]
                assert shown["critical_path"]
                rendered = "\n".join(shown["rendered"])
                assert "client_op" in rendered
                assert "ec_sub_write" in rendered
                assert "store_commit" in rendered

        run(go())

    def test_device_launch_spans_carry_bucket_tags(self):
        """Device-launch profiling: a decode-batcher launch records an
        cuda_launch span tagged with bucket shape + occupancy + the
        block-until-ready duration (the batched-vs-host forensics)."""

        async def go():
            import numpy as np

            from ceph_tpu_torch.common.tracing import device_tracer
            from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator

            agg = DecodeAggregator(window_s=0.001, device="cpu")
            D = np.eye(2, dtype=np.uint8)
            rows = np.arange(2 * 100, dtype=np.uint8).reshape(2, 100)
            out = await agg.apply(D, rows)
            assert out.shape == (2, 100)
            spans = [
                s for s in device_tracer().find(kind="decode_batch")
                if s.name == "cuda_launch"
            ]
            assert spans, "no device-launch span recorded"
            sp = spans[-1]
            assert sp.tags["w"] >= 100
            assert sp.tags["b"] >= 1
            assert 0.0 < sp.tags["occupancy"] <= 1.0
            assert sp.tags["stage"] == "device"
            assert sp.duration is not None

        run(go())
