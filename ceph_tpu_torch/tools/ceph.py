"""ceph: the cluster admin CLI.

Twin of the JAX package's ``tools/ceph.py`` (the reference's `ceph`
command, src/ceph.in) for the mini-cluster's command surface, run as
``python -m ceph_tpu_torch.tools.ceph``:

  ceph -m HOST:PORT status
  ceph -m HOST:PORT osd pool create NAME [--pg-num N] [--size N]
          [--pool-type erasure --erasure-code-profile P]
  ceph -m HOST:PORT osd erasure-code-profile set NAME k=K m=M plugin=cuda
  ceph -m HOST:PORT osd down ID | osd out ID
  ceph -m HOST:PORT osd balance [--max-swaps N]
  ceph -m HOST:PORT osd perf
  ceph -m HOST:PORT pg scrub PGID | pg deep-scrub PGID
  ceph -m HOST:PORT df
  ceph -m HOST:PORT mgr dump | mgr stat | mgr digest | mgr fail [NAME]
  ceph -m HOST:PORT mgr module ls | mgr module enable NAME
          | mgr module disable NAME
  ceph -m HOST:PORT trace ls | trace show TRACE_ID
  ceph -m HOST:PORT log last [N]
  ceph -m HOST:PORT -w              # follow the cluster log
  ceph -m HOST:PORT progress
  ceph -m HOST:PORT health history | health mute CODE [TTL]
          | health unmute CODE
  ceph -m HOST:PORT crash ls | crash info ID | crash archive ID
          | crash archive-all

Multiple monitors: -m accepts a comma-separated monmap.  The follow
mode (`-w`) polls the mon's replicated log with a cursor, so it rides
through a mon failover (reconnect + resume at the cursor).

The CLI is a RADOS client: it computes nothing and touches no device.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def parse_addrs(spec: str) -> list[tuple[str, int]]:
    out = []
    for part in spec.split(","):
        host, _, port = part.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def _progress_bar(ev: dict, width: int = 24) -> str:
    frac = float(ev.get("fraction") or 0.0)
    filled = int(frac * width)
    bar = "=" * filled + ">" * (1 if filled < width else 0)
    eta = ev.get("eta_s")
    eta_s = f"  ETA {eta:g}s" if eta not in (None, 0.0) else ""
    return (f"  [{bar:<{width}}] {frac * 100:5.1f}%  "
            f"{ev.get('message', ev.get('id', ''))}{eta_s}")


async def _watch_log(client, channel: str = "") -> int:
    """`ceph -w`: follow the replicated cluster log via the mon-side
    cursor; mon failover only pauses the stream (the client re-homes
    and the cursor resumes on whichever mon answers)."""
    from ceph_tpu_torch.common.logclient import format_entry

    cursor = 0
    first = True
    while True:
        cmd = {"prefix": "log last", "n": "20" if first else "0",
               "since": "0" if first else str(cursor)}
        if channel:
            cmd["channel"] = channel
        try:
            code, _rs, data = await client.command(cmd)
        except (OSError, ConnectionError):
            await asyncio.sleep(0.5)
            continue
        if code == 0 and data:
            doc = json.loads(data)
            for e in doc.get("entries", []):
                print(format_entry(e), flush=True)
            cursor = max(cursor, int(doc.get("cursor", 0)))
            first = False
        await asyncio.sleep(0.5)


async def amain(args, extra: list[str]) -> int:
    from ceph_tpu_torch.client import RadosClient

    client = RadosClient()
    await client.connect_multi(parse_addrs(args.mon))
    try:
        verb = args.cmd
        if args.watch:
            return await _watch_log(
                client, channel=getattr(args, "channel", ""))
        if verb == "status":
            code, rs, data = await client.command({"prefix": "status"})
            if code == 0 and data:
                doc = json.loads(data)
                print(json.dumps(doc, indent=2))
                # the human block — mgr progress bars + the last 5
                # cluster-log lines (the `ceph -s` tail) — goes to
                # stderr so stdout stays machine-parseable JSON
                events = (doc.get("progress") or {}).get("events", [])
                if events:
                    print("\nprogress:", file=sys.stderr)
                    for ev in events:
                        print(_progress_bar(ev), file=sys.stderr)
                lcode, _lrs, ldata = await client.command(
                    {"prefix": "log last", "n": "5"})
                if lcode == 0 and ldata:
                    from ceph_tpu_torch.common.logclient import format_entry

                    entries = json.loads(ldata).get("entries", [])
                    if entries:
                        print("\nrecent cluster log:", file=sys.stderr)
                        for e in entries:
                            print("  " + format_entry(e),
                                  file=sys.stderr)
                if rs:
                    print(rs, file=sys.stderr)
                return 0
        elif verb == "df":
            om = client.osdmap
            data = json.dumps({
                "epoch": om.epoch,
                "pools": {
                    om.pool_names.get(pid, str(pid)): {
                        "id": pid, "pg_num": p.pg_num, "size": p.size,
                        "type": "erasure" if p.is_erasure() else "replicated",
                    }
                    for pid, p in sorted(om.pools.items())
                },
            }).encode()
            code, rs = 0, ""
        elif verb == "osd" and extra[:1] == ["perf"]:
            code, rs, data = await client.command({"prefix": "osd perf"})
        elif verb == "mgr" and extra[:1] == ["dump"]:
            code, rs, data = await client.command({"prefix": "mgr dump"})
        elif verb == "mgr" and extra[:1] == ["stat"]:
            code, rs, data = await client.command({"prefix": "mgr stat"})
        elif verb == "mgr" and extra[:1] == ["digest"]:
            code, rs, data = await client.command(
                {"prefix": "mgr digest"})
        elif verb == "mgr" and extra[:1] == ["fail"]:
            cmd = {"prefix": "mgr fail"}
            if len(extra) > 1:
                cmd["who"] = extra[1]
            code, rs, data = await client.command(cmd)
        elif verb == "mgr" and extra[:2] == ["module", "ls"]:
            code, rs, data = await client.command(
                {"prefix": "mgr module ls"})
        elif verb == "mgr" and extra[:2] in (
                ["module", "enable"], ["module", "disable"]):
            code, rs, data = await client.command({
                "prefix": f"mgr module {extra[1]}", "module": extra[2]})
        elif verb == "osd" and extra[:1] == ["balance"]:
            cmd = {"prefix": "osd balance"}
            if args.max_swaps:
                cmd["max_swaps"] = str(args.max_swaps)
            code, rs, data = await client.command(cmd)
        elif verb == "osd" and extra[:3][:1] == ["pool"] and extra[1:2] == ["create"]:
            cmd = {
                "prefix": "osd pool create", "name": extra[2],
                "pg_num": str(args.pg_num), "size": str(args.size),
                "pool_type": args.pool_type,
            }
            if args.erasure_code_profile:
                cmd["erasure_code_profile"] = args.erasure_code_profile
            code, rs, data = await client.command(cmd)
        elif verb == "osd" and extra[:3][:2] == ["erasure-code-profile", "set"]:
            profile = " ".join(extra[3:])
            code, rs, data = await client.command({
                "prefix": "osd erasure-code-profile set",
                "name": extra[2], "profile": profile,
            })
        elif verb == "osd" and extra[:1] in (["down"], ["out"]):
            code, rs, data = await client.command({
                "prefix": f"osd {extra[0]}", "id": extra[1],
            })
        elif verb == "pg" and extra[:1] in (["scrub"], ["deep-scrub"], ["repair"]):
            code, rs, data = await client.command({
                "prefix": f"pg {extra[0]}", "pgid": extra[1],
            })
        elif verb == "pg" and extra[:1] == ["stat"]:
            code, rs, data = await client.command({"prefix": "pg stat"})
        elif verb == "health" and extra[:1] == ["history"]:
            code, rs, data = await client.command(
                {"prefix": "health history"})
        elif verb == "health" and extra[:1] == ["mute"]:
            cmd = {"prefix": "health mute", "code": extra[1]}
            if len(extra) > 2:
                cmd["ttl"] = extra[2]
            if args.sticky:
                cmd["sticky"] = "true"
            code, rs, data = await client.command(cmd)
        elif verb == "health" and extra[:1] == ["unmute"]:
            code, rs, data = await client.command(
                {"prefix": "health unmute", "code": extra[1]})
        elif verb == "health":
            code, rs, data = await client.command({"prefix": "health"})
        elif verb == "log" and extra[:1] == ["last"]:
            cmd = {"prefix": "log last"}
            if len(extra) > 1:
                cmd["n"] = extra[1]
            code, rs, data = await client.command(cmd)
            if code == 0 and data:
                from ceph_tpu_torch.common.logclient import format_entry

                for e in json.loads(data).get("entries", []):
                    print(format_entry(e))
                return 0
        elif verb == "progress":
            code, rs, data = await client.command({"prefix": "progress"})
            if code == 0 and data:
                doc = json.loads(data)
                for ev in doc.get("events", []):
                    print(_progress_bar(ev))
                for ev in doc.get("completed", []):
                    print(f"  [done in {ev.get('duration_s', '?')}s] "
                          f"{ev.get('message', ev.get('id', ''))}")
                if not doc.get("events") and not doc.get("completed"):
                    print("(no active progress events)")
                return 0
        elif verb == "crash" and extra[:1] == ["ls"]:
            code, rs, data = await client.command({"prefix": "crash ls"})
            if code == 0 and data:
                doc = json.loads(data)
                for m in doc.get("crashes", []):
                    mark = "  (archived)" if m.get("archived") else ""
                    print(f"{m['crash_id']}  {m.get('entity', '?')}  "
                          f"{m.get('reason', '')[:60]}{mark}")
                print(f"{doc.get('recent', 0)} recent (unarchived)")
                return 0
        elif verb == "crash" and extra[:1] == ["info"]:
            code, rs, data = await client.command(
                {"prefix": "crash info", "id": extra[1]})
        elif verb == "crash" and extra[:1] == ["archive-all"]:
            code, rs, data = await client.command(
                {"prefix": "crash archive-all"})
        elif verb == "crash" and extra[:1] == ["archive"]:
            code, rs, data = await client.command(
                {"prefix": "crash archive", "id": extra[1]})
        elif verb == "trace" and extra[:1] == ["ls"]:
            code, rs, data = await client.command({"prefix": "trace ls"})
        elif verb == "trace" and extra[:1] == ["show"]:
            code, rs, data = await client.command({
                "prefix": "trace show", "trace_id": extra[1]})
            if code == 0 and data:
                # render the span tree human-readable, then the
                # critical-path/stage breakdown as JSON
                doc = json.loads(data)
                for line in doc.get("rendered", []):
                    print(line)
                print(json.dumps({
                    "trace_id": doc.get("trace_id"),
                    "reqid": doc.get("reqid"),
                    "duration_ms": doc.get("duration_ms"),
                    "stages_ms": doc.get("stages_ms"),
                    "critical_path": doc.get("critical_path"),
                }, indent=2))
                return 0
        elif verb == "config" and extra[:1] == ["set"]:
            code, rs, data = await client.command({
                "prefix": "config set", "who": extra[1],
                "name": extra[2], "value": extra[3]})
        elif verb == "config" and extra[:1] == ["get"]:
            cmd = {"prefix": "config get", "who": extra[1]}
            if len(extra) > 2:
                cmd["name"] = extra[2]
            code, rs, data = await client.command(cmd)
        elif verb == "config" and extra[:1] == ["rm"]:
            code, rs, data = await client.command({
                "prefix": "config rm", "who": extra[1], "name": extra[2]})
        elif verb == "config" and extra[:1] == ["dump"]:
            code, rs, data = await client.command({"prefix": "config dump"})
        elif verb == "osd" and extra[:2] == ["pool", "autoscale-status"]:
            code, rs, data = await client.command(
                {"prefix": "osd pool autoscale-status"})
        elif verb == "osd" and extra[:2] == ["crush", "reweight"]:
            code, rs, data = await client.command({
                "prefix": "osd crush reweight", "name": extra[2],
                "weight": extra[3]})
        elif verb == "osd" and extra[:2] == ["crush", "add-bucket"]:
            code, rs, data = await client.command({
                "prefix": "osd crush add-bucket", "name": extra[2],
                "type": extra[3]})
        elif verb == "osd" and extra[:2] == ["crush", "move"]:
            code, rs, data = await client.command({
                "prefix": "osd crush move", "name": extra[2],
                "loc": extra[3]})
        elif verb == "osd" and extra[:2] == ["crush", "add"]:
            code, rs, data = await client.command({
                "prefix": "osd crush add", "name": extra[2],
                "weight": extra[3], "loc": extra[4]})
        elif verb == "osd" and extra[:2] == ["crush", "rm"]:
            code, rs, data = await client.command({
                "prefix": "osd crush rm", "name": extra[2]})
        else:
            print(f"unknown command: {verb} {' '.join(extra)}", file=sys.stderr)
            return 2
        if data:
            try:
                print(json.dumps(json.loads(data), indent=2))
            except ValueError:
                sys.stdout.write(data.decode(errors="replace"))
        if rs:
            print(rs, file=sys.stderr)
        return 0 if code == 0 else 1
    finally:
        await client.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, add_help=True)
    ap.add_argument("-m", "--mon", required=True,
                    help="monitor address(es), host:port[,host:port...]")
    ap.add_argument("--pg-num", type=int, default=8)
    ap.add_argument("--size", type=int, default=3)
    ap.add_argument("--pool-type", default="replicated")
    ap.add_argument("--erasure-code-profile", default="")
    ap.add_argument("--max-swaps", type=int, default=0)
    ap.add_argument("-w", "--watch", action="store_true",
                    help="follow the cluster log (like `ceph -w`)")
    ap.add_argument("--channel", default="",
                    help="with -w: only this log channel "
                    "(cluster/audit)")
    ap.add_argument("--sticky", action="store_true",
                    help="with `health mute`: keep the mute across a "
                    "clear (sticky semantics)")
    ap.add_argument("cmd", nargs="?", default="status")
    ap.add_argument("extra", nargs="*")
    args = ap.parse_args(argv)
    try:
        return asyncio.run(amain(args, args.extra))
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
