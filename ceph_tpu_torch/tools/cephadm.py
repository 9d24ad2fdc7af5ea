"""cephadm-lite: multi-process cluster deployment + daemon lifecycle.

Twin of the JAX package's ``tools/cephadm.py``, run as ``python -m
ceph_tpu_torch.tools.cephadm``.

The orchestration role of the reference's cephadm
(src/cephadm/cephadm.py): `bootstrap` brings up a real cluster of
SEPARATE OS PROCESSES (monitors on fixed ports, OSDs on durable
stores, optional dashboard), records the deployment spec + per-daemon
pidfiles under the cluster directory, and the usual lifecycle verbs
manage it afterwards — where cephadm drives containers/systemd units,
this drives host processes; the spec/pidfile/ls/daemon-add model is
the same.

    python -m ceph_tpu_torch.tools.cephadm bootstrap --data /tmp/clus --osds 4
    python -m ceph_tpu_torch.tools.cephadm ls        --data /tmp/clus
    python -m ceph_tpu_torch.tools.cephadm add-osd   --data /tmp/clus
    python -m ceph_tpu_torch.tools.cephadm restart   --data /tmp/clus osd.2
    python -m ceph_tpu_torch.tools.cephadm stop      --data /tmp/clus

The printed mon spec works directly with the CLI:
    python -m ceph_tpu_torch.tools.ceph -m 127.0.0.1:PORT status

Every daemon process runs on the device that ``bootstrap --device`` named
(default ``cuda``; ``cpu`` runs the cluster on the host), recorded in the
spec so that ``add-osd`` and ``restart`` start theirs on it too; a daemon
asked for the card on a machine without one raises and exits.  A process
that has exited but is not yet reaped counts as down.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys
import time

from ceph_tpu_torch.tools import child_env

SPEC = "cluster_spec.json"


def _spec_path(data: str) -> str:
    return os.path.join(data, SPEC)


def _load_spec(data: str) -> dict:
    with open(_spec_path(data)) as f:
        return json.load(f)


def _save_spec(data: str, spec: dict) -> None:
    with open(_spec_path(data), "w") as f:
        json.dump(spec, f, indent=2)


def _pidfile(data: str, name: str) -> str:
    return os.path.join(data, f"{name}.pid")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            # the state follows the parenthesised command name
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def _runs_daemon(pid: int, data: str, name: str) -> bool:
    """Whether ``pid`` runs daemon ``name`` of the cluster at ``data``.  A
    pid file outlives its daemon, and once the daemon is reaped the kernel
    may give its pid to any other process: that one must not be listed,
    stopped or restarted as the daemon."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().decode(errors="replace").split("\0")
    except OSError:
        return False  # gone since
    kind, _, ident = name.partition(".")
    flag = "--osd-id" if kind == "osd" else "--rank"
    try:
        at = argv.index("_daemon")
        return (argv[at + 1] == kind and argv[argv.index(flag) + 1] == ident
                and os.path.realpath(argv[argv.index("--data") + 1])
                == os.path.realpath(data))
    except (ValueError, IndexError):
        return False


def _daemon_pid(data: str, name: str) -> int | None:
    try:
        with open(_pidfile(data, name)) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    return pid if _alive(pid) and _runs_daemon(pid, data, name) else None


def _spawn(data: str, name: str, argv: list[str]) -> int:
    log_path = os.path.join(data, f"{name}.log")
    with open(log_path, "ab") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.tools.cephadm", "_daemon"] + argv,
            stdout=logf, stderr=logf,
            start_new_session=True,  # survives the cephadm process
            env=child_env(),
        )
    with open(_pidfile(data, name), "w") as f:
        f.write(str(proc.pid))
    return proc.pid


# -- the in-process daemon runner (child processes land here) ---------------

async def _run_daemon(args) -> None:
    import logging

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True,
    )
    from ceph_tpu_torch.common import ConfigProxy
    from ceph_tpu_torch.tools import resolve_device

    device = resolve_device(args.device)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)

    def _store(name: str):
        kind = args.store
        path = os.path.join(args.data, name)
        if kind == "kstore":
            from ceph_tpu_torch.kv import FileDB
            from ceph_tpu_torch.store.kstore import KStore

            s = KStore(FileDB(path))
        elif kind == "block":
            from ceph_tpu_torch.store.blockstore import BlockStore

            s = BlockStore(path)
        else:
            from ceph_tpu_torch.store.filestore import FileStore

            s = FileStore(path)
        s.mount()
        return s

    conf = ConfigProxy({
        "admin_socket": os.path.join(args.data, "$id.asok"),
    })
    if args.kind == "mon":
        from ceph_tpu_torch.crush import builder as B
        from ceph_tpu_torch.crush.types import CrushMap
        from ceph_tpu_torch.mon import Monitor

        crush = CrushMap()
        B.build_hierarchy(
            crush, osds_per_host=1, n_hosts=max(args.initial_osds, 1))
        mon = Monitor(
            crush=crush, rank=args.rank, n_mons=args.n_mons,
            beacon_grace=4.0, store=_store(f"mon{args.rank}"), conf=conf,
            device=device,
        )
        await mon.start(port=args.port)
        monmap = [
            ("127.0.0.1", p) for p in args.mon_ports
        ]
        await mon.open_quorum(monmap)
        dash = None
        if args.dashboard_port and args.rank == 0:
            from ceph_tpu_torch.mgr.dashboard import Dashboard

            dash = Dashboard(mon)
            await dash.start(port=args.dashboard_port)
        await stop.wait()
        if dash:
            await dash.stop()
        await mon.stop()
    else:
        from ceph_tpu_torch.osd.daemon import OSDDaemon

        monmap = [("127.0.0.1", p) for p in args.mon_ports]
        osd = OSDDaemon(
            args.osd_id, monmap, store=_store(f"osd{args.osd_id}"),
            conf=conf, device=device,
        )
        await osd.start()
        await stop.wait()
        await osd.stop()


def _daemon_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=("mon", "osd"))
    ap.add_argument("--data", required=True)
    ap.add_argument("--store", default="file")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--n-mons", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--mon-ports", type=lambda s: [int(x) for x in s.split(",")],
                    default=[])
    ap.add_argument("--osd-id", type=int, default=0)
    ap.add_argument("--initial-osds", type=int, default=1)
    ap.add_argument("--dashboard-port", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    asyncio.run(_run_daemon(args))
    return 0


# -- orchestration verbs ----------------------------------------------------

def _free_ports(n: int) -> list[int]:
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def cmd_bootstrap(args) -> int:
    from ceph_tpu_torch.tools import resolve_device

    resolve_device(args.device)  # no card where one is asked for: raise here
    os.makedirs(args.data, exist_ok=True)
    if os.path.exists(_spec_path(args.data)):
        print(f"cluster already bootstrapped in {args.data}", file=sys.stderr)
        return 1
    mon_ports = _free_ports(args.mons)
    dash_port = _free_ports(1)[0] if args.dashboard else 0
    spec = {
        "store": args.store,
        "mon_ports": mon_ports,
        "dashboard_port": dash_port,
        "mons": args.mons,
        "osds": list(range(args.osds)),
        "initial_osds": args.osds,
        "device": args.device,
    }
    _save_spec(args.data, spec)
    for r in range(args.mons):
        _spawn_mon(args.data, spec, r)
    time.sleep(1.0)  # quorum before the osds dial in
    for i in range(args.osds):
        _spawn_osd(args.data, spec, i)
    monspec = ",".join(f"127.0.0.1:{p}" for p in mon_ports)
    print(f"bootstrapped: mons at {monspec}")
    if dash_port:
        print(f"dashboard:   http://127.0.0.1:{dash_port}/")
    print(f"try:         python -m ceph_tpu_torch.tools.ceph -m {monspec} status")
    return 0


def _spawn_osd(data: str, spec: dict, osd_id: int) -> None:
    _spawn(data, f"osd.{osd_id}", [
        "osd", "--data", data, "--store", spec["store"],
        "--osd-id", str(osd_id),
        "--mon-ports", ",".join(map(str, spec["mon_ports"])),
        "--device", spec["device"],
    ])


def _spawn_mon(data: str, spec: dict, rank: int) -> None:
    _spawn(data, f"mon.{rank}", [
        "mon", "--data", data, "--store", spec["store"],
        "--rank", str(rank), "--n-mons", str(spec["mons"]),
        "--port", str(spec["mon_ports"][rank]),
        "--mon-ports", ",".join(map(str, spec["mon_ports"])),
        "--initial-osds", str(spec.get("initial_osds", 1)),
        "--dashboard-port", str(spec.get("dashboard_port", 0)),
        "--device", spec["device"],
    ])


def cmd_ls(args) -> int:
    spec = _load_spec(args.data)
    rows = []
    for r in range(spec["mons"]):
        rows.append(("mon." + str(r), _daemon_pid(args.data, f"mon.{r}")))
    for i in spec["osds"]:
        rows.append((f"osd.{i}", _daemon_pid(args.data, f"osd.{i}")))
    for name, pid in rows:
        state = f"up pid={pid}" if pid else "down"
        print(f"{name:10s} {state}")
    return 0


def cmd_add_osd(args) -> int:
    spec = _load_spec(args.data)
    new_id = max(spec["osds"], default=-1) + 1
    spec["osds"].append(new_id)
    _save_spec(args.data, spec)
    _spawn_osd(args.data, spec, new_id)
    # CRUSH placement (ceph-volume's create-or-move step): the
    # hierarchy was built at bootstrap for the initial osds only — a
    # daemon that boots without a CRUSH location is up but can never
    # be selected for data.  The daemon must register in the map
    # first ('osd crush add' validates the id exists).
    asyncio.run(_crush_place(spec, new_id))
    print(f"added osd.{new_id} (crush host host{new_id})")
    return 0


async def _crush_place(spec: dict, osd_id: int) -> None:
    from ceph_tpu_torch.client import RadosClient

    cl = RadosClient(client_id=990000 + osd_id)
    await cl.connect_multi([("127.0.0.1", p) for p in spec["mon_ports"]])
    try:
        deadline = time.time() + 60
        while True:
            om = cl.osdmap
            if om is not None and om.exists(osd_id):
                break
            if time.time() > deadline:
                raise RuntimeError(
                    f"osd.{osd_id} never registered in the map")
            await cl._wait_new_map(om.epoch if om else 0, timeout=2)
        host = f"host{osd_id}"
        code, rs, _ = await cl.command({
            "prefix": "osd crush add-bucket", "name": host,
            "type": "host"})
        if code != 0:
            raise RuntimeError(f"crush add-bucket: {rs}")
        code, rs, _ = await cl.command({
            "prefix": "osd crush move", "name": host,
            "loc": "root=default"})
        if code != 0:
            raise RuntimeError(f"crush move: {rs}")
        code, rs, _ = await cl.command({
            "prefix": "osd crush add", "name": f"osd.{osd_id}",
            "weight": "1.0", "loc": f"host={host}"})
        if code != 0:
            raise RuntimeError(f"crush add: {rs}")
    finally:
        await cl.shutdown()


def cmd_restart(args) -> int:
    spec = _load_spec(args.data)
    name = args.daemon
    pid = _daemon_pid(args.data, name)
    if pid:
        os.kill(pid, signal.SIGTERM)
        for _ in range(50):
            if not _alive(pid):
                break
            time.sleep(0.1)
    kind, _, ident = name.partition(".")
    if kind == "osd":
        _spawn_osd(args.data, spec, int(ident))
    else:
        _spawn_mon(args.data, spec, int(ident))
    print(f"restarted {name}")
    return 0


def cmd_stop(args) -> int:
    spec = _load_spec(args.data)
    names = [f"mon.{r}" for r in range(spec["mons"])] + [
        f"osd.{i}" for i in spec["osds"]
    ]
    for name in names:
        pid = _daemon_pid(args.data, name)
        if pid:
            os.kill(pid, signal.SIGTERM)
    deadline = time.time() + 10
    for name in names:
        while time.time() < deadline:
            if _daemon_pid(args.data, name) is None:
                break
            time.sleep(0.1)
    print("stopped")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "_daemon":
        return _daemon_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="verb", required=True)
    b = sub.add_parser("bootstrap")
    b.add_argument("--data", required=True)
    b.add_argument("--mons", type=int, default=1)
    b.add_argument("--osds", type=int, default=4)
    b.add_argument("--store", choices=("file", "kstore", "block"),
                   default="file")
    b.add_argument("--dashboard", action="store_true")
    b.add_argument("--device", default="cuda",
                   help="every daemon's device (default cuda; cpu runs on the host)")
    b.set_defaults(fn=cmd_bootstrap)
    for verb, fn in (("ls", cmd_ls), ("add-osd", cmd_add_osd),
                     ("stop", cmd_stop)):
        p = sub.add_parser(verb)
        p.add_argument("--data", required=True)
        p.set_defaults(fn=fn)
    r = sub.add_parser("restart")
    r.add_argument("--data", required=True)
    r.add_argument("daemon")
    r.set_defaults(fn=cmd_restart)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
