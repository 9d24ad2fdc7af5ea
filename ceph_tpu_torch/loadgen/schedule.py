"""Seeded deterministic load-trace generation.

The WHOLE load schedule — which simulated client issues which op on
which object at which instant — is generated up front as a pure
function of ``(seed, profile)``, the ``chaos/schedule.py`` discipline
(no wall clock, no shared ``random`` state, no unordered iteration;
the det-* ctlint rules gate this file):

- **Zipf object popularity**: each op kind draws its object from a
  Zipf(s) distribution over the kind's namespace — the hot-object
  skew real multi-tenant traffic shows (and the small-random-write
  EC study's workload shape, PAPERS.md arXiv 1709.05365).
- **Open-loop arrivals**: every client's op times are exponential
  inter-arrivals at the profile rate, fixed IN THE TRACE — an op's
  submission time never depends on its predecessor's completion, so
  a slow cluster accumulates queueing (the latency the harness is
  there to measure) instead of silently throttling the workload.
- **Tenant classes**: clients are partitioned into dmclock classes
  by the profile's share table; the tag rides each op
  (``MOSDOp.qos_class``) into the OSD's mClock gate.

The runner merely replays the trace; :func:`trace_hash` commits its
sha256 into the artifact and CI re-derives it.

Counterpart of ``ceph_tpu/loadgen/schedule.py``: the same traces and trace hashes.
"""

from __future__ import annotations

# ctlint: pure-trace

import bisect
import hashlib
import json
import random
from dataclasses import dataclass, field

#: every op kind a load trace may emit, by traffic plane
OP_KINDS = (
    "rados_write",   # replicated pool, whole-object write
    "rados_read",    # replicated pool read
    "ec_write",      # EC pool small write at a random offset (RMW)
    "ec_read",       # EC pool ranged read
    "s3_put",        # S3 PutObject over the RGW HTTP frontend
    "s3_get",        # S3 GetObject
    "rbd_write",     # ranged write into a shared RBD image
    "rbd_read",      # ranged read from a shared RBD image
    "fs_write",      # CephFS file write (MDS caps + striped data)
    "fs_read",       # CephFS file read
)

#: built-in load profiles (the qa-suite role).  Plain dicts so CLI
#: users can ship their own as JSON.  ``clients``/``ops_per_client``
#: are defaults the CLI may override (resolve_profile) — the trace is
#: pure in (seed, RESOLVED profile).
PROFILES: dict[str, dict] = {
    # the all-planes profile: RADOS read/write + EC RMW + S3 + RBD +
    # FS, Zipf-skewed, two tenant classes with 10x mClock weight gap
    "mixed": {
        "name": "mixed",
        "clients": 200,
        "ops_per_client": 10,
        "arrival_rate": 4.0,     # ops/s per client (open loop)
        "start_spread": 2.0,     # client start offsets spread (s)
        "zipf_objects": 128,     # namespace size per op kind
        "zipf_s": 1.1,
        "object_size": 8192,
        "small_sizes": (512, 1024, 2048, 4096),
        "streams": {
            "rados_write": 3.0, "rados_read": 4.0,
            "ec_write": 2.0, "ec_read": 2.0,
            "s3_put": 0.6, "s3_get": 0.9,
            "rbd_write": 0.8, "rbd_read": 0.8,
            "fs_write": 0.4, "fs_read": 0.6,
        },
        "tenants": {"gold": 0.25, "bronze": 0.75},
        "n_osds": 5,
        "rbd_images": 4,
        "fs_files": 16,
        "s3_objects": 48,
    },
    # the RMW-heavy small-random-write EC profile: the SSD-array
    # online-EC study's workload made first-class — sub-stripe writes
    # at random offsets force read-modify-write on every op
    "rmw_ec": {
        "name": "rmw_ec",
        "clients": 200,
        "ops_per_client": 10,
        "arrival_rate": 4.0,
        "start_spread": 2.0,
        "zipf_objects": 96,
        "zipf_s": 1.2,
        "object_size": 65536,    # stripes span shards; writes don't
        "small_sizes": (512, 1024, 2048),
        "streams": {"ec_write": 8.0, "ec_read": 2.0},
        "tenants": {"gold": 0.5, "bronze": 0.5},
        "n_osds": 5,
    },
    # the chaos-composition smoke: a small RADOS + EC-RMW mix sized
    # so one (scenario, seed) chaos run can replay it THROUGH a
    # thrash trace (tools.chaos_run --profile / the compose_load
    # scenario) without dominating the sweep's wall clock
    "compose_smoke": {
        "name": "compose_smoke",
        "clients": 40,
        "ops_per_client": 5,
        "arrival_rate": 4.0,
        "start_spread": 1.0,
        "zipf_objects": 32,
        "zipf_s": 1.1,
        "object_size": 8192,
        "small_sizes": (512, 1024, 2048),
        "streams": {"rados_write": 3.0, "rados_read": 4.0,
                    "ec_write": 1.5, "ec_read": 1.5},
        "tenants": {"gold": 0.5, "bronze": 0.5},
        "n_osds": 4,
    },
    # pure RADOS closed-namespace mix — the cheap smoke profile
    "rados_rw": {
        "name": "rados_rw",
        "clients": 100,
        "ops_per_client": 8,
        "arrival_rate": 5.0,
        "start_spread": 1.0,
        "zipf_objects": 64,
        "zipf_s": 1.1,
        "object_size": 4096,
        "small_sizes": (512, 1024),
        "streams": {"rados_write": 4.0, "rados_read": 6.0},
        "tenants": {"gold": 0.5, "bronze": 0.5},
        "n_osds": 4,
    },
}


@dataclass(frozen=True)
class LoadOp:
    """One scheduled client op.  ``t`` is the virtual submission time
    (seconds from run start; the runner scales it), ``client`` the
    simulated client index, ``obj`` the kind-namespace object index."""

    t: float
    client: int
    tenant: str
    kind: str
    obj: int
    off: int = 0
    size: int = 0
    args: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "t": self.t, "client": self.client, "tenant": self.tenant,
            "kind": self.kind, "obj": self.obj, "off": self.off,
            "size": self.size,
        }
        if self.args:
            out["args"] = dict(self.args)
        return out


def trace_hash(ops: list[LoadOp]) -> str:
    """Canonical sha256 over the trace — committed into the LOAD
    artifact; CI re-derives it from (seed, profile) bit-identically."""
    blob = json.dumps(
        [o.to_json() for o in ops], sort_keys=True,
        separators=(",", ":"),
    ).encode()
    return hashlib.sha256(blob).hexdigest()


def resolve_profile(profile: str | dict, clients: int | None = None,
                    ops_per_client: int | None = None) -> dict:
    """Materialize a profile (by name or literal dict) with CLI
    overrides applied.  The RESULT is what feeds generate_load — the
    trace stays pure in (seed, resolved profile)."""
    p = dict(PROFILES[profile] if isinstance(profile, str) else profile)
    if clients is not None:
        p["clients"] = int(clients)
    if ops_per_client is not None:
        p["ops_per_client"] = int(ops_per_client)
    unknown = [k for k in p.get("streams", {}) if k not in OP_KINDS]
    if unknown:
        raise ValueError(f"unknown op kinds in profile: {unknown}")
    return p


def zipf_cdf(n: int, s: float) -> list[float]:
    """Cumulative Zipf(s) weights over ranks 1..n (generalized
    harmonic prefix sums) — the inverse-CDF sampler's table."""
    cum: list[float] = []
    total = 0.0
    for i in range(1, n + 1):
        total += 1.0 / (i ** s)
        cum.append(total)
    return cum


def zipf_draw(rng: random.Random, cum: list[float]) -> int:
    """One Zipf rank (0-based: 0 is the hottest object) by inverse
    CDF over a seeded rng — pure in the rng state."""
    x = rng.random() * cum[-1]
    return min(bisect.bisect_left(cum, x), len(cum) - 1)


def _tenant_of(client: int, n_clients: int, tenants: dict) -> str:
    """Deterministic tenant partition by client index: the first
    share-fraction of clients are the first tenant, and so on (dict
    order is insertion order — stable in the profile literal)."""
    acc = 0.0
    last = "client"
    for name, share in tenants.items():
        acc += share
        last = name
        if client < int(round(acc * n_clients)):
            return name
    return last


def generate_load(seed: int, profile: dict) -> list[LoadOp]:
    """The whole trace, sorted by submission time.  Pure in (seed,
    profile): same inputs, bit-identical trace (and hash), forever."""
    rng = random.Random(f"ceph_tpu.loadgen:{profile['name']}:{seed}")
    n_clients = int(profile["clients"])
    ops_per_client = int(profile["ops_per_client"])
    rate = float(profile["arrival_rate"])
    spread = float(profile.get("start_spread", 1.0))
    streams = profile["streams"]
    kinds = list(streams.keys())
    weights = [float(streams[k]) for k in kinds]
    cum = zipf_cdf(int(profile["zipf_objects"]),
                   float(profile["zipf_s"]))
    obj_size = int(profile["object_size"])
    small = tuple(profile.get("small_sizes", (1024,)))
    tenants = profile.get("tenants", {"client": 1.0})
    # per-kind namespace caps (S3/RBD/FS planes are smaller)
    ns_cap = {
        "s3_put": int(profile.get("s3_objects", 32)),
        "s3_get": int(profile.get("s3_objects", 32)),
        "rbd_write": int(profile.get("rbd_images", 4)),
        "rbd_read": int(profile.get("rbd_images", 4)),
        "fs_write": int(profile.get("fs_files", 16)),
        "fs_read": int(profile.get("fs_files", 16)),
    }
    ops: list[LoadOp] = []
    for c in range(n_clients):
        tenant = _tenant_of(c, n_clients, tenants)
        t = rng.random() * spread
        for _ in range(ops_per_client):
            t += rng.expovariate(rate)
            kind = rng.choices(kinds, weights=weights)[0]
            obj = zipf_draw(rng, cum)
            cap = ns_cap.get(kind)
            if cap is not None:
                obj %= max(cap, 1)
            off, size = 0, obj_size
            if kind == "ec_write":
                # sub-stripe write at a random in-object offset: the
                # RMW path (read surviving stripe + re-encode)
                size = rng.choice(small)
                off = rng.randrange(
                    0, max(obj_size - size, 1))
            elif kind in ("ec_read", "rbd_read", "rbd_write",
                          "fs_read", "fs_write"):
                size = rng.choice(small)
                off = rng.randrange(0, max(obj_size - size, 1))
            elif kind in ("s3_put", "s3_get"):
                size = rng.choice(small)
                off = 0
            ops.append(LoadOp(
                t=round(t, 6), client=c, tenant=tenant, kind=kind,
                obj=obj, off=off, size=size,
            ))
    ops.sort(key=lambda o: (o.t, o.client))
    return ops
