"""Capability grammar + checks — the MonCap/OSDCap twin.

The reference parses per-service capability strings
("allow rw pool=foo, allow r") with boost::spirit (src/osd/OSDCap.cc
grammar at :608, src/mon/MonCap.cc) and answers is_capable() at op
admission (PrimaryLogPG::do_op caps check, Monitor::_allowed_command).
Same surface here over the subset that matters: ``allow`` grants with
r/w/x/* permission letters, an optional ``pool=<name>`` qualifier
(OSDCap's match clause reduced to pools), and ``profile <name>``
mapped to the daemon profiles (full access) the reference expands.

A request is allowed when ONE grant covers every needed permission in
the matching scope — two separate ``allow r`` + ``allow w`` grants do
NOT combine into rw for a single op, exactly like the reference's
per-grant matching.
"""

from __future__ import annotations

from dataclasses import dataclass

ALL = frozenset("rwx")

# daemon profiles the reference expands to broad access
# (src/mon/MonCap.cc MonCap::parse profile handling)
_PROFILES = {"osd", "mds", "mon", "mgr", "admin"}


class CapsError(ValueError):
    pass


@dataclass(frozen=True)
class Grant:
    perms: frozenset
    pool: str | None = None  # None = any pool

    def covers(self, need: frozenset, pool: str | None) -> bool:
        if self.pool is not None and pool != self.pool:
            return False
        return need <= self.perms


def parse(capstr: str) -> list[Grant]:
    """'allow rw pool=foo, allow r' -> [Grant...].  Raises CapsError
    on anything the grammar doesn't cover."""
    grants: list[Grant] = []
    for clause in capstr.split(","):
        toks = clause.split()
        if not toks:
            continue
        if toks[0] != "allow":
            raise CapsError(f"expected 'allow': {clause!r}")
        if len(toks) < 2:
            raise CapsError(f"empty grant: {clause!r}")
        perms: frozenset | None = None
        pool: str | None = None
        rest = toks[1:]
        if rest[0] == "profile":
            if len(rest) < 2 or rest[1] not in _PROFILES:
                raise CapsError(f"unknown profile: {clause!r}")
            perms = ALL
            rest = rest[2:]
        elif rest[0] == "*":
            perms = ALL
            rest = rest[1:]
        else:
            letters = rest[0]
            if not letters or set(letters) - set("rwx"):
                raise CapsError(f"bad perms {letters!r}")
            perms = frozenset(letters)
            rest = rest[1:]
        for tok in rest:
            if tok.startswith("pool="):
                pool = tok[len("pool="):]
                if not pool:
                    raise CapsError(f"empty pool name: {clause!r}")
            else:
                raise CapsError(f"unknown qualifier {tok!r}")
        grants.append(Grant(perms, pool))
    if not grants:
        raise CapsError("no grants")
    return grants


def capable(
    caps: dict[str, str] | None, service: str, need: str,
    pool: str | None = None,
) -> bool:
    """caps = {"mon": "allow r", "osd": "allow rw pool=x"}; None means
    auth is off (everything allowed — the reference's cephx=none)."""
    if caps is None:
        return True
    capstr = caps.get(service)
    if not capstr:
        return False
    needset = frozenset(need)
    try:
        grants = parse(capstr)
    except CapsError:
        return False
    return any(g.covers(needset, pool) for g in grants)


def validate(caps: dict[str, str]) -> None:
    """Raise CapsError unless every service's capstr parses."""
    for service, capstr in caps.items():
        if service not in ("mon", "osd", "mds", "mgr"):
            raise CapsError(f"unknown service {service!r}")
        parse(capstr)


ADMIN_CAPS = {"mon": "allow *", "osd": "allow *", "mds": "allow *"}
