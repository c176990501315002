"""Session → owner mapping: a versioned table of contiguous hash ranges,
as ``fmda_tpu.fleet.hashring`` derives it.

The session space is a fixed hash ring of ``space`` points; every live
worker owns one **contiguous** slot-range of it (equal shares, remainder
spread one point at a time over the first workers).  Contiguous ranges —
rather than consistent-hashing's scattered virtual nodes — keep the
table tiny (one ``(worker, lo, hi)`` row per worker), make "which
sessions move on membership change" a range intersection, and mirror how
the in-process :class:`~fmda_tpu_torch.runtime.session_pool.SessionPool`
shards its slot axis across chips: the fleet is the same idea one level
up, processes instead of devices (PAPERS.md, pjit mesh topology).

Hashing is :func:`zlib.crc32` — stable across processes and Python
runs (``hash()`` is per-process salted, which would route the same
session to different owners from different processes).

The table is **versioned**: the router bumps the version on every
membership change and announces the new table on the control topic, so
a worker (or an operator reading ``status``) can tell a stale
announcement from the current one.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

#: Default hash-ring size (FleetTopologyConfig.hash_space).
DEFAULT_HASH_SPACE = 1 << 16


def hash_session(session_id: str, space: int = DEFAULT_HASH_SPACE) -> int:
    """Deterministic session hash in ``[0, space)`` — identical from
    every process, every run."""
    return zlib.crc32(session_id.encode("utf-8")) % space


@dataclass(frozen=True)
class OwnershipTable:
    """One immutable version of the session-space partition."""

    version: int
    #: ``(worker_id, lo, hi)`` half-open ranges, ascending, disjoint,
    #: covering ``[0, space)`` exactly (empty when no workers live).
    ranges: Tuple[Tuple[str, int, int], ...]
    space: int = DEFAULT_HASH_SPACE

    @classmethod
    def derive(
        cls, version: int, worker_ids: Sequence[str],
        space: int = DEFAULT_HASH_SPACE,
    ) -> "OwnershipTable":
        """Equal contiguous shares over the sorted live workers.  Sorting
        makes the table a pure function of the membership set — every
        observer derives the same partition from the same workers."""
        workers = sorted(set(worker_ids))
        if not workers:
            return cls(version, (), space)
        n = len(workers)
        share, rem = divmod(space, n)
        ranges = []
        lo = 0
        for i, wid in enumerate(workers):
            hi = lo + share + (1 if i < rem else 0)
            ranges.append((wid, lo, hi))
            lo = hi
        return cls(version, tuple(ranges), space)

    def owner_of_point(self, point: int) -> Optional[str]:
        for wid, lo, hi in self.ranges:
            if lo <= point < hi:
                return wid
        return None

    def owner_of(self, session_id: str) -> Optional[str]:
        """The live owner of a session, or None when no workers exist."""
        if not self.ranges:
            return None
        return self.owner_of_point(hash_session(session_id, self.space))

    @property
    def workers(self) -> Tuple[str, ...]:
        return tuple(w for w, _, _ in self.ranges)

    # -- wire form (control-topic announcements) ----------------------------

    def to_wire(self) -> dict:
        return {
            "version": self.version,
            "space": self.space,
            "ranges": [list(r) for r in self.ranges],
        }

    @classmethod
    def from_wire(cls, msg: dict) -> "OwnershipTable":
        return cls(
            int(msg["version"]),
            tuple((str(w), int(lo), int(hi)) for w, lo, hi in msg["ranges"]),
            int(msg.get("space", DEFAULT_HASH_SPACE)),
        )
