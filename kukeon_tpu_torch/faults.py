"""Fault injection for the port: named failure points armed via the
environment, the port's own copy of what training checkpoints need from
``kukeon_tpu/faults.py`` (same variable, same syntax, same exception name).
The port's points are :data:`POINTS`, a subset of the reference's list
(``kukeon_tpu/faults.py:51-68``): ``checkpoint.save`` and
``checkpoint.load`` (training), ``checkpoint.stream`` (a streamed
checkpoint's reader, before each job), ``engine.prefill`` and
``engine.decode`` (the serving engine's dispatches), ``engine.fetch`` (its
blocking readback), ``engine.upload`` (its host-to-device copies, the
streamed boot's too), ``kv.alloc`` (the paged KV allocator),
``kv.handoff`` (the serving cell's KV import), ``cell.http`` (the cell's
generate and KV routes), ``devices.probe_wedged`` (the CUDA runtime probe
reports a wedged runtime), ``profile.capture`` (an on-demand profile fails
to start) and ``profile.layers`` (the per-layer profile, once a shape of
each component).

    from kukeon_tpu_torch import faults
    faults.maybe_fail("checkpoint.save")        # raises iff armed

Arming syntax (``KUKEON_FAULTS`` env var)::

    KUKEON_FAULTS=point:prob[:count][,point2:prob2[:count2]]

``prob`` is the firing probability per hit (``1`` = always); ``count``
caps the total fires of that point. Unarmed (variable unset or empty),
:func:`maybe_fail` is one environment lookup. The parsed table is cached
on the raw string; :func:`reset` drops it and the fire counts, so a test
that arms the same string twice resets in between.
"""

from __future__ import annotations

import os
import random
import threading

ENV = "KUKEON_FAULTS"

# Every point the port threads a maybe_fail through; the guard test greps
# the port's call sites against this list.
POINTS = (
    "engine.prefill",
    "engine.decode",
    "engine.fetch",
    "engine.upload",
    "kv.alloc",
    "kv.handoff",
    "cell.http",
    "checkpoint.save",
    "checkpoint.load",
    "checkpoint.stream",
    "devices.probe_wedged",
    "profile.capture",
    "profile.layers",
)


class FaultInjected(RuntimeError):
    """Raised by an armed fault point (the injected failure)."""


_lock = threading.Lock()
_cached_spec: str | None = None
_points: dict[str, list] = {}            # point -> [prob, remaining fires or None]

# point -> number of times it fired since the last reset().
stats: dict[str, int] = {}


def _parse(spec: str) -> dict[str, list]:
    points: dict[str, list] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if not bits[0]:
            raise ValueError(f"{ENV}: empty fault point in {part!r}")
        prob = float(bits[1]) if len(bits) > 1 and bits[1] else 1.0
        count = int(bits[2]) if len(bits) > 2 and bits[2] else None
        points[bits[0]] = [prob, count]
    return points


def fired(point: str) -> int:
    """How many times ``point`` has fired since the last :func:`reset`."""
    return stats.get(point, 0)


def reset() -> None:
    """Drop the parsed table and fire counts (test isolation seam)."""
    global _cached_spec
    with _lock:
        _cached_spec = None
        _points.clear()
        stats.clear()


def maybe_fail(point: str) -> None:
    """Raise :class:`FaultInjected` iff ``point`` is armed via
    ``KUKEON_FAULTS`` and fires."""
    spec = os.environ.get(ENV)
    if not spec:
        return
    global _cached_spec
    with _lock:
        if spec != _cached_spec:
            _points.clear()
            _points.update(_parse(spec))
            _cached_spec = spec
        p = _points.get(point)
        if p is None:
            return
        prob, remaining = p
        if remaining is not None and remaining <= 0:
            return
        if prob < 1.0 and random.random() >= prob:
            return
        if remaining is not None:
            p[1] = remaining - 1
        stats[point] = stats.get(point, 0) + 1
    raise FaultInjected(f"injected fault at {point!r} ({ENV}={spec})")
