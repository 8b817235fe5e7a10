"""Rank groups: one process per device, started, joined and torn down here.

JAX drives every chip of a mesh from one controller; the port runs one
process per device, as PyTorch does. Rank 0, the **leader**, is the process
that asked for the group (a serving cell, a test): it keeps all host state
and starts ``world - 1`` **followers**, ``python -m
kukeon_tpu_torch.parallel.launch``, on devices 1..world-1 (``cuda:r``, or
gloo ranks on the CPU). A follower holds no scheduling logic: it runs
:func:`follower_main`, which builds the objects the leader names and
applies, in order, the device actions the leader posts to them.

- **Rendezvous**: a temporary directory per group holds a ``FileStore``
  (``torch.distributed``'s group, NCCL on ``cuda``, gloo on ``cpu``), and
  names the leader's control socket (``AF_UNIX``, abstract, a random key),
  so no TCP port is taken. Every wait has a timeout, ``KUKEON_TP_TIMEOUT_S`` (default 300 s):
  the followers' connections, ``init_process_group`` and every collective.
- **Control channel**: the leader queues ``(object id, action, args)``
  descriptors (:meth:`Group.post`) and sends the queue as one message a
  follower when an action that meets a collective is posted: a decode
  chunk's host inputs and its program run go out together. An argument
  wrapped in :class:`PerRank` sends each follower its own element.
- **Pipe x data x fsdp x expert x seq x tensor**: a group of ``world``
  ranks is laid out as the reference's mesh orders its axes, ``pipe``
  outermost and ``tensor`` innermost: global rank ``((((p * data + d) *
  fsdp + f) * expert + x) * seq + s) * tensor + t``. Serving has only data
  and tensor, so its ranks ``d * tensor .. (d + 1) * tensor - 1`` are data
  replica ``d``. Every axis of more than one rank gets a
  ``torch.distributed`` subgroup per coordinate of the others
  (:attr:`Group.pgs`: ``tensor``, ``fsdp``, ``expert``, ``seq``,
  ``pipe``, ``data``, ``batch`` (data x fsdp x seq), ``data_seq`` (data x
  seq) and ``expert_tensor`` (expert x tensor)), made at the rendezvous
  in one order on every rank, which the mesh's collectives and
  point-to-point hops run over. The leader drives every follower with the same
  descriptors.
- **Failures end the group**: a follower whose process exits, or whose
  action raises, marks the group failed and calls ``on_failure`` (a cell
  exits non-zero there: it never serves on fewer devices); the next post
  raises :class:`RankFailure`. A leader action that raises once it was
  sent (it may hold a collective the followers now wait in) ends the
  group at once, its followers killed (:meth:`Group.abort`); a follower
  already dead is named as the cause (a peer's death is what makes a
  leader's collective raise), the leader only when all are alive; so is
  a follower's error report (its collective raises when a peer dies),
  the reporting follower named only when no other died. Fault points
  (``faults.py``) fire on the leader alone: the followers start without
  ``KUKEON_FAULTS``, so none fails an action on its own count. A follower
  exits when the leader's channel closes or the leader process is gone
  (polled every 0.5 s), so no rank outlives its leader. :func:`shutdown`
  (also at exit) stops them.

One group per process: ``torch.distributed``'s default group.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import datetime
import gc
import importlib
import itertools
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Client, Connection, Listener
from typing import Any, Callable

import torch
import torch.distributed as dist

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.parallel.mesh import AXES

TIMEOUT_ENV = "KUKEON_TP_TIMEOUT_S"
_AUTHKEY_ENV = "KUKEON_TP_AUTHKEY"
_STATS_EVERY_S = 1.0
# How long a leader's abort waits for a dead follower to show (its process
# reaped, or its channel's end seen by the watch thread) before it blames
# the leader itself.
ABORT_WAIT_S = 2.0

_GROUP: "Group | None" = None
_GROUP_LOCK = threading.Lock()


class RankFailure(RuntimeError):
    """A rank of the group failed: its process exited or an action raised."""


@dataclasses.dataclass
class PerRank:
    """An action argument that differs by rank: ``items[r]`` goes to rank r."""

    items: list


def timeout_s() -> float:
    return float(os.environ.get(TIMEOUT_ENV, "300") or 300)


def _control_address(rdzv: str) -> str:
    """The leader's control socket: in Linux's abstract namespace, named
    after the rendezvous directory, so no socket file lives there and a
    long ``TMPDIR`` cannot overflow a socket path."""
    return "\0kukeon-tp-" + os.path.basename(rdzv)


def _device(device_type: str, rank: int) -> torch.device:
    return torch.device(f"cuda:{rank}") if device_type == "cuda" else torch.device("cpu")


# The axis groups beyond the six: each the ranks that differ on these axes.
_PRODUCT_GROUPS = {"batch": ("data", "fsdp", "seq"), "data_seq": ("data", "seq"),
                   "expert_tensor": ("expert", "tensor")}


def _axis_groups(world: int, tensor: int, fsdp: int, expert: int = 1, seq: int = 1,
                 pipe: int = 1) -> dict[str, list[list[int]]]:
    """Every axis group's ranks of a ``pipe`` x ``data`` x ``fsdp`` x
    ``expert`` x ``seq`` x ``tensor`` group (global rank ``((((p * data +
    d) * fsdp + f) * expert + x) * seq + s) * tensor + t``), in one order:
    ``tensor`` (a data replica's block of one coordinate on every other
    axis), ``fsdp``, ``expert``, ``data``, ``batch`` (data x fsdp x seq),
    ``expert_tensor``, ``seq``, ``pipe`` and ``data_seq``; each axis's
    groups one a coordinate of the others, in the order of those
    coordinates. Axes of one rank are absent, but for ``tensor`` on a
    group of more ranks: the serving collectives run over a subgroup of
    each replica's own."""
    sizes = dict(zip(AXES, (pipe, world // (tensor * seq * expert * fsdp * pipe), fsdp,
                             expert, seq, tensor)))
    coords = list(itertools.product(*(range(sizes[a]) for a in AXES)))  # by global rank

    def groups(axes: tuple) -> list[list[int]]:
        by_rest: dict[tuple, list[int]] = {}
        for r, c in enumerate(coords):
            rest = tuple(v for a, v in zip(AXES, c) if a not in axes)
            by_rest.setdefault(rest, []).append(r)
        return list(by_rest.values())

    out = {}
    for axis in ("tensor", "fsdp", "expert", "data", "batch", "expert_tensor", "seq",
                 "pipe", "data_seq"):
        g = groups(_PRODUCT_GROUPS.get(axis, (axis,)))
        if len(g[0]) > 1 or (axis == "tensor" and world > 1):
            out[axis] = g
    return out


def _init_torch_group(device_type: str, store_path: str, rank: int, world: int,
                      tensor: int, fsdp: int = 1, expert: int = 1, seq: int = 1,
                      pipe: int = 1) -> dict:
    """``init_process_group`` on the rendezvous store, then one eager
    ``all_reduce`` that must sum to ``world``: NCCL builds its communicator
    there, outside any graph capture, and a rank that cannot reach the
    others fails here, at boot. Then every rank makes every axis group
    (:func:`_axis_groups`; ``new_group`` is collective, in one order on
    all ranks; an axis that spans the world is the default group, one that
    has the ranks of another already made is that one) and sums over its
    tensor subgroup the same way. -> this rank's group of each axis
    (``torch.distributed`` group; None: the whole group)."""
    timeout = datetime.timedelta(seconds=timeout_s())
    store = dist.FileStore(store_path, world)
    if device_type == "cuda":
        dev = _device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank, world_size=world,
                                timeout=timeout, device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=timeout)
    one = torch.ones((1,), device=_device(device_type, rank))
    dist.all_reduce(one)
    if int(one.item()) != world:
        raise RankFailure(f"rendezvous all_reduce gave {one.item()}, want {world}")
    pgs: dict = {}
    made: dict[tuple, Any] = {tuple(range(world)): None}
    for axis, groups in _axis_groups(world, tensor, fsdp, expert, seq, pipe).items():
        for ranks in groups:
            key = tuple(ranks)
            if key not in made:
                made[key] = dist.new_group(ranks)
            if rank in ranks:
                pgs[axis] = made[key]
    if pgs.get("tensor") is not None:
        one = torch.ones((1,), device=_device(device_type, rank))
        dist.all_reduce(one, group=pgs["tensor"])
        if int(one.item()) != tensor:
            raise RankFailure(f"replica all_reduce gave {one.item()}, want {tensor}")
    return pgs


class Group:
    """This process's rank group. The leader's holds the followers'
    processes and channels; a follower's, its channel to the leader.
    ``tensor``, ``fsdp``, ``expert``, ``seq`` and ``pipe`` the sizes of
    those axes; ``pgs`` this rank's ``torch.distributed`` group of each
    axis of more than one rank (``tensor``, ``fsdp``, ``expert``, ``seq``,
    ``pipe``, ``data``, ``batch``, ``data_seq``, ``expert_tensor``; None:
    the whole group), ``tensor_pg`` its tensor subgroup (None: the whole
    group, or one rank).
    ``peer_stats[r]``: the latest allocator counters follower r reported
    (``{"in_use", "limit", "peak", "index"}``), read by the leader's
    scrapes without any CUDA call."""

    def __init__(self, rank: int, world: int, device_type: str, rdzv: str,
                 conns: list[Connection], procs: list[subprocess.Popen] | None = None,
                 tensor: int | None = None, pgs: dict | None = None, fsdp: int = 1,
                 expert: int = 1, seq: int = 1, pipe: int = 1):
        self.rank = rank
        self.world = world
        self.tensor = tensor or world
        self.fsdp = fsdp
        self.expert = expert
        self.seq = seq
        self.pipe = pipe
        self.pgs = pgs or {}
        self.tensor_pg = self.pgs.get("tensor")
        self.device_type = device_type
        self.device = _device(device_type, rank)
        self._rdzv = rdzv
        self._conns = conns
        self._procs = procs or []
        self._lock = threading.Lock()
        self._fail_lock = threading.Lock()
        self._queue: list[tuple[int, str, tuple]] = []
        self._next_id = 0
        self._closing = False
        self.failed: str | None = None
        self.on_failure: Callable[[str], None] | None = None
        self.peer_stats: dict[int, dict] = {}
        # Followers that reported an error, and those whose channel the
        # watch thread has read to its end (every report of theirs seen).
        self._reported: set[int] = set()
        self._ended: set[int] = set()
        # (object id, what) -> the followers that acknowledged it.
        self._acks: dict[tuple, set[int]] = {}
        self._ack_cond = threading.Condition()
        if rank == 0:
            for r, conn in enumerate(conns, start=1):
                threading.Thread(target=self._watch, args=(r, conn), daemon=True,
                                 name=f"rank-{r}-watch").start()

    @property
    def pids(self) -> list[int]:
        """The followers' process ids, by rank (leader only)."""
        return [p.pid for p in self._procs]

    def new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    # --- the leader's side ------------------------------------------------

    def post(self, oid: int, action: str, args: tuple = (), *, flush: bool = False) -> None:
        """Queue one descriptor for the followers; ``flush``: send the
        queue now (one message a follower). Raises :class:`RankFailure`
        once a rank has failed."""
        if self.failed is not None:
            raise RankFailure(self.failed)
        with self._lock:
            self._queue.append((oid, action, args))
            if flush:
                self._send_locked()

    def flush(self) -> None:
        with self._lock:
            self._send_locked()

    def drop(self, oid: int) -> None:
        """Queue the followers' drop of object ``oid`` (sent with the next
        message); nothing once the group has failed or is closing."""
        if self.failed is None and not self._closing:
            self._queue.append((oid, "drop", ()))

    def _send_locked(self) -> None:
        batch, self._queue = self._queue, []
        if not batch:
            return
        for r, conn in enumerate(self._conns, start=1):
            msg = [(oid, action, tuple(a.items[r] if isinstance(a, PerRank) else a
                                       for a in args))
                   for oid, action, args in batch]
            try:
                conn.send_bytes(pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))
            except OSError as e:
                self._fail(f"rank {r}: control channel lost ({e})")
                raise RankFailure(self.failed) from e

    def _watch(self, rank: int, conn: Connection) -> None:
        """Follower ``rank``'s reports: its allocator counters, or the
        error it died of; its channel's end while the group is open is a
        failure."""
        while True:
            try:
                kind, body = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                break
            if kind == "stats":
                self.peer_stats[rank] = body
            elif kind == "ack":
                with self._ack_cond:
                    self._acks.setdefault(tuple(body), set()).add(rank)
                    self._ack_cond.notify_all()
            elif kind == "error":
                # A follower whose collective raised because a peer died
                # reports an error too: the dead peer, when one shows
                # within ABORT_WAIT_S, is the cause (C12).
                self._reported.add(rank)
                self._fail(self._dead_follower(ABORT_WAIT_S, besides=rank)
                           or f"rank {rank} failed: {body}")
        self._ended.add(rank)
        if not self._closing:
            proc = self._procs[rank - 1]
            try:
                code = proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                code = None
            self._fail(f"rank {rank} exited (code {code})")

    def wait_acks(self, key: tuple, timeout: float | None = None) -> None:
        """Until every follower has acknowledged ``key`` (a follower's
        :meth:`report` ``("ack", key)``), over the control channel, with no
        collective. Raises :class:`RankFailure` once a rank has failed, or
        at the timeout (``KUKEON_TP_TIMEOUT_S``)."""
        deadline = time.monotonic() + (timeout_s() if timeout is None else timeout)
        with self._ack_cond:
            while len(self._acks.get(key, ())) < self.world - 1:
                if self.failed is not None:
                    raise RankFailure(self.failed)
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(1, self.world)) - self._acks.get(key, set()))
                    raise RankFailure(f"ranks {missing} did not acknowledge {key} within "
                                      f"{timeout_s() if timeout is None else timeout:.0f} s")
                self._ack_cond.wait(min(left, 0.1))
            self._acks.pop(key)

    def _fail(self, why: str, *, kill: bool = False) -> None:
        with self._fail_lock:
            if self.failed is not None or self._closing:
                first = False
            else:
                first = True
                self.failed = why
        if kill:
            for p in self._procs:
                p.kill()
        if first:
            print(f"rank group: {why}", file=sys.stderr, flush=True)
            with self._ack_cond:
                self._ack_cond.notify_all()
            if self.on_failure is not None:
                self.on_failure(why)

    def _dead_follower(self, wait_s: float, besides: int | None = None) -> str | None:
        """Why the group failed if a follower is gone: the cause a watch
        thread recorded, else the first follower other than ``besides``
        that died (``rank r exited (code c)``, as :meth:`_watch` words
        it): killed by a signal, or exited without reporting an error once
        its channel was read to its end (a follower that reported one
        exits after it: it is not the cause of another's error). Polls for
        up to ``wait_s``: a follower killed mid-collective resets its
        sockets before its process is reaped, so a peer's collective can
        raise before either shows. None when no follower died."""
        deadline = time.monotonic() + wait_s
        while True:
            if self.failed is not None:
                return self.failed
            for r, p in enumerate(self._procs, start=1):
                if r == besides or p.poll() is None:
                    continue
                read = r in self._ended or r > len(self._conns)
                if p.returncode < 0 or (read and r not in self._reported):
                    return f"rank {r} exited (code {p.returncode})"
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.01)

    def abort(self, why: str) -> None:
        """Fail the group now (the leader's): its followers are killed, not
        left in a collective this rank will not enter until the timeout,
        and ``on_failure`` is called. A follower already gone is the cause
        (a leader's collective fails when its peer dies): ``why``, the
        leader's own failure, is recorded only when every follower is
        alive after :data:`ABORT_WAIT_S`."""
        self._fail(self._dead_follower(ABORT_WAIT_S) or why, kill=True)

    def close(self) -> None:
        """Stop the followers (their ``exit`` descriptor, then a bounded
        wait, then a kill), tear the torch group down and remove the
        rendezvous directory."""
        self._closing = True
        if self.rank == 0:
            for conn in self._conns:
                try:
                    conn.send_bytes(pickle.dumps([(0, "exit", ())]))
                except OSError:
                    pass
            deadline = time.monotonic() + 10.0
            for p in self._procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for conn in self._conns:
            conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.rank == 0:
            shutil.rmtree(self._rdzv, ignore_errors=True)

    # --- the follower's side -----------------------------------------------

    def report(self, kind: str, body: Any) -> None:
        self._conns[0].send_bytes(pickle.dumps((kind, body)))


def current() -> Group | None:
    """This process's open group, if any."""
    return _GROUP


def group(world: int, device_type: str, tensor: int | None = None, fsdp: int = 1,
          expert: int = 1, seq: int = 1, pipe: int = 1) -> Group:
    """This process's group of ``world`` ranks on ``device_type``, laid out
    ``pipe`` x data x ``fsdp`` x ``expert`` x ``seq`` x ``tensor``
    (``tensor`` None: the whole world, one replica): the open one when it
    matches, else a new one (:func:`start`).
    A second group of another shape in one process is a ``ValueError``."""
    global _GROUP
    tensor = tensor or world
    with _GROUP_LOCK:
        if _GROUP is not None and _GROUP.failed is None:
            if ((_GROUP.world, _GROUP.tensor, _GROUP.fsdp, _GROUP.expert, _GROUP.seq,
                 _GROUP.pipe, _GROUP.device_type)
                    != (world, tensor, fsdp, expert, seq, pipe, device_type)):
                raise ValueError(
                    f"this process already leads a group of {_GROUP.world} "
                    f"{_GROUP.device_type} ranks (pipe {_GROUP.pipe}, fsdp {_GROUP.fsdp}, "
                    f"expert {_GROUP.expert}, seq {_GROUP.seq}, tensor {_GROUP.tensor}); "
                    "one group a process")
            return _GROUP
        if _GROUP is not None:
            _GROUP.close()
        _GROUP = start(world, device_type, tensor, fsdp, expert, seq, pipe)
        return _GROUP


def shutdown() -> None:
    """Close this process's group, if one is open."""
    global _GROUP
    with _GROUP_LOCK:
        if _GROUP is not None:
            g, _GROUP = _GROUP, None
            g.close()


atexit.register(shutdown)


def follower_env(key: bytes) -> dict[str, str]:
    """A follower's environment: this process's, without ``KUKEON_FAULTS``
    (fault points fire on the leader alone), with the control channel's
    key and this package on ``PYTHONPATH``."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items() if k != faults.ENV}
    env[_AUTHKEY_ENV] = key.hex()
    env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    return env


def start(world: int, device_type: str, tensor: int | None = None, fsdp: int = 1,
          expert: int = 1, seq: int = 1, pipe: int = 1) -> Group:
    """Start ``world - 1`` followers and join them as rank 0, laid out
    ``pipe`` x data x ``fsdp`` x ``expert`` x ``seq`` x ``tensor``
    (``tensor`` None: ``world``; ``pipe * fsdp * expert * seq * tensor``
    must divide ``world``). A follower that exits before it connects, or a
    rendezvous that outlasts the timeout, kills the others and raises
    :class:`RankFailure`."""
    tensor = tensor or world
    if world % (tensor * seq * expert * fsdp * pipe):
        raise ValueError(f"pipe {pipe} x fsdp {fsdp} x expert {expert} x seq {seq} x tensor "
                         f"{tensor} does not divide {world} ranks")
    rdzv = tempfile.mkdtemp(prefix="kukeon-tp-")
    key = os.urandom(16)
    listener = Listener(_control_address(rdzv), family="AF_UNIX", authkey=key)
    env = follower_env(key)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.parallel.launch", "--rank", str(r),
         "--world", str(world), "--tensor", str(tensor), "--fsdp", str(fsdp),
         "--expert", str(expert), "--seq", str(seq), "--pipe", str(pipe), "--rdzv", rdzv,
         "--device", device_type, "--leader-pid", str(os.getpid())], env=env)
        for r in range(1, world)]
    conns: dict[int, Connection] = {}
    accepted: list = []

    def accept():
        try:
            for _ in range(world - 1):
                conn = listener.accept()
                accepted.append(conn)
        except OSError:
            pass

    t = threading.Thread(target=accept, daemon=True, name="rank-accept")
    t.start()
    deadline = time.monotonic() + timeout_s()
    try:
        while len(accepted) < world - 1:
            dead = [(r, p.returncode) for r, p in enumerate(procs, start=1)
                    if p.poll() is not None]
            if dead:
                raise RankFailure(f"rank {dead[0][0]} exited before the rendezvous "
                                  f"(code {dead[0][1]})")
            if time.monotonic() > deadline:
                raise RankFailure(f"rendezvous timed out after {timeout_s():.0f} s: "
                                  f"{len(accepted)} of {world - 1} followers connected")
            time.sleep(0.01)
        for conn in accepted:
            if not conn.poll(timeout_s()):
                raise RankFailure("a follower connected but never said its rank")
            conns[int(pickle.loads(conn.recv_bytes()))] = conn
        pgs = _init_torch_group(device_type, os.path.join(rdzv, "store"), 0, world, tensor,
                                fsdp, expert, seq, pipe)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        for conn in accepted:
            conn.close()
        shutil.rmtree(rdzv, ignore_errors=True)
        raise
    finally:
        listener.close()
    return Group(0, world, device_type, rdzv, [conns[r] for r in range(1, world)], procs,
                 tensor, pgs, fsdp, expert, seq, pipe)


# --- the follower process ---------------------------------------------------


def _watch_leader(leader_pid: int) -> None:
    """Exit this follower once its leader process is gone (re-parented),
    even while the main thread is blocked in a collective."""
    while True:
        if os.getppid() != leader_pid:
            os._exit(3)
        time.sleep(0.5)


def _memory_stats(g: Group) -> dict:
    """This rank's allocator counters (no CUDA runtime call)."""
    if g.device_type != "cuda":
        return {}
    ms = torch.cuda.memory_stats(g.device)
    return {"index": g.device.index, "in_use": float(ms.get("allocated_bytes.all.current", 0)),
            "peak": float(ms.get("allocated_bytes.all.peak", 0)),
            "limit": float(torch.cuda.get_device_properties(g.device).total_memory)}


def _resolve(path: str) -> Callable:
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def follower_main(argv=None) -> int:
    """A follower's life: connect, join the torch group, then apply the
    leader's descriptors in order: ``new`` (``(factory, kwargs)``:
    ``factory(mesh, **kwargs)`` makes object ``oid``), ``drop``, ``exit``,
    and any other action, which goes to ``obj.follow(action, args)``. An
    action that raises is reported to the leader and ends the process."""
    ap = argparse.ArgumentParser(prog="kukeon-tp-follower")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--tensor", type=int, default=None)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--expert", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=1)
    ap.add_argument("--rdzv", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--leader-pid", type=int, required=True)
    args = ap.parse_args(argv)
    threading.Thread(target=_watch_leader, args=(args.leader_pid,), daemon=True,
                     name="leader-watch").start()
    if args.device == "cpu":
        torch.set_num_threads(1)
    key = bytes.fromhex(os.environ.pop(_AUTHKEY_ENV))
    conn = Client(_control_address(args.rdzv), family="AF_UNIX", authkey=key)
    conn.send_bytes(pickle.dumps(args.rank))
    tensor = args.tensor or args.world
    pgs = _init_torch_group(args.device, os.path.join(args.rdzv, "store"), args.rank,
                            args.world, tensor, args.fsdp, args.expert, args.seq, args.pipe)
    g = Group(args.rank, args.world, args.device, args.rdzv, [conn], tensor=tensor, pgs=pgs,
              fsdp=args.fsdp, expert=args.expert, seq=args.seq, pipe=args.pipe)
    from kukeon_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(g)
    objs: dict[int, Any] = {}
    last_stats = 0.0
    code = 0
    try:
        while True:
            try:
                batch = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                code = 1               # the leader went away without an exit
                break
            for oid, action, a in batch:
                if action == "exit":
                    return 0
                if action == "new":
                    factory, kwargs = a
                    objs[oid] = _resolve(factory)(mesh, **kwargs)
                elif action == "drop":
                    objs.pop(oid, None)
                    gc.collect()
                else:
                    objs[oid].follow(action, a)
            now = time.monotonic()
            if now - last_stats >= _STATS_EVERY_S:
                g.report("stats", _memory_stats(g))
                last_stats = now
    except BaseException as e:  # noqa: BLE001 — reported, then the process ends
        traceback.print_exc()
        try:
            g.report("error", f"{type(e).__name__}: {e}")
        except OSError:
            pass
        code = 1
    finally:
        objs.clear()
        g._closing = True
        try:
            if dist.is_initialized() and code == 0:
                dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — exiting anyway
            pass
    return code


if __name__ == "__main__":
    sys.exit(follower_main())
