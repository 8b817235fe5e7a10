"""Training checkpoint/resume, the port of
``kukeon_tpu/training/checkpointing.py``.

The same directory protocol: ``<root>/step_00000042/`` per checkpoint,
newest wins for resume, and saves are crash-atomic. A save writes the
whole state under a temp name in the same root (``tmp-step_XXXXXXXX.<pid>``),
passes the fault point ``checkpoint.save``, fsyncs, and only then one
``os.replace`` publishes the final ``step_*`` name. A writer killed at any
point leaves at most a temp directory that :func:`latest_step` never
matches: the previous checkpoint stays the resume target.

The payload is the JAX package's: an orbax checkpoint of its ``TrainState``
(params, optax's chain state, step), written by the port's own writer
(:func:`orbax_ckpt.write_tree`), so the JAX trainer resumes from a step
the port saved and the port from one the JAX trainer saved. A step
directory that holds a ``state.pt`` (what the port saved before it wrote
orbax) is still read. A training mesh saves the same layout, gathered leaf
by leaf to its leader, and restores from any checkpoint onto any mesh,
each rank reading its own blocks.
"""

from __future__ import annotations

import os
import re
import shutil

import torch
import torch.distributed as dist

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import convert, orbax_ckpt
from kukeon_tpu_torch.training.train_step import TrainState, tree_items, tree_leaves

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_PREFIX = "tmp-"
_LEGACY_PAYLOAD = "state.pt"


def step_dir(root: str, step: int) -> str:
    """The directory of ``step``'s checkpoint under ``root``."""
    return os.path.join(root, f"step_{step:08d}")


def _fsync(path: str) -> None:
    """fsync a file or a directory's entries; best-effort on filesystems
    that reject directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def latest_step(root: str) -> int | None:
    """Newest complete checkpoint step under ``root``; None when empty."""
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return None
    steps = []
    for e in entries:
        m = _STEP_RE.match(e)
        if m and os.path.isdir(os.path.join(root, e)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def save_checkpoint(root: str, state: TrainState, *, mesh=None, layout=None) -> str | None:
    """Write ``state`` as ``<root>/step_<state.step>``; returns the path.
    Idempotent per step: a completed checkpoint for this exact step is
    left as it is (a save-every boundary that coincides with the final
    save must not error).

    On a training ``mesh`` (``state`` the rank's, cut by ``layout``, a
    ``sharding.TrainLayout``) every rank calls it: the leader writes the
    one-device layout, each leaf gathered to its host as the writer
    reaches it (:func:`gather_leaf`), so the host holds one full leaf at a
    time; the others send it their blocks and return None. The leader
    decides whether the step is on disk already before any rank calls it
    (``step_dir``)."""
    if mesh is not None and not mesh.leader:
        for _keys, leaf in orbax_ckpt.flatten(gathered_tree(state, mesh, layout)):
            if callable(leaf):
                leaf()
        return None
    step = int(state.step)
    path = step_dir(root, step)
    if os.path.isdir(path):
        return path
    os.makedirs(root, exist_ok=True)
    # Same-directory temp name, so os.replace stays a same-filesystem
    # rename; PID-suffixed so a dead writer's leftovers never collide with
    # a live retry.
    tmp = os.path.join(root, f"{_TMP_PREFIX}step_{step:08d}.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        # write_tree fsyncs every file it writes.
        orbax_ckpt.write_tree(tmp, orbax_ckpt.train_state_tree(
            state.params, state.opt_state, step) if mesh is None
            else gathered_tree(state, mesh, layout))
        # The injected mid-save kill: everything is written under the temp
        # name, nothing published yet.
        faults.maybe_fail("checkpoint.save")
        for d, _, _ in os.walk(tmp):
            _fsync(d)
        os.replace(tmp, path)
        _fsync(root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def gathered_tree(state: TrainState, mesh, layout) -> dict:
    """The JAX ``TrainState`` tree of a training mesh's ``state`` whose
    tensor leaves are callables, each gathering its leaf
    (:func:`gather_leaf`): what the leader's writer reaches leaf by leaf,
    and what every other rank walks in the same order
    (``orbax_ckpt.flatten``), calling each."""
    full = dict(tree_items(layout.meta()))
    peers = layout.peers(mesh.data, mesh.seq)

    def lazy(tree, path=()):
        if isinstance(tree, dict):
            return {k: lazy(v, path + (k,)) for k, v in tree.items()}
        return lambda: gather_leaf(tree, path, full[path].shape, mesh, peers)

    opt = {"count": state.opt_state["count"], "mu": lazy(state.opt_state["mu"]),
           "nu": lazy(state.opt_state["nu"])}
    return orbax_ckpt.train_state_tree(lazy(state.params), opt, int(state.step))


def gather_leaf(x: torch.Tensor, path: tuple[str, ...], shape, mesh, peers: list):
    """The full leaf of shape ``shape`` whose block on this rank is ``x``,
    on the leader's host (None on the other ranks): each block, held by
    the first of its holders (``TrainLayout.owned``; ``peers`` the layout
    and data and seq coordinates of every global rank,
    ``TrainLayout.peers``: a pipeline's stages each hold their layers'
    blocks), is sent to the leader, which places it in each cut axis's
    region. Every rank calls it for the same leaves in the same order."""
    if not mesh.leader:
        lay, d, s = peers[mesh.group.rank]
        if lay.owned(path, d, s):
            dist.send(x.detach().contiguous().view(-1).view(torch.uint8), dst=0)
        return None
    full = torch.empty(tuple(shape), dtype=x.dtype)
    for src, (lay, d, s) in enumerate(peers):
        if not lay.owned(path, d, s):
            continue
        block = x.detach()
        if src:
            block = torch.empty(lay.local_shape(path, shape), dtype=x.dtype, device=x.device)
            dist.recv(block.view(-1).view(torch.uint8), src=src)
        index = [slice(None)] * len(shape)
        for axis, lo, hi in lay.regions(path, shape):
            index[axis] = slice(lo, hi)
        full[tuple(index)] = block.to("cpu")
    return full


def restore_checkpoint(root: str, template: TrainState,
                       step: int | None = None, *, layout=None) -> TrainState:
    """Restore the checkpoint at ``step`` (default: newest) into
    ``template``, a state of the same structure (e.g. a freshly created
    one): every tensor is copied in place, so the restored state lives on
    the template's device, in its dtypes, with its ``requires_grad``
    flags, and no second copy of the state is held on the device. An orbax
    step (either package's) is read leaf by leaf on the reader's threads,
    so the host holds a few leaves at a time. With ``layout`` (a training
    mesh's rank, ``sharding.TrainLayout``; ``template`` its state) each
    array's region is the rank's block: every rank reads its own, params
    and moments alike, from a checkpoint saved on any mesh or one
    device."""
    faults.maybe_fail("checkpoint.load")
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = step_dir(root, step)
    if os.path.exists(os.path.join(path, _LEGACY_PAYLOAD)):
        return _restore_legacy(path, template)
    ckpt = orbax_ckpt.OrbaxCheckpoint(path)
    # Template leaves by the names the JAX TrainState gives them.
    dst, paths = {}, {}
    for prefix, tree in (("params", template.params),
                         ("opt_state.1.0.mu", template.opt_state["mu"]),
                         ("opt_state.1.0.nu", template.opt_state["nu"])):
        for keys, leaf in _named_leaves(tree):
            dst[".".join((prefix, *keys))] = leaf
            paths[".".join((prefix, *keys))] = keys
    scalars = {"step": None, "opt_state.1.0.count": None, "opt_state.1.2.count": None}
    names = ckpt.array_names()
    if (diff := set(names) ^ (set(dst) | set(scalars))):
        raise ValueError(f"checkpoint {path} does not match the template's structure: "
                         f"{sorted(diff)}")
    regions = ({} if layout is None else
               {name: layout.regions(keys, ckpt.zarray(name)["shape"])
                for name, keys in paths.items()})
    with torch.no_grad():
        for name, arr in ckpt.iter_arrays(names, regions):
            if name in scalars:
                scalars[name] = int(arr)
                continue
            d = dst[name]
            if tuple(arr.shape) != tuple(d.shape):
                raise ValueError(f"checkpoint {path}: {name} is {tuple(arr.shape)}, the "
                                 f"template's {tuple(d.shape)}")
            d.copy_(convert.tensor_from_numpy(arr))
    if scalars["opt_state.1.2.count"] != scalars["opt_state.1.0.count"]:
        raise ValueError(f"checkpoint {path}: the schedule's count "
                         f"{scalars['opt_state.1.2.count']} differs from adam's "
                         f"{scalars['opt_state.1.0.count']}")
    template.opt_state["count"] = scalars["opt_state.1.0.count"]
    template.step = scalars["step"]
    return template


def _named_leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], keys + (k,))
    else:
        yield keys, tree


def _restore_legacy(path: str, template: TrainState) -> TrainState:
    """A step saved as one ``torch.save`` payload (``state.pt``)."""
    saved = torch.load(os.path.join(path, _LEGACY_PAYLOAD),
                       map_location="cpu", weights_only=True, mmap=True)
    pairs = [(tree_leaves(template.params), tree_leaves(saved["params"])),
             (tree_leaves(template.opt_state["mu"]), tree_leaves(saved["opt_state"]["mu"])),
             (tree_leaves(template.opt_state["nu"]), tree_leaves(saved["opt_state"]["nu"]))]
    with torch.no_grad():
        for dst, src in pairs:
            if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
                raise ValueError(f"checkpoint {path} does not match the template's structure")
            for d, s in zip(dst, src):
                d.copy_(s)
    template.opt_state["count"] = int(saved["opt_state"]["count"])
    template.step = int(saved["step"])
    return template
