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
orbax) is still read.
"""

from __future__ import annotations

import os
import re
import shutil

import torch

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import convert, orbax_ckpt
from kukeon_tpu_torch.training.train_step import TrainState, tree_leaves

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_PREFIX = "tmp-"
_LEGACY_PAYLOAD = "state.pt"


def _step_dir(root: str, step: int) -> str:
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


def save_checkpoint(root: str, state: TrainState) -> str:
    """Write ``state`` as ``<root>/step_<state.step>``; returns the path.
    Idempotent per step: a completed checkpoint for this exact step is
    left as it is (a save-every boundary that coincides with the final
    save must not error)."""
    step = int(state.step)
    path = _step_dir(root, step)
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
            state.params, state.opt_state, step))
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


def restore_checkpoint(root: str, template: TrainState,
                       step: int | None = None) -> TrainState:
    """Restore the checkpoint at ``step`` (default: newest) into
    ``template``, a state of the same structure (e.g. a freshly created
    one): every tensor is copied in place, so the restored state lives on
    the template's device, in its dtypes, with its ``requires_grad``
    flags, and no second copy of the state is held on the device. An orbax
    step (either package's) is read leaf by leaf on the reader's threads,
    so the host holds a few leaves at a time."""
    faults.maybe_fail("checkpoint.load")
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _step_dir(root, step)
    if os.path.exists(os.path.join(path, _LEGACY_PAYLOAD)):
        return _restore_legacy(path, template)
    ckpt = orbax_ckpt.OrbaxCheckpoint(path)
    # Template leaves by the names the JAX TrainState gives them.
    dst = {}
    for prefix, tree in (("params", template.params),
                         ("opt_state.1.0.mu", template.opt_state["mu"]),
                         ("opt_state.1.0.nu", template.opt_state["nu"])):
        for keys, leaf in _named_leaves(tree):
            dst[".".join((prefix, *keys))] = leaf
    scalars = {"step": None, "opt_state.1.0.count": None, "opt_state.1.2.count": None}
    names = ckpt.array_names()
    if (diff := set(names) ^ (set(dst) | set(scalars))):
        raise ValueError(f"checkpoint {path} does not match the template's structure: "
                         f"{sorted(diff)}")
    with torch.no_grad():
        for name, arr in ckpt.iter_arrays(names):
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
