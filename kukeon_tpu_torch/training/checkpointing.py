"""Training checkpoint/resume, the port of
``kukeon_tpu/training/checkpointing.py``.

The same directory protocol: ``<root>/step_00000042/`` per checkpoint,
newest wins for resume, and saves are crash-atomic. A save writes the
whole state under a temp name in the same root (``tmp-step_XXXXXXXX.<pid>``),
passes the fault point ``checkpoint.save``, fsyncs, and only then one
``os.replace`` publishes the final ``step_*`` name. A writer killed at any
point leaves at most a temp directory that :func:`latest_step` never
matches: the previous checkpoint stays the resume target.

The payload is ``torch.save`` of the state (params, optimizer state,
step) in one file, where the JAX package writes orbax; reading orbax
checkpoints written by the JAX package is not ported (ROADMAP A10c).
"""

from __future__ import annotations

import os
import re
import shutil

import torch

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.training.train_step import TrainState, tree_leaves

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_PREFIX = "tmp-"
_PAYLOAD = "state.pt"


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
        os.makedirs(tmp)
        payload = {"params": state.params, "opt_state": state.opt_state, "step": step}
        torch.save(payload, os.path.join(tmp, _PAYLOAD))
        # The injected mid-save kill: everything is written under the temp
        # name, nothing published yet.
        faults.maybe_fail("checkpoint.save")
        _fsync(os.path.join(tmp, _PAYLOAD))
        _fsync(tmp)
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
    flags, and no second copy of the state is held on the device."""
    faults.maybe_fail("checkpoint.load")
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    saved = torch.load(os.path.join(_step_dir(root, step), _PAYLOAD),
                       map_location="cpu", weights_only=True, mmap=True)
    pairs = [(tree_leaves(template.params), tree_leaves(saved["params"])),
             (tree_leaves(template.opt_state["mu"]), tree_leaves(saved["opt_state"]["mu"])),
             (tree_leaves(template.opt_state["nu"]), tree_leaves(saved["opt_state"]["nu"]))]
    with torch.no_grad():
        for dst, src in pairs:
            if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
                raise ValueError(f"checkpoint {root} step {step} does not match the "
                                 "template's structure")
            for d, s in zip(dst, src):
                d.copy_(s)
    template.opt_state["count"] = int(saved["opt_state"]["count"])
    template.step = int(saved["step"])
    return template
