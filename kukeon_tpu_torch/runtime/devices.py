"""GPU discovery, grants and the CUDA runtime probe, the port of
``kukeon_tpu/runtime/devices.py``: the reference's TPU chips become the
host's NVIDIA GPUs.

- :func:`discover_gpus` (the reference's ``discover_chips`` :27): an
  override env, ``KUKEON_GPUS``, first (a comma list, empty for none, as
  ``KUKEON_TPU_CHIPS`` works), then the ``/dev/nvidiaN`` nodes this
  process can open (a container may hold the node of a GPU its device
  cgroup denies, which ``nvidia-smi`` and CUDA do not count either).
- :class:`GPUDeviceManager` (``TPUDeviceManager`` :99): grants of GPUs to
  owners, persisted in the metadata store as ``gpu-allocations.json``
  (``{str(id): owner}``) so a restart keeps them; the device nodes a grant
  needs; and the env that makes CUDA see exactly the granted GPUs.
- :func:`probe_cuda_runtime` (``probe_tpu_runtime`` :46): the serving
  cell's watchdog asks it whether a stalled engine sits on a wedged
  runtime.

A GPU's id here is its device node's minor number, N of ``/dev/nvidiaN``.
One GPU has three numberings, which need not agree: that minor number,
``nvidia-smi``'s index (PCI bus order), and CUDA's ordinal (fastest first
unless ``CUDA_DEVICE_ORDER`` says otherwise, and counted among the GPUs a
process can open). :meth:`GPUDeviceManager.visibility_env` sets
``CUDA_DEVICE_ORDER=PCI_BUS_ID`` and names each granted GPU by its PCI
ordinal among the GPUs whose nodes open, read from the NVIDIA module's
``/proc/driver/nvidia/gpus/*/information`` where it is shown
(:func:`pci_ordinals`), so a grant of GPU 2 reaches the card
``/dev/nvidia2`` names. Tests point ``root`` at a fake tree.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.runtime.errors import FailedPrecondition
from kukeon_tpu_torch.runtime.metadata import MetadataStore

ALLOC_FILE = "gpu-allocations.json"
OVERRIDE_ENV = "KUKEON_GPUS"
# A GPU's own node; not nvidiactl, nvidia-uvm, nvidia-uvm-tools or nvidia-caps/.
_GPU_NODE = re.compile(r"nvidia(\d+)")
# Nodes every CUDA process opens beside its GPUs', where the host has them.
SHARED_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


def _opens(path: str) -> bool:
    """Whether this process may open the node at ``path``."""
    try:
        os.close(os.open(path, os.O_RDWR))
    except OSError:
        return False
    return True


def _node_minors(root: str) -> list[int]:
    """The minor numbers of the ``<root>/dev/nvidiaN`` nodes this process
    can open, sorted."""
    minors = []
    for path in glob.glob(os.path.join(root, "dev", "nvidia*")):
        m = _GPU_NODE.fullmatch(os.path.basename(path))
        if m and _opens(path):
            minors.append(int(m.group(1)))
    return sorted(minors)


def discover_gpus(root: str = "/") -> list[int]:
    """The host's GPU ids: ``KUKEON_GPUS`` when set (a comma list; empty:
    none), else the minor numbers of the ``<root>/dev/nvidiaN`` nodes this
    process can open, sorted."""
    override = os.environ.get(OVERRIDE_ENV)
    if override is not None:
        override = override.strip()
        return [int(x) for x in override.split(",")] if override else []
    return _node_minors(root)


def pci_ordinals(root: str = "/") -> dict[int, int]:
    """``{minor: CUDA ordinal under CUDA_DEVICE_ORDER=PCI_BUS_ID}``, CUDA
    counting the GPUs whose node this process can open: the NVIDIA module's
    ``<root>/proc/driver/nvidia/gpus/<bus id>/information`` gives each
    GPU's ``Device Minor``, and those GPUs (all of them, where no node
    opens) are numbered in bus-id order. Without those files (a container
    may not show them), the nodes' minors in their own order (the module
    numbers them as it probes the bus); without nodes either, nothing."""
    nodes = set(_node_minors(root))
    by_bus = []
    for info in glob.glob(os.path.join(root, "proc", "driver", "nvidia", "gpus", "*",
                                       "information")):
        with open(info) as f:
            fields = dict((k.strip(), v) for k, v in (ln.split(":", 1) for ln in f if ":" in ln))
        minor = fields.get("Device Minor", "").strip()
        if minor.isdigit():
            bus = fields.get("Bus Location", os.path.basename(os.path.dirname(info)))
            by_bus.append((bus.strip().lower(), int(minor)))
    if by_bus:
        seen = [m for _b, m in sorted(by_bus) if not nodes or m in nodes]
        return {m: i for i, m in enumerate(seen)}
    return {m: i for i, m in enumerate(sorted(nodes))}


# What the throwaway process runs: a 1 MB int8 upload to the card, a
# synchronise, and its wall time; "cpu" when no CUDA device is visible.
_PROBE = (
    "import time, torch\n"
    "if not torch.cuda.is_available():\n"
    "    print('cpu', 0.0)\n"
    "else:\n"
    "    t0 = time.monotonic()\n"
    "    x = torch.ones((1024, 1024), dtype=torch.int8).to('cuda')\n"
    "    torch.cuda.synchronize()\n"
    "    print('cuda', round(time.monotonic() - t0, 3))\n"
)


def probe_cuda_runtime(timeout_s: float = 20.0) -> tuple[str, str]:
    """Live-runtime health probe: ('ok'|'wedged'|'unavailable', detail).

    A process whose CUDA context hangs blocks its own device calls
    forever, so the probe runs a 1 MB upload and a synchronise in a
    throwaway subprocess (only a subprocess is reliably killable
    mid-hang), killed at ``timeout_s``: a timeout is ``wedged``, a failed
    or device-less probe ``unavailable``, and an answer ``ok`` with its
    wall time. The ``devices.probe_wedged`` fault point makes it report
    ``wedged`` without a card having to wedge."""
    try:
        faults.maybe_fail("devices.probe_wedged")
    except faults.FaultInjected as e:
        return "wedged", f"fault-injected: {e}"
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                             text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return ("wedged", f"1MB upload and synchronise did not finish in {timeout_s:.0f}s "
                          "(the CUDA runtime hangs; the cell must restart)")
    if out.returncode != 0:
        err = out.stderr.strip().splitlines()
        return "unavailable", (err[-1][:200] if err else f"rc={out.returncode}")
    backend, dt = out.stdout.split()[-2:]
    if backend != "cuda":
        return "unavailable", "no CUDA device visible to a fresh process"
    return "ok", f"backend=cuda, 1MB upload in {dt}s"


class GPUDeviceManager:
    """GPU accounting, persisted so a restart keeps the grants: the
    reference's ``TPUDeviceManager`` over ``gpus`` (default: what
    :func:`discover_gpus` finds)."""

    def __init__(self, store: MetadataStore, gpus: list[int] | None = None):
        self.store = store
        self.gpus = gpus if gpus is not None else discover_gpus()

    # grants: {str(gpu id): owner, e.g. "realm/space/stack/cell"}

    def _load(self) -> dict[str, str]:
        return self.store.read_json_or({}, ALLOC_FILE)

    def _save(self, allocs: dict[str, str]) -> None:
        self.store.write_json(allocs, ALLOC_FILE)

    def allocated(self) -> dict[int, str]:
        return {int(k): v for k, v in self._load().items()}

    def free_gpus(self) -> list[int]:
        used = set(self.allocated())
        return [g for g in self.gpus if g not in used]

    def allocate(self, owner: str, n: int) -> list[int]:
        """Grant ``n`` GPUs to ``owner`` (idempotent: a grant of that size
        is returned as it is; one of another size is released and granted
        again); ``FailedPrecondition`` when fewer are free."""
        with self.store.lock():
            allocs = self._load()
            mine = sorted(int(k) for k, v in allocs.items() if v == owner)
            if len(mine) == n:
                return mine
            for g in mine:
                del allocs[str(g)]
            free = [g for g in self.gpus if str(g) not in allocs]
            if len(free) < n:
                raise FailedPrecondition(
                    f"not enough GPUs: want {n}, free {len(free)} of {len(self.gpus)}")
            grant = free[:n]
            for g in grant:
                allocs[str(g)] = owner
            self._save(allocs)
            return grant

    def release(self, owner: str) -> None:
        with self.store.lock():
            allocs = self._load()
            remaining = {k: v for k, v in allocs.items() if v != owner}
            if len(remaining) != len(allocs):
                self._save(remaining)

    @staticmethod
    def device_nodes(gpus: list[int], root: str = "/") -> list[str]:
        """The host's device nodes behind these GPUs, for a backend that
        builds a cell's ``/dev``: each GPU's ``/dev/nvidiaN``, then
        ``/dev/nvidiactl``, ``/dev/nvidia-uvm`` and ``/dev/nvidia-uvm-tools``
        where they exist. Empty where no GPU node exists (the reference's
        node-less TPU plane)."""
        dev = os.path.join(root, "dev")
        out = [p for p in (os.path.join(dev, f"nvidia{g}") for g in gpus) if os.path.exists(p)]
        if out:
            out += [p for p in (os.path.join(dev, n) for n in SHARED_NODES)
                    if os.path.exists(p)]
        return out

    @staticmethod
    def visibility_env(gpus: list[int], root: str = "/") -> dict[str, str]:
        """The env that restricts CUDA to exactly these GPUs:
        ``CUDA_VISIBLE_DEVICES`` their PCI ordinals (:func:`pci_ordinals`;
        an id it does not know as it is), ``CUDA_DEVICE_ORDER=PCI_BUS_ID``
        so that CUDA numbers them so, and ``KUKEON_GPU_DEVICES`` their node
        paths for a backend that binds nodes. The reference's
        ``TPU_CHIPS_PER_PROCESS_BOUNDS`` and ``TPU_PROCESS_BOUNDS`` pin a
        TPU chip subset's topology; CUDA has no counterpart, a process
        sees its visible GPUs and nothing more."""
        order = pci_ordinals(root)
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(order.get(g, g)) for g in gpus),
                "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
                "KUKEON_GPU_DEVICES": ",".join(f"/dev/nvidia{g}" for g in gpus)}
