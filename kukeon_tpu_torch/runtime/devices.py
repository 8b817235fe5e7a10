"""The CUDA runtime probe, the port's counterpart of
``kukeon_tpu/runtime/devices.py:46 probe_tpu_runtime``: the serving
cell's watchdog asks it whether a stalled engine sits on a wedged runtime.

Only the probe lives here. Device discovery and grants for
``/dev/nvidia*`` are not ported yet (ROADMAP A13e).
"""

from __future__ import annotations

import subprocess
import sys

from kukeon_tpu_torch import faults

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
