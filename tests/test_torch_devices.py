"""The port's GPU discovery and grants (``kukeon_tpu_torch/runtime/devices.py``)
against the reference's TPU ones (``kukeon_tpu/runtime/devices.py``), on
the CPU.

- ``discover_gpus`` reads ``KUKEON_GPUS`` as ``discover_chips`` reads
  ``KUKEON_TPU_CHIPS`` (a comma list; empty: none), else the
  ``/dev/nvidiaN`` nodes of a fake tree, and nothing of ``nvidiactl``,
  ``nvidia-uvm`` or ``nvidia-caps/``.
- ``device_nodes`` gives a grant's own nodes and the shared ones that
  exist, and nothing where no GPU node exists.
- ``GPUDeviceManager`` and ``TPUDeviceManager`` run the same
  allocate, repeat, resize, shortage and release sequence side by side,
  each over a store of its own package: the same ids, the same raises,
  the same documents on disk, and a restart reads the grants back.
- ``visibility_env`` names each granted GPU by its PCI ordinal, read from
  a fake ``/proc/driver/nvidia/gpus/*/information``.
"""

import json
import os

import pytest
import torch

from kukeon_tpu.runtime import devices as jdev
from kukeon_tpu.runtime import errors as jerr
from kukeon_tpu.runtime.metadata import MetadataStore as JStore
from kukeon_tpu_torch.runtime import devices as tdev
from kukeon_tpu_torch.runtime import errors as terr
from kukeon_tpu_torch.runtime.metadata import MetadataStore as TStore

torch.set_num_threads(2)


@pytest.mark.parametrize("value, want", [("0,2", [0, 2]), ("3", [3]), ("", []), ("  ", []),
                                         (" 1,0 ", [1, 0])])
def test_the_override_env_lists_gpus_as_the_reference_lists_chips(monkeypatch, value, want):
    monkeypatch.setenv(tdev.OVERRIDE_ENV, value)
    monkeypatch.setenv("KUKEON_TPU_CHIPS", value)
    assert tdev.discover_gpus() == jdev.discover_chips() == want


def _fake_root(tmp_path):
    dev = tmp_path / "dev"
    (dev / "nvidia-caps").mkdir(parents=True)
    for name in ("nvidia0", "nvidia3", "nvidiactl", "nvidia-uvm"):
        (dev / name).touch()
    return str(tmp_path)


def test_discovery_and_device_nodes_on_a_fake_dev_tree(monkeypatch, tmp_path):
    monkeypatch.delenv(tdev.OVERRIDE_ENV, raising=False)
    root = _fake_root(tmp_path)
    assert tdev.discover_gpus(root) == [0, 3]
    dev = os.path.join(root, "dev")
    nodes = tdev.GPUDeviceManager.device_nodes
    assert nodes([3], root) == [os.path.join(dev, n) for n in ("nvidia3", "nvidiactl",
                                                                 "nvidia-uvm")]
    assert nodes([0, 3], root)[:2] == [os.path.join(dev, "nvidia0"),
                                       os.path.join(dev, "nvidia3")]
    assert nodes([5], root) == [] and nodes([], root) == []
    (tmp_path / "dev" / "nvidia-uvm-tools").touch()
    assert nodes([0], root)[-1] == os.path.join(dev, "nvidia-uvm-tools")
    # A node this process cannot open (a GPU its device cgroup denies) is
    # no GPU of this host, for discovery and for CUDA's numbering.
    real = tdev._opens
    monkeypatch.setattr(tdev, "_opens", lambda p: not p.endswith("nvidia0") and real(p))
    assert tdev.discover_gpus(root) == [3] and tdev.pci_ordinals(root) == {3: 0}
    monkeypatch.setattr(tdev, "_opens", real)
    # The env override wins over the nodes, as the reference's does.
    monkeypatch.setenv(tdev.OVERRIDE_ENV, "7")
    assert tdev.discover_gpus(root) == [7]


def _both(call):
    """``call`` on the reference -> ("ok", value) or ("raises", code)."""
    try:
        return "ok", call()
    except (jerr.KukeonError, terr.KukeonError) as e:
        return "raises", e.code


def test_the_managers_sequence_matches_the_reference_manager(tmp_path):
    ids = [0, 1, 2, 3]
    port = tdev.GPUDeviceManager(TStore(str(tmp_path / "port")), gpus=ids)
    ref = jdev.TPUDeviceManager(JStore(str(tmp_path / "ref")), chips=ids)
    steps = [("allocate", "a", 2), ("allocate", "a", 2), ("allocate", "b", 1),
             ("allocate", "a", 3), ("allocate", "c", 1), ("allocate", "b", 2),
             ("allocate", "b", 1), ("release", "a"), ("allocate", "c", 2),
             ("release", "nobody"), ("allocate", "a", 0)]
    seen = []
    for name, *args in steps:
        got = _both(lambda: getattr(port, name)(*args))
        want = _both(lambda: getattr(ref, name)(*args))
        assert got == want, (name, args, got, want)
        assert port.allocated() == ref.allocated() and port.free_gpus() == ref.free_chips()
        seen.append(got)
    assert seen[:6] == [("ok", [0, 1]), ("ok", [0, 1]), ("ok", [2]), ("ok", [0, 1, 3]),
                        ("raises", "failed_precondition"), ("raises", "failed_precondition")]
    assert port.allocated() == {0: "c", 1: "c", 2: "b"}
    # A restart reads the persisted grants; the documents are the reference's.
    again = tdev.GPUDeviceManager(TStore(str(tmp_path / "port")), gpus=ids)
    assert again.allocated() == port.allocated() and again.allocate("c", 2) == [0, 1]
    with open(tmp_path / "port" / tdev.ALLOC_FILE) as f, \
            open(tmp_path / "ref" / jdev.ALLOC_FILE) as g:
        assert json.load(f) == json.load(g) == {"0": "c", "1": "c", "2": "b"}
    with pytest.raises(terr.FailedPrecondition, match="not enough GPUs: want 9, free 1 of 4"):
        again.allocate("d", 9)


def test_the_store_refuses_a_path_outside_its_root(tmp_path):
    store = TStore(str(tmp_path / "s"))
    with pytest.raises(ValueError, match="escapes store root"):
        store.path("..", "elsewhere")
    assert store.read_json_or({"x": 1}, "missing.json") == {"x": 1}
    store.write_json({"k": [1, 2]}, "sub", "doc.json")
    assert store.read_json("sub", "doc.json") == JStore(str(tmp_path / "s")).read_json(
        "sub", "doc.json") == {"k": [1, 2]}
    assert not [f for f in os.listdir(tmp_path / "s" / "sub") if f.startswith(".tmp-")]


def _information(root, bus, minor):
    d = os.path.join(root, "proc", "driver", "nvidia", "gpus", bus)
    os.makedirs(d)
    with open(os.path.join(d, "information"), "w") as f:
        f.write(f"Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\n"
                f"Bus Location: \t {bus}\nDevice Minor: \t {minor}\n"
                "GPU Excluded:\t No\n")


def test_visibility_env_names_each_gpu_by_its_pci_ordinal(tmp_path):
    root = _fake_root(tmp_path)
    env = tdev.GPUDeviceManager.visibility_env
    # No /proc files: the node minors in their order (0 -> 0, 3 -> 1).
    assert tdev.pci_ordinals(root) == {0: 0, 3: 1}
    assert env([3], root) == {"CUDA_VISIBLE_DEVICES": "1", "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
                              "KUKEON_GPU_DEVICES": "/dev/nvidia3"}
    # The module's /proc files: minor 3 sits on the lower bus, so it is CUDA's
    # first GPU in PCI order; minor 1 has no node here and is not counted.
    _information(root, "0000:86:00.0", 0)
    _information(root, "0000:3B:00.0", 3)
    _information(root, "0000:5e:00.0", 1)
    assert tdev.pci_ordinals(root) == {3: 0, 0: 1}
    assert env([0], root)["CUDA_VISIBLE_DEVICES"] == "1"
    assert env([3, 0], root)["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert env([0, 3], root)["KUKEON_GPU_DEVICES"] == "/dev/nvidia0,/dev/nvidia3"
    assert env([], root)["CUDA_VISIBLE_DEVICES"] == ""
    # An id the host does not show keeps its own number (the override's ids).
    assert env([7], str(tmp_path / "none"))["CUDA_VISIBLE_DEVICES"] == "7"
