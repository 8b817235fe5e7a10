"""Serving meshes over a rank group, the port of ``kukeon_tpu/parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over the devices one
controller sees and lets GSPMD insert the collectives. The port runs one
process per device (PyTorch's idiom): a :class:`Mesh` is this process's
view of a rank group (``parallel/launch.py``): its coordinates, the axis
sizes, its device, and it carries the
two collectives the tensor-parallel forward calls,
:meth:`Mesh.all_reduce` and :meth:`Mesh.all_gather`, through
``torch.distributed`` (NCCL on ``cuda``, gloo on ``cpu``) over its
**tensor subgroup**. Serving lays the ranks out as ``data`` x ``tensor``
(:func:`make_mesh`; ``tensor`` innermost, as the reference's
``make_mesh`` orders its axes): each data replica is ``tensor``
consecutive ranks holding the whole model between them, and the replicas
hold the same weights and compute the same step (the reference
replicates its weights and its cache over ``data``). So a mesh's
``rank`` and ``world`` are its **tensor** coordinate and size: every cut
of a weight and every collective reads those, and only the rank group
itself (who leads, how many processes) sees the data axis. Serving keeps
``expert`` at 1, as the reference's ``serving_mesh`` does (a MoE layer's
experts are cut on ``tensor`` inside each expert); ``seq`` and ``pipe``
keep the reference's names for the slice that adds them (ROADMAP.md A13d).

Training adds ``fsdp`` and ``expert`` (:func:`make_mesh`'s ``fsdp=`` and
``expert=``, :func:`training_mesh`): the ranks are laid out ``data`` x
``fsdp`` x ``expert`` x ``tensor`` in the reference's order (``tensor``
innermost), so global rank ``((d * fsdp + f) * expert + x) * tensor + t``
holds coordinates ``(d, f, x, t)``. ``rank`` and ``world`` stay the tensor
coordinate and size, ``fsdp_rank`` and ``expert_rank`` are the fsdp and
expert coordinates, and :meth:`Mesh.reduce`, :meth:`Mesh.gather` and
:meth:`Mesh.reduce_scatter` run over a named axis group: ``tensor``,
``fsdp``, ``expert``, ``data``, ``batch`` (data x fsdp: the ranks that
split a batch's rows, where gradients and the loss's sums are reduced; an
expert peer shares its rows, as in the reference's batch spec), or
``expert_tensor`` (expert x tensor: the ranks that share one batch rank's
rows, over which a MoE block's partial sums once), each a
``torch.distributed`` subgroup made at the rendezvous (``launch.py``). A
collective over an axis of size 1 is the identity, so a one-rank mesh
computes what one device does, bit for bit.

Counterparts in the reference: the axis names :28-33, ``make_mesh`` :40,
``serving_mesh`` :121, ``training_mesh`` :136, ``largest_pow2_leq`` :146,
``auto_mesh_shape`` :151.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"
# Not a reference axis: the ranks that split a batch's rows, data x fsdp
# (the reference's batch spec ``P((data, fsdp), seq)``).
AXIS_BATCH = "batch"
# Nor this: the ranks of one batch rank, expert x tensor (a MoE block's
# partial over its local experts and intermediate columns sums over them).
AXIS_EXPERT_TENSOR = "expert_tensor"
AXIS_WORLD = "world"        # every rank of the mesh

# Gloo ranks a CPU host offers a grant: the CPU has no device count, so the
# port takes the reference's forced host-platform count (its tests' 8).
CPU_RANKS = 8


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 1


def auto_mesh_shape(n_devices: int) -> dict[str, int]:
    """The reference's heuristic serving layout: tensor up to 8, data
    beyond; ``data * tensor == n_devices`` always (a count with no divisor
    <= 8 but itself puts every device on tensor)."""
    if n_devices < 1:
        raise ValueError(f"auto_mesh_shape needs >= 1 device, got {n_devices}")
    tensor = max(d for d in range(1, min(8, n_devices) + 1) if n_devices % d == 0)
    return {"data": n_devices // tensor, "tensor": tensor}


def visible_devices(device_type: str) -> int:
    """Devices a grant may take on this host: the visible GPUs on ``cuda``
    (``CUDA_VISIBLE_DEVICES`` narrows them), :data:`CPU_RANKS` gloo ranks
    on ``cpu``."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return CPU_RANKS


def check_grant(n: int, device_type: str) -> int:
    """The reference's ``serving_mesh`` checks: a grant is exact, so ``n``
    below 1 or above what this host can see is a ``ValueError``. -> n."""
    if n < 1:
        raise ValueError(f"serving mesh needs >= 1 device, got {n}")
    visible = visible_devices(device_type)
    if n > visible:
        raise ValueError(
            f"serving mesh wants {n} {'GPUs' if device_type == 'cuda' else 'CPU ranks'} "
            f"but only {visible} visible (check the cell's chip grant"
            f"{' / CUDA_VISIBLE_DEVICES' if device_type == 'cuda' else ''})")
    return n


def serving_mesh(n_devices: int | None = None, device: str = "cuda") -> "Mesh":
    """All ranks on ``tensor``: the reference's latency layout for one
    model. ``n_devices`` is a hard request (None: every visible device):
    asking for more than the host shows fails here, before any process
    starts. Returns rank 0's mesh (:func:`make_mesh`)."""
    dtype = torch.device(device).type
    n = check_grant(visible_devices(dtype) if n_devices is None else n_devices, dtype)
    return make_mesh(tensor=n, device=device)


def make_mesh(data: int = 1, tensor: int = 1, device: str = "cuda", *,
              fsdp: int = 1, expert: int = 1) -> "Mesh":
    """The reference's ``make_mesh(data=, fsdp=, expert=, tensor=)``: rank
    0's mesh over this process's group of ``data * fsdp * expert *
    tensor`` ranks (:func:`kukeon_tpu_torch.parallel.launch.group`),
    started now with that many less one followers, or reused when one of
    that shape is open. More ranks than the host shows is a
    ``ValueError``."""
    # Imported here: a follower runs launch as ``__main__``, after this
    # package's __init__ has imported this module.
    from kukeon_tpu_torch.parallel import launch

    if min(data, tensor, fsdp, expert) < 1:
        raise ValueError(f"mesh axes must be >= 1, got data {data} x fsdp {fsdp} x "
                         f"expert {expert} x tensor {tensor}")
    dtype = torch.device(device).type
    n = check_grant(data * fsdp * expert * tensor, dtype)
    return Mesh(launch.group(n, dtype, tensor=tensor, fsdp=fsdp, expert=expert))


def training_mesh(n_devices: int | None = None, tensor: int = 1,
                  device: str = "cuda") -> "Mesh":
    """The reference's ``training_mesh``: ``fsdp`` over whatever
    ``tensor`` leaves of ``n_devices`` (None: every visible device)."""
    dtype = torch.device(device).type
    n = visible_devices(dtype) if n_devices is None else n_devices
    if n % tensor:
        raise ValueError(f"{n} devices not divisible by tensor={tensor}")
    return make_mesh(fsdp=n // tensor, tensor=tensor, device=device)


class Mesh:
    """This process's view of a rank group: ``rank`` and ``world``, its
    coordinate on ``tensor`` and that axis's size (what every weight is cut
    by); ``replica``, its coordinate on ``data``; ``fsdp_rank`` and
    ``fsdp``, ``expert_rank`` and ``expert``, its coordinates on those axes
    and their sizes; ``size``, the ranks of the mesh (``data * fsdp *
    expert * tensor``, the group's processes); ``shape`` (serving's axes:
    ``expert`` 1, as the reference's ``serving_mesh``) and ``axes`` (all
    six, in the reference's order); its ``device``; and the collectives.
    Each collective sums or gathers in the tensor's own dtype, as the
    reference's ``psum`` does, and is one ``torch.distributed`` call on
    the current stream (captured inside the CUDA graphs like any kernel).
    :meth:`all_reduce` and :meth:`all_gather` run over the tensor subgroup
    (the serving forwards'); :meth:`reduce`, :meth:`gather` and
    :meth:`reduce_scatter` over a named axis group."""

    def __init__(self, group):
        self.group = group
        self.size = group.world
        self.world = group.tensor
        self.fsdp = group.fsdp
        self.expert = group.expert
        self.rank = group.rank % group.tensor
        self.expert_rank = group.rank // group.tensor % group.expert
        self.fsdp_rank = group.rank // (group.tensor * group.expert) % group.fsdp
        self.replica = group.rank // (group.tensor * group.expert * group.fsdp)
        self.data = self.size // (self.world * self.expert * self.fsdp)
        self.device = group.device
        self.shape = {AXIS_DATA: self.data, AXIS_EXPERT: 1, AXIS_TENSOR: self.world}
        self.axes = {AXIS_PIPE: 1, AXIS_DATA: self.data, AXIS_FSDP: self.fsdp,
                     AXIS_EXPERT: self.expert, AXIS_SEQ: 1, AXIS_TENSOR: self.world}
        self._pg = group.tensor_pg
        self._sizes = {AXIS_TENSOR: self.world, AXIS_FSDP: self.fsdp, AXIS_DATA: self.data,
                       AXIS_EXPERT: self.expert, AXIS_BATCH: self.data * self.fsdp,
                       AXIS_EXPERT_TENSOR: self.expert * self.world, AXIS_WORLD: self.size}

    def axis_size(self, axis: str) -> int:
        """The ranks of this rank's ``axis`` group."""
        return self._sizes[axis]

    @property
    def leader(self) -> bool:
        return self.group.rank == 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the tensor subgroup, in place (a contiguous copy
        of a strided ``x``); returns the sum."""
        x = x.contiguous()
        dist.all_reduce(x, group=self._pg)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every tensor peer's ``x`` concatenated along ``dim`` in tensor
        order."""
        return _gather(x, dim, self.world, self._pg)

    def reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over this rank's ``axis`` group, as a new
        tensor (``x`` itself over an axis of one rank)."""
        if self._sizes[axis] == 1:
            return x
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group.pgs.get(axis))
        return out

    def gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """Every ``axis`` peer's ``x`` concatenated along ``dim`` in the
        axis's order (``x`` itself over one rank)."""
        n = self._sizes[axis]
        return x if n == 1 else _gather(x, dim, n, self.group.pgs.get(axis))

    def reduce_scatter(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``x`` over its
        ``axis`` group (``x`` itself over one rank): :meth:`gather`'s
        adjoint."""
        n = self._sizes[axis]
        if n == 1:
            return x
        dim = dim % x.ndim
        parts = x.movedim(dim, 0).contiguous()           # n blocks along dim 0
        out = parts.new_empty((parts.shape[0] // n, *parts.shape[1:]))
        # (torch 2.13's name; the GPU host's 2.11 has only the old one.)
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, parts, group=self.group.pgs.get(axis))
        return out.movedim(0, dim)

    def __repr__(self) -> str:
        return (f"Mesh(data {self.replica}/{self.data}, fsdp {self.fsdp_rank}/{self.fsdp}, "
                f"expert {self.expert_rank}/{self.expert}, tensor {self.rank}/{self.world}, "
                f"device={self.device})")


def _gather(x: torch.Tensor, dim: int, n: int, pg) -> torch.Tensor:
    flat = x.contiguous().reshape(-1)
    out = torch.empty((n * flat.numel(),), dtype=x.dtype, device=x.device)
    # torch 2.13 renames all_gather_into_tensor (and warns on the old
    # name); the GPU host's 2.11 has only the old one.
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, flat, group=pg)
    dim = dim % x.ndim
    parts = out.view(n, *x.shape)
    return parts.movedim(0, dim).reshape(
        *x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])
