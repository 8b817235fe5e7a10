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
train on a mesh only.

Training adds ``fsdp``, ``expert``, ``seq`` and ``pipe`` (:func:`make_mesh`'s
keywords, :func:`training_mesh`): the ranks are laid out ``pipe`` x
``data`` x ``fsdp`` x ``expert`` x ``seq`` x ``tensor``, the reference's
order (``pipe`` outermost, ``tensor`` innermost), so global rank
``((((p * data + d) * fsdp + f) * expert + x) * seq + s) * tensor + t``
holds coordinates ``(p, d, f, x, s, t)``; at ``seq = pipe = 1`` every rank
keeps the coordinates it had before those axes existed. ``rank`` and
``world`` stay the tensor coordinate and size; ``fsdp_rank``,
``expert_rank``, ``seq_rank`` and ``pipe_rank`` are the other
coordinates. :meth:`Mesh.reduce`, :meth:`Mesh.gather`,
:meth:`Mesh.reduce_scatter` and :meth:`Mesh.all_to_all` run over a named
axis group: ``tensor``, ``fsdp``, ``expert``, ``seq``, ``pipe``, ``data``,
``batch`` (data x fsdp x seq: the ranks that split a batch's tokens,
where gradients and the loss's sums are reduced; an expert peer shares
its rows, as in the reference's batch spec ``P((data, fsdp), seq)``),
``data_seq`` (data x seq: where an fsdp-cut leaf's gradient is summed
after its reduce-scatter over ``fsdp``) or ``expert_tensor`` (expert x
tensor: the ranks that share one batch rank's rows, over which a MoE
block's partial sums once), each a ``torch.distributed`` subgroup made at
the rendezvous (``launch.py``); :meth:`Mesh.peer` names the global rank
of a coordinate on an axis, for the ring's and the pipeline's
point-to-point hops. A collective over an axis of size 1 is the
identity, so a one-rank mesh computes what one device does, bit for bit.

Counterparts in the reference: the axis names :28-33, ``make_mesh`` :40,
``serving_mesh`` :121, ``training_mesh`` :136, ``largest_pow2_leq`` :146,
``auto_mesh_shape`` :151.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"
# Not a reference axis: the ranks that split a batch's tokens, data x fsdp
# x seq (the reference's batch spec ``P((data, fsdp), seq)``).
AXIS_BATCH = "batch"
# Nor this: data x seq, the ranks an fsdp-cut leaf's gradient is summed
# over once its reduce-scatter over ``fsdp`` has summed that axis.
AXIS_DATA_SEQ = "data_seq"
# Nor this: the ranks of one batch rank, expert x tensor (a MoE block's
# partial over its local experts and intermediate columns sums over them).
AXIS_EXPERT_TENSOR = "expert_tensor"
AXIS_WORLD = "world"        # every rank of the mesh
# The six axes, outermost first: the order of a global rank's coordinates.
AXES = (AXIS_PIPE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR)

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
    (a cell's ``runtime.devices.GPUDeviceManager.visibility_env`` narrows
    them to its grant), :data:`CPU_RANKS` gloo ranks
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
        cuda = device_type == "cuda"
        grant = ("GPU grant, the env of runtime.devices.GPUDeviceManager.visibility_env"
                 if cuda else "chip grant")
        raise ValueError(
            f"serving mesh wants {n} {'GPUs' if cuda else 'CPU ranks'} "
            f"but only {visible} visible (check the cell's {grant})")
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
              fsdp: int = 1, expert: int = 1, seq: int = 1, pipe: int = 1) -> "Mesh":
    """The reference's ``make_mesh(data=, fsdp=, tensor=, seq=, expert=,
    pipe=)``: rank 0's mesh over this process's group of ``pipe * data *
    fsdp * expert * seq * tensor`` ranks
    (:func:`kukeon_tpu_torch.parallel.launch.group`), started now with
    that many less one followers, or reused when one of that shape is
    open. More ranks than the host shows is a ``ValueError``."""
    # Imported here: a follower runs launch as ``__main__``, after this
    # package's __init__ has imported this module.
    from kukeon_tpu_torch.parallel import launch

    if min(data, tensor, fsdp, expert, seq, pipe) < 1:
        raise ValueError(f"mesh axes must be >= 1, got pipe {pipe} x data {data} x fsdp "
                         f"{fsdp} x expert {expert} x seq {seq} x tensor {tensor}")
    dtype = torch.device(device).type
    n = check_grant(pipe * data * fsdp * expert * seq * tensor, dtype)
    return Mesh(launch.group(n, dtype, tensor=tensor, fsdp=fsdp, expert=expert, seq=seq,
                             pipe=pipe))


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
    ``fsdp``, ``expert_rank`` and ``expert``, ``seq_rank`` and ``seq``,
    ``pipe_rank`` and ``pipe``, its coordinates on those axes and their
    sizes; ``size``, the ranks of the mesh (the group's processes);
    ``shape`` (serving's axes: ``expert`` 1, as the reference's
    ``serving_mesh``) and ``axes`` (all six, in the reference's order);
    its ``device``; and the collectives.
    Each collective sums or gathers in the tensor's own dtype, as the
    reference's ``psum`` does, and is one ``torch.distributed`` call on
    the current stream (captured inside the CUDA graphs like any kernel).
    :meth:`all_reduce` and :meth:`all_gather` run over the tensor subgroup
    (the serving forwards'); :meth:`reduce`, :meth:`gather`,
    :meth:`reduce_scatter` and :meth:`all_to_all` over a named axis
    group."""

    def __init__(self, group):
        self.group = group
        self.size = group.world
        self.world = group.tensor
        self.fsdp = group.fsdp
        self.expert = group.expert
        self.seq = group.seq
        self.pipe = group.pipe
        self.data = self.size // (self.world * self.seq * self.expert * self.fsdp * self.pipe)
        self.axes = {AXIS_PIPE: self.pipe, AXIS_DATA: self.data, AXIS_FSDP: self.fsdp,
                     AXIS_EXPERT: self.expert, AXIS_SEQ: self.seq, AXIS_TENSOR: self.world}
        # Innermost first: the stride of each axis in the global rank.
        self._stride, coords, r = {}, {}, group.rank
        stride = 1
        for axis in reversed(AXES):
            n = self.axes[axis]
            self._stride[axis] = stride
            coords[axis] = r % n
            r //= n
            stride *= n
        self.rank, self.seq_rank, self.expert_rank = (coords[AXIS_TENSOR], coords[AXIS_SEQ],
                                                      coords[AXIS_EXPERT])
        self.fsdp_rank, self.replica, self.pipe_rank = (coords[AXIS_FSDP], coords[AXIS_DATA],
                                                        coords[AXIS_PIPE])
        self._coords = coords
        self.device = group.device
        self.shape = {AXIS_DATA: self.data, AXIS_EXPERT: 1, AXIS_TENSOR: self.world}
        self._pg = group.tensor_pg
        self._sizes = {AXIS_TENSOR: self.world, AXIS_FSDP: self.fsdp, AXIS_DATA: self.data,
                       AXIS_EXPERT: self.expert, AXIS_SEQ: self.seq, AXIS_PIPE: self.pipe,
                       AXIS_BATCH: self.data * self.fsdp * self.seq,
                       AXIS_DATA_SEQ: self.data * self.seq,
                       AXIS_EXPERT_TENSOR: self.expert * self.world, AXIS_WORLD: self.size}

    def axis_size(self, axis: str) -> int:
        """The ranks of this rank's ``axis`` group."""
        return self._sizes[axis]

    def coord(self, axis: str) -> int:
        """This rank's coordinate on one of the six axes."""
        return self._coords[axis]

    def peer(self, axis: str, index: int) -> int:
        """The global rank of the rank at coordinate ``index`` (mod the
        axis's size) on one of the six axes, and this rank's on the
        others."""
        n = self._sizes[axis]
        return self.group.rank + ((index % n) - self._coords[axis]) * self._stride[axis]

    def without(self, *axes: str) -> "Mesh":
        """This mesh as a computation that cuts nothing on ``axes``
        (``fsdp``, ``seq``) sees it: those axes of one rank, at coordinate
        0, so every collective over them is the identity; the other axes,
        the group and the device as they are. A pipeline stage's blocks
        run on it: the pipeline's specs cut no leaf on ``fsdp`` and its
        microbatches are whole sequences."""
        view = copy.copy(self)
        view._sizes, view.axes = dict(self._sizes), dict(self.axes)
        for axis in axes:
            size, coord = {AXIS_FSDP: ("fsdp", "fsdp_rank"), AXIS_SEQ: ("seq", "seq_rank")}[axis]
            setattr(view, size, 1)
            setattr(view, coord, 0)
            view._sizes[axis] = view.axes[axis] = 1
        return view

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

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   axis: str) -> torch.Tensor:
        """The reference's tiled ``all_to_all``: ``x`` cut into ``n``
        blocks along ``split_dim``, block j sent to the ``axis`` peer j,
        and the blocks received concatenated along ``concat_dim`` in the
        axis's order (``x`` itself over one rank). Its own adjoint with
        the two dims swapped."""
        n = self._sizes[axis]
        if n == 1:
            return x
        split_dim, concat_dim = split_dim % x.ndim, concat_dim % x.ndim
        shape = list(x.shape)
        shape[split_dim:split_dim + 1] = [n, shape[split_dim] // n]
        parts = x.reshape(shape).movedim(split_dim, 0).contiguous()
        out = torch.empty_like(parts)
        dist.all_to_all_single(out, parts, group=self.group.pgs.get(axis))
        # out[j]: peer j's block, which lies at the peer's place along
        # concat_dim (shifted by one: the leading block axis).
        out = out.movedim(0, concat_dim)
        shape = list(out.shape)
        shape[concat_dim:concat_dim + 2] = [shape[concat_dim] * shape[concat_dim + 1]]
        return out.reshape(shape)

    def __repr__(self) -> str:
        return (f"Mesh(pipe {self.pipe_rank}/{self.pipe}, data {self.replica}/{self.data}, "
                f"fsdp {self.fsdp_rank}/{self.fsdp}, expert {self.expert_rank}/{self.expert}, "
                f"seq {self.seq_rank}/{self.seq}, tensor {self.rank}/{self.world}, "
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
