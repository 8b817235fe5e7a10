"""The Llama and MoE families' training on a ``pipe`` x ``data`` x
``fsdp`` x ``expert`` x ``seq`` x ``tensor`` rank group: the port of what
the reference's ``training/cli.py`` runs on a mesh (``create_train_state``,
``make_train_step``, their MoE twins, the pipeline's
``make_pp_train_step`` and the checkpoints over ``make_mesh(...)``).

The reference drives every device of its mesh from one controller. The
port runs one process per device (``parallel/launch.py``): the leader's
:class:`MeshTrainer` posts each action (``new``, ``step``, ``restore``,
``save``, ``gather``) to its followers, which build their own trainer from
the same keyword arguments and apply the same actions in the same order.
No tensor crosses the control socket: every rank draws its blocks of the
init from the seed (or reads them from a recipe), computes its batch rows
from ``(dataset, seed, step)`` (``data.rank_rows`` and ``rank_cols``; the
whole batch in a pipeline, whose step picks its microbatches), and reads
its blocks
of a checkpoint itself; a save sends the blocks to the leader through
``torch.distributed``. A rank that dies ends the group, as in serving.
"""

from __future__ import annotations

import hashlib
import os

import torch

from kukeon_tpu_torch.models import llama, moe, orbax_ckpt
from kukeon_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_PIPE,
                                            AXIS_SEQ, AXIS_TENSOR, AXIS_WORLD)
from kukeon_tpu_torch.parallel.sharding import Recipe, TrainLayout
from kukeon_tpu_torch.training import checkpointing
from kukeon_tpu_torch.training.data import TokenDataset, batches
from kukeon_tpu_torch.training.train_step import (
    create_moe_train_state,
    create_train_state,
    make_moe_train_step,
    make_optimizer,
    make_train_step,
    tree_items,
)

MODELS = {"tiny": llama.llama_tiny, "llama3-1b": llama.llama3_1b,
          "llama3-8b": llama.llama3_8b, "mixtral-tiny": moe.moe_tiny,
          "mixtral-8x7b": moe.mixtral_8x7b}


class MeshTrainer:
    """One rank's train state and step on ``mesh`` (a training
    ``parallel.mesh.Mesh``): ``model`` one of :data:`MODELS` (``cfg``, a
    config that overrides its own: a depth cut), batches of ``batch`` rows
    of ``seq_len`` from ``dataset`` (``--seed``'s schedule), the optimizer
    ``make_optimizer(lr, warmup_steps=, total_steps=)``, the init drawn
    from ``seed`` on the mesh's device as one device draws it, or an
    ``init`` recipe's full leaves (``sharding.Recipe``, ``"leaves"``).
    A mesh with ``pipe`` > 1, or a ``num_microbatches`` given, trains
    through the GPipe step (``parallel.pipeline.make_pp_train_step``, its
    layout's layers cut on ``pipe``); otherwise ``use_ring_attention``
    goes to ``make_train_step``. A MoE model takes no pipeline and no
    ``use_ring_attention`` (a ``ValueError``): the reference's MoE step
    has neither, and attends a seq-cut batch over every key. The leader's
    calls post the same call to every follower."""

    def __init__(self, mesh, *, model: str, dataset: str, batch: int, seq_len: int,
                 seed: int = 0, lr: float = 3e-4, warmup_steps: int = 100,
                 total_steps: int = 10_000, init: Recipe | None = None, cfg=None,
                 num_microbatches: int | None = None, use_ring_attention: bool | None = None):
        kwargs = dict(model=model, dataset=dataset, batch=batch, seq_len=seq_len, seed=seed,
                      lr=lr, warmup_steps=warmup_steps, total_steps=total_steps, init=init,
                      cfg=cfg, num_microbatches=num_microbatches,
                      use_ring_attention=use_ring_attention)
        self.mesh = mesh
        self.cfg = cfg or MODELS[model]()
        self.is_moe = isinstance(self.cfg, moe.MoEConfig)
        self.pipeline = mesh.pipe > 1 or num_microbatches is not None
        if self.pipeline and self.is_moe:
            raise ValueError("pipeline parallelism is llama-only for now")
        if use_ring_attention is not None and self.is_moe:
            raise ValueError(f"use_ring_attention={use_ring_attention}: the MoE step has no "
                             "ring option; on seq it attends over every key")
        self.layout = TrainLayout.of(self.cfg, mesh, pipeline=self.pipeline)
        self.batch, self.seq_len, self.seed = batch, seq_len, seed
        self.ds = TokenDataset(dataset)
        self._group = mesh.group if mesh.leader and mesh.size > 1 else None
        if self._group is not None:
            # Posted first: the followers draw their blocks while this rank
            # draws its own.
            self._oid = self._group.new_id()
            self._group.post(self._oid, "new", (
                "kukeon_tpu_torch.training.mesh_trainer:MeshTrainer", kwargs), flush=True)
        optimizer = make_optimizer(lr, warmup_steps=warmup_steps, total_steps=total_steps)
        generator = torch.Generator(device=mesh.device).manual_seed(seed)
        leaves = None if init is None else init.resolve()(device=mesh.device, **init.kwargs)
        if self.is_moe:
            self.state, self.optimizer = create_moe_train_state(
                self.cfg, generator, mesh.device, optimizer, mesh=mesh, leaves=leaves)
            self._step = make_moe_train_step(self.cfg, optimizer, mesh=mesh)
        else:
            self.state, self.optimizer = create_train_state(
                self.cfg, generator, mesh.device, optimizer, mesh=mesh, leaves=leaves,
                layout=self.layout)
            if self.pipeline:
                from kukeon_tpu_torch.parallel.pipeline import make_pp_train_step

                self._step = make_pp_train_step(self.cfg, optimizer, mesh=mesh,
                                                num_microbatches=num_microbatches)
            else:
                self._step = make_train_step(self.cfg, optimizer, mesh=mesh,
                                             use_ring_attention=use_ring_attention)

    def step(self, step: int):
        """One train step on step ``step``'s batch -> the global loss (a 0-d
        tensor on the device, the same on every rank); a MoE model's
        metrics, ``{"loss", "ce", "load_balance", "router_z"}``."""
        return self._run("step", (step,))

    def restore(self, root: str, step: int | None = None) -> int:
        """Every rank reads its blocks of ``root``'s checkpoint at ``step``
        (default: the newest) into its state -> the step restored."""
        if step is None:
            step = checkpointing.latest_step(root)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {root}")
        return self._run("restore", (root, step))

    def save(self, root: str) -> str:
        """The state as ``<root>/step_<step>`` in the one-device layout,
        written by the leader (a step already on disk is left as it is)."""
        path = checkpointing.step_dir(root, int(self.state.step))
        if os.path.isdir(path):
            return path
        self._run("save", (root,))
        return path

    def full_state(self) -> dict:
        """The whole state on the leader's host, ``{"params.<path>",
        "opt_state.1.0.mu.<path>", "opt_state.1.0.nu.<path>": tensor}``
        (the checkpoint's names), each leaf gathered as a save gathers it;
        None on the other ranks."""
        return self._run("gather", ())

    def replica_mismatches(self) -> list[tuple[str, str]] | None:
        """Every leaf of the state (params and both moments) against its
        peers on each axis its spec does not cut (``data`` and ``seq``
        always; ``fsdp``, ``expert``, ``pipe``, ``tensor`` where it is
        replicated): the
        ``(leaf, axis)`` pairs whose bits differ on some rank of the mesh
        (one sha256 a block, gathered over each axis; the flags summed
        over every rank), on the leader; None on the other ranks."""
        return self._run("replicas", ())

    def _replica_flags(self) -> tuple[list[tuple[str, str]], torch.Tensor]:
        mesh, checks, flags = self.mesh, [], []
        for prefix, tree in (("params", self.state.params),
                             ("mu", self.state.opt_state["mu"]),
                             ("nu", self.state.opt_state["nu"])):
            for path, t in tree_items(tree):
                raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                digest = torch.tensor(list(hashlib.sha256(raw.tobytes()).digest()),
                                      dtype=torch.uint8, device=mesh.device)
                spec = self.layout.spec(path)
                for axis in (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ, AXIS_PIPE,
                             AXIS_TENSOR):
                    if axis in spec or mesh.axis_size(axis) == 1:
                        continue
                    every = mesh.gather(digest, 0, axis).view(-1, digest.numel())
                    checks.append((".".join((prefix, *path)), axis))
                    flags.append(float(not bool((every == digest).all())))
        return checks, mesh.reduce(torch.tensor(flags or [0.0], device=mesh.device),
                                   AXIS_WORLD)

    def _run(self, action: str, args: tuple):
        if self._group is None:
            return self.follow(action, args)
        self._group.post(self._oid, action, args, flush=True)
        try:
            return self.follow(action, args)
        except Exception as e:
            # Its peers may wait in a collective this rank left: end the
            # group (a dead follower, if one caused it, is named).
            self._group.abort(f"rank 0 failed in {action}: {type(e).__name__}: {e}")
            raise

    def follow(self, action: str, args: tuple):
        if action == "step":
            (step,) = args
            _s, tokens, targets, mask = next(batches(
                self.ds, self.batch, self.seq_len, device=self.mesh.device, start_step=step,
                num_steps=1, seed=self.seed, mesh=None if self.pipeline else self.mesh))
            self.state, loss = self._step(self.state, tokens, targets, mask)
            return loss
        if action == "restore":
            root, step = args
            self.state = checkpointing.restore_checkpoint(root, self.state, step,
                                                          layout=self.layout)
            return self.state.step
        if action == "save":
            (root,) = args
            return checkpointing.save_checkpoint(root, self.state, mesh=self.mesh,
                                                 layout=self.layout)
        if action == "gather":
            tree = checkpointing.gathered_tree(self.state, self.mesh, self.layout)
            got = {".".join(k for k, _ in keys): leaf()
                   for keys, leaf in orbax_ckpt.flatten(tree) if callable(leaf)}
            return got if self.mesh.leader else None
        if action == "replicas":
            checks, flags = self._replica_flags()
            bad = [c for c, f in zip(checks, flags.tolist()) if f]
            return bad if self.mesh.leader else None
        raise ValueError(f"unknown trainer action {action!r}")

    def close(self) -> None:
        if self._group is not None:
            self._group.drop(self._oid)
            self._group.flush()
            self._group = None
