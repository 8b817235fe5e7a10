"""Faults planted in one follower rank's process, for the rank-group tests.

A test's leader posts ``new`` with a factory from this module; the
follower imports it by path (``parallel/launch.py``) and the factory
patches that process alone, where ``KUKEON_FAULTS`` never reaches (the
followers start without it)."""

from kukeon_tpu_torch.models import llama


class _Inert:
    """The object the factory leaves in the follower's table."""

    def follow(self, action, args):
        raise AssertionError(f"no action is posted to a planted fault ({action})")


def fail_mlp(mesh, calls: int):
    """This rank's ``llama._mlp`` raises on its ``calls``-th call from now:
    inside a block, after the attention's ``all_reduce`` and before the
    MLP's, so the rank stops partway through the block's collectives."""
    real, seen = llama._mlp, [0]

    def mlp(*args, **kwargs):
        seen[0] += 1
        if seen[0] == calls:
            raise RuntimeError(f"planted in rank {mesh.group.rank}'s MLP")
        return real(*args, **kwargs)

    llama._mlp = mlp
    return _Inert()
