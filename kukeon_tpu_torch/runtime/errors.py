"""The errors the port's GPU grants raise, its copy of the part of
``kukeon_tpu/runtime/errors.py`` they use (``KukeonError`` :11,
``FailedPrecondition`` :27): the same names and wire codes, so a caller
that maps the reference's codes maps these too.
"""

from __future__ import annotations


class KukeonError(Exception):
    """Base class; ``code`` crosses the RPC boundary."""

    code = "internal"


class FailedPrecondition(KukeonError):
    code = "failed_precondition"
