"""The on-disk metadata store, the port's copy of the part of
``kukeon_tpu/runtime/metadata.py`` that the GPU grants use: JSON documents
under one root, each written atomically (a temporary file renamed into
place) and serialized by an ``fcntl`` lock file at the root, so that
several processes can share the store. The layout is the reference's, so
either package reads the other's documents.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
from typing import Any, Iterator


class MetadataStore:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def path(self, *parts: str) -> str:
        """``root`` joined with ``parts``; a result outside ``root`` (a
        ``..`` among them) is a ``ValueError``."""
        p = os.path.join(self.root, *parts)
        ap = os.path.abspath(p)
        if ap != self.root and not ap.startswith(self.root + os.sep):
            raise ValueError(f"path escapes store root: {parts}")
        return p

    def ensure_dir(self, *parts: str) -> str:
        p = self.path(*parts)
        os.makedirs(p, mode=0o750, exist_ok=True)
        return p

    @contextlib.contextmanager
    def lock(self) -> Iterator[None]:
        """Exclusive advisory lock over the store (its root's ``.lock``)."""
        fd = os.open(os.path.join(self.ensure_dir(), ".lock"), os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def write_json(self, doc: Any, *parts: str) -> str:
        """``doc`` as the JSON document at ``parts``, whole or not at all."""
        p = self.path(*parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p), prefix=".tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
                f.write("\n")
            os.chmod(tmp, 0o640)
            os.replace(tmp, p)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        return p

    def read_json(self, *parts: str) -> Any:
        with open(self.path(*parts)) as f:
            return json.load(f)

    def read_json_or(self, default: Any, *parts: str) -> Any:
        try:
            return self.read_json(*parts)
        except FileNotFoundError:
            return default
