"""Persisted serving-tune profiles and per-layer profiles, the port of
``kukeon_tpu/serving/tuning.py`` (its whole file, the same format and keys).

``tools/autotune.py`` sweeps the serving levers (decode-chunk size, int8
KV cache, prefill bucket ladder, paged KV page size) on the card and
persists the winning configuration here; ``ServingEngine`` and
``ServingCell`` consult the profile at boot for every lever the caller left
``None``. The profile file (default ``~/.kuke/serving_tune.json``, override
with ``KUKEON_TUNE_PATH``) is one JSON object keyed ``model|backend|n_chips``:
a profile tuned for llama3-8b on one GPU is never applied to a CPU run of
the same model, to another model or to another chip count; a stale key is
simply ignored. The port's backend is ``"gpu"`` on a CUDA device (what
``jax.default_backend()`` calls one) and ``"cpu"`` on the CPU
(:func:`backend_name`), with ``n_chips`` the engine's device count (its
mesh's world, 1 without one). ``mesh_tensor`` and ``kv_shard`` are the
reference's sharding levers: an engine takes ``kv_shard`` and refuses a
``mesh_tensor`` other than its world (a data axis, not ported yet). The
per-layer profiles of
``obs/profile.py``'s ``profile_layers`` live beside it
(``~/.kuke/layer_profile.json``, ``KUKEON_LAYER_PROFILE_PATH``) under the
same keys, so the reference's ``kuke profile layers`` reads the port's
files and the port reads the reference's.

Counterparts in the reference: ``ServingTune`` :30, ``profile_path`` :92,
``profile_key`` :98, ``_read_all`` :102, ``load`` :113,
``layer_profile_path`` :136, ``load_layer_profile`` :143,
``load_layer_profiles`` :156, ``save_layer_profile`` :163, ``save`` :191.
Import-light on purpose (no torch): a tuning tool reads and writes
profiles without touching the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

_DEFAULT_PATH = os.path.join("~", ".kuke", "serving_tune.json")


@dataclasses.dataclass(frozen=True)
class ServingTune:
    """One winning serving configuration for a (model, backend, chips) key."""

    decode_chunk: int = 16
    kv_cache_int8: bool = False
    # None keeps the engine's default bucket ladder.
    prefill_buckets: tuple[int, ...] | None = None
    # Paged KV cache page size (serving/kv_pages.py): None/0 keeps the
    # legacy slot-contiguous layout; > 0 serves from a block-table page
    # pool with pages of this many KV rows. A swept page size is an HBM/
    # concurrency lever like the others — it must tile max_seq_len and the
    # prefill buckets, which the engine validates at boot.
    kv_page_tokens: int | None = None
    # Sharding layout (the multi-chip sweep): tensor-axis size of the
    # winning mesh (None = whatever the cell's chip grant dictates) and
    # whether the KV pool shards over it (None = the engine's divisibility
    # default, False = replicate the cache — bigger HBM, no gathers).
    mesh_tensor: int | None = None
    kv_shard: bool | None = None
    # Provenance (not consumed by the engine, kept for operators/debugging).
    tok_per_s: float | None = None
    tuned_at: str | None = None

    def to_dict(self) -> dict:
        d = {
            "decode_chunk": int(self.decode_chunk),
            "kv_cache_int8": bool(self.kv_cache_int8),
        }
        if self.prefill_buckets:
            d["prefill_buckets"] = [int(b) for b in self.prefill_buckets]
        if self.kv_page_tokens:
            d["kv_page_tokens"] = int(self.kv_page_tokens)
        if self.mesh_tensor:
            d["mesh_tensor"] = int(self.mesh_tensor)
        if self.kv_shard is not None:
            d["kv_shard"] = bool(self.kv_shard)
        if self.tok_per_s is not None:
            d["tok_per_s"] = round(float(self.tok_per_s), 2)
        if self.tuned_at:
            d["tuned_at"] = self.tuned_at
        return d

    @staticmethod
    def from_dict(d: dict) -> "ServingTune":
        buckets = d.get("prefill_buckets")
        return ServingTune(
            decode_chunk=max(1, int(d["decode_chunk"])),
            kv_cache_int8=bool(d.get("kv_cache_int8", False)),
            prefill_buckets=(tuple(sorted({int(b) for b in buckets}))
                             if buckets else None),
            kv_page_tokens=(int(d["kv_page_tokens"])
                            if d.get("kv_page_tokens") else None),
            mesh_tensor=(int(d["mesh_tensor"])
                         if d.get("mesh_tensor") else None),
            kv_shard=(bool(d["kv_shard"])
                      if d.get("kv_shard") is not None else None),
            tok_per_s=(float(d["tok_per_s"])
                       if d.get("tok_per_s") is not None else None),
            tuned_at=d.get("tuned_at"),
        )


def profile_path(path: str | None = None) -> str:
    return os.path.expanduser(
        path or os.environ.get("KUKEON_TUNE_PATH") or _DEFAULT_PATH
    )


def profile_key(model: str, backend: str, n_chips: int) -> str:
    return f"{model}|{backend}|{int(n_chips)}"


def backend_name(device) -> str:
    """The backend part of a profile key for a torch device (anything with
    a ``type``): ``"gpu"`` for CUDA, as the reference keys a GPU, else the
    device type (``"cpu"``)."""
    kind = getattr(device, "type", str(device))
    return "gpu" if kind == "cuda" else kind


def _read_all(path: str) -> dict:
    try:
        with open(path) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        # Missing or corrupt profile: serving must boot with defaults, never
        # die to a bad tuning file.
        return {}


def load(model: str | None, backend: str, n_chips: int,
         path: str | None = None) -> ServingTune | None:
    """The stored tune for this exact (model, backend, chips) key, or None.

    Any mismatch — other model, other backend, other slice size, unreadable
    file, malformed entry — is a miss, not an error: a stale profile must
    degrade to defaults silently."""
    if not model:
        return None
    entry = _read_all(profile_path(path)).get(
        profile_key(model, backend, n_chips)
    )
    if not isinstance(entry, dict):
        return None
    try:
        return ServingTune.from_dict(entry)
    except (KeyError, TypeError, ValueError):
        return None


_LAYER_PROFILE_DEFAULT_PATH = os.path.join("~", ".kuke", "layer_profile.json")


def layer_profile_path(path: str | None = None) -> str:
    return os.path.expanduser(
        path or os.environ.get("KUKEON_LAYER_PROFILE_PATH")
        or _LAYER_PROFILE_DEFAULT_PATH
    )


def load_layer_profile(model: str | None, backend: str, n_chips: int,
                       path: str | None = None) -> dict | None:
    """The persisted per-layer cost profile (obs/profile.profile_layers)
    for this exact (model, backend, chips) key, or None — same miss-not-
    error contract as the serving tune next door."""
    if not model:
        return None
    entry = _read_all(layer_profile_path(path)).get(
        profile_key(model, backend, n_chips)
    )
    return entry if isinstance(entry, dict) else None


def load_layer_profiles(path: str | None = None) -> dict[str, dict]:
    """Every persisted layer profile, keyed ``model|backend|n_chips`` —
    what `kuke profile layers` lists and substring-matches against."""
    return {k: v for k, v in _read_all(layer_profile_path(path)).items()
            if isinstance(v, dict)}


def save_layer_profile(model: str, backend: str, n_chips: int,
                       profile: dict, path: str | None = None) -> str:
    """Merge one per-layer cost profile under its key; returns the path.
    Same atomic read-modify-write as :func:`save` — the pipeline-split
    planner reading this file mid-write must never see a torn JSON."""
    p = layer_profile_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    entries = _read_all(p)
    profile = dict(profile)
    profile.setdefault(
        "profiled_at", time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
    entries[profile_key(model, backend, n_chips)] = profile
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                               prefix=".layer_profile-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(entries, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return p


def save(model: str, backend: str, n_chips: int, tune: ServingTune,
         path: str | None = None) -> str:
    """Merge ``tune`` into the profile file under its key; returns the path.

    Read-modify-write of the whole file with an atomic rename, so profiles
    for other models/backends survive and a crashed writer never leaves a
    truncated file behind."""
    p = profile_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    entries = _read_all(p)
    if tune.tuned_at is None:
        tune = dataclasses.replace(
            tune, tuned_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        )
    entries[profile_key(model, backend, n_chips)] = tune.to_dict()
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                               prefix=".serving_tune-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(entries, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return p
