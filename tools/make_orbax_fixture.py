"""Write the orbax test fixture with the JAX package's own calls:
``tests/data/orbax_llama_tiny/`` (``llama_tiny``'s parameters from
``jax.random.key(0)``, saved by ``orbax.checkpoint.StandardCheckpointer``:
zarr chunks in zstd level-1 frames inside an OCDBT store) and
``tests/data/orbax_llama_tiny.json`` (each leaf's dtype, shape and the
sha256 of its bytes as JAX restores them).

    JAX_PLATFORMS=cpu python3 tools/make_orbax_fixture.py

It imports JAX, orbax and the JAX package, so it runs where those are
installed (a CPU host is enough); the port never imports it. The port's
tests hold its reader to the JSON and the JSON to a fresh JAX restore;
``chip_smoke.py`` decodes the fixture on the GPU host and checks every
leaf's hash.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_llama_tiny")
HASHES = FIXTURE + ".json"


def leaf_hashes(tree) -> dict:
    """{dotted leaf name: {"dtype", "shape", "sha256"}} of a restored tree."""
    import jax
    import numpy as np

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        a = np.ascontiguousarray(np.asarray(leaf))
        out[name] = {"dtype": a.dtype.name, "shape": list(a.shape),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return dict(sorted(out.items()))


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp

    from kukeon_tpu.models import llama

    cfg = llama.llama_tiny()
    params = llama.init_params(jax.random.key(0), cfg)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(FIXTURE, params)
    ckptr.wait_until_finished()
    ckptr.close()
    restored = ocp.StandardCheckpointer().restore(
        FIXTURE, jax.eval_shape(lambda k: llama.init_params(k, cfg), jax.random.key(0)))
    with open(HASHES, "w") as f:
        json.dump(leaf_hashes(restored), f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURE) for n in ns)
    print(f"{FIXTURE}: {size} bytes; {HASHES}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
