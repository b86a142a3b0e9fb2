"""Gather-free small-table row lookup via an exact select chain.

Fetching a K-field record by per-lane index costs K gathers.  For *small*
tables the same lookup is a chain of lane-wise selects — elementwise work
that XLA fuses into the surrounding loop body.  Which form is faster on the
H100 is unmeasured (ROADMAP S7).

The chain is **bit-exact**: no arithmetic touches the values, each lane
takes exactly the row its index names.  Out-of-range indices (< 0 or ≥ U)
resolve to row U−1's value for negatives via the final ``where`` fallthrough
— callers clamp first, exactly as they did for the gather form.

Used for the per-primitive material record (via a per-prim unique-material
id, ``compiler.compile_scene``) and the NEE light-sample pick
(``ops/sampling.pick_light``).  The reference has no analogue — its CUDA
threads do scalar indexed loads (``cuda_path_tracer.py:496-730``).
"""
from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

# Above this row count the select chain's linear cost approaches gather
# territory and tables stop being "small"; callers fall back to gathers.
SELECT_LIMIT = 128


def take_rows(idx: jnp.ndarray, tables: Sequence[jnp.ndarray]):
    """Row ``idx`` of each (U,)-table, by select chain (see module doc).

    ``idx`` must be pre-clamped to ``[0, U)``.  The equality masks are built
    once and shared across all fields (XLA CSE would merge them anyway; this
    keeps the emitted HLO small).
    """
    U = int(tables[0].shape[0])
    masks = [idx == m for m in range(U - 1)]
    outs = []
    for tb in tables:
        out = jnp.broadcast_to(tb[U - 1], idx.shape)
        for m in range(U - 2, -1, -1):
            out = jnp.where(masks[m], tb[m], out)
        outs.append(out)
    return outs
