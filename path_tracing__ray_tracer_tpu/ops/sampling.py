"""Monte-Carlo sampling primitives for the path tracer.

Vectorized counterparts of the reference device functions: cosine-weighted
hemisphere sampling with the same tangent-frame construction
(``cuda_path_tracer.py:139-180``) and uniform point-light selection with
``pdf = 1/num_lights`` (``cuda_path_tracer.py:183-210`` — deliberately no
geometric/solid-angle term, SURVEY.md §2 quirk 6).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..compiler import CompiledScene
from .select_table import SELECT_LIMIT, take_rows
from .v3 import V3

TWO_PI = 6.283185307179586


def cosine_hemisphere(normal: V3, r1: jnp.ndarray, r2: jnp.ndarray) -> V3:
    """Cosine-weighted direction about ``normal`` from two uniforms."""
    cos_theta = jnp.sqrt(r1)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - r1, 0.0))
    phi = TWO_PI * r2
    lx = sin_theta * jnp.cos(phi)
    ly = sin_theta * jnp.sin(phi)
    lz = cos_theta

    # reference tangent frame: nt = |n.z| > 0.9 ? x̂ : ẑ ; u = nt × n ; v = n × u
    steep = jnp.abs(normal.z) > 0.9
    nt = V3.where(steep, V3.full(0.0, normal.x.shape) + V3.of(1.0, 0.0, 0.0),
                  V3.full(0.0, normal.x.shape) + V3.of(0.0, 0.0, 1.0))
    u = nt.cross(normal).normalized()
    v = normal.cross(u)
    return u * lx + v * ly + normal * lz


def pick_light(cs: CompiledScene, point: V3, r: jnp.ndarray):
    """Uniformly pick one light sample per ray.

    Returns ``(direction, distance, pdf)`` with ``pdf = 1/num_lights``.
    """
    n_lights = cs.n_lights
    li = jnp.minimum((r * n_lights).astype(jnp.int32), n_lights - 1)
    if n_lights <= SELECT_LIMIT:
        # gather-free row pick (ops/select_table.py).  Bit-exact vs .take.
        lx, ly, lz = take_rows(li, (cs.lights.x, cs.lights.y, cs.lights.z))
        lp = V3(lx, ly, lz)
    else:
        lp = cs.lights.at_index(li)
    to_light = lp - point
    dist = to_light.norm()
    ldir = to_light * (1.0 / jnp.where(dist > 0.001, dist, 1.0))
    pdf = jnp.float32(1.0 / n_lights)
    return ldir, dist, pdf
