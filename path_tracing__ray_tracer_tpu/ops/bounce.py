"""The path tracer's per-bounce record and constants.

One bounce (closest hit, next-event estimation with a shadow query, Russian
roulette and the scatter event) is computed either by the XLA formulation
(``models/path_tracer._bounce_xla``) or by the fused GPU kernel
(``ops/pallas/bounce_triton.py``).  Both return the same ``BounceOut``
weight record: the base color enters only multiplicatively, so the bounce
emits shading *weights* and the regeneration driver resolves textures and
applies

    radiance += thr · (w_sky + base · w_nee)
    thr      *= rr_scale · (s_thr + base · t_thr)
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .v3 import V3

T_MIN = 1e-3
T_MAX = 1e6
EPS_OFFSET = 1e-3
SKY = 0.1

# RNG "use" slots per bounce
U_LIGHT, U_RR, U_EVENT, U_HEMI1, U_HEMI2 = 0, 1, 2, 3, 4
# jitter slots live at depth == max_depth (outside the bounce counter range)
U_JITX, U_JITY = 0, 1

# glass event mixture (cuda_path_tracer.py:323-326)
P_REFRACT, P_REFLECT, P_DIFFUSE = 0.6, 0.25, 0.15


class BounceOut(NamedTuple):
    hit: jnp.ndarray  # bool
    killed: jnp.ndarray  # bool: Russian roulette ended the path
    w_sky: jnp.ndarray
    w_nee: jnp.ndarray
    rr_scale: jnp.ndarray
    s_thr: jnp.ndarray
    t_thr: jnp.ndarray
    new_org: V3
    new_dir: V3
    u: jnp.ndarray
    v: jnp.ndarray
    tex_id: jnp.ndarray  # float; < 0 when untextured
    mat_color: V3
