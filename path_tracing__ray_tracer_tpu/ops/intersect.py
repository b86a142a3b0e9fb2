"""Wavefront scene intersection: all rays vs all primitives, SoA, branchless.

The wavefront form of the reference's sequential per-thread
``cuda_scene_hit`` (``cuda_texture_renderer.py:433-704``).  Instead of one
thread walking the primitive list with scalar control flow, a whole ray batch
advances together: every (ray, primitive) candidate is evaluated as
elementwise array math and reduced to the closest one.  Tie-breaking matches
the reference exactly: primitives are ordered plane → sphere → quad →
triangle and the first minimum wins, as with its strict ``<`` scan.

Three routes, chosen by scene shape: the broadcast sweep (up to
``BROADCAST_LIMIT`` primitives), the BVH walk for triangle meshes
(``ops/bvh.py``), and a sequential ``fori_loop`` sweep for large scenes
compiled without a BVH.

Winner attributes (normal, UV, hit point) are *recomputed* once per ray from
gathered primitive data after the reduction, instead of being carried through
the loop — 3 small vector passes instead of 40 carried registers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..compiler import CompiledScene, MatSoA
from .v3 import V3

EPS = 1e-6


class SceneHit(NamedTuple):
    hit: jnp.ndarray  # (N,) bool
    t: jnp.ndarray  # (N,) f32
    point: V3  # (N,)
    normal: V3  # (N,)  — triangles flipped toward the ray, as in the reference
    u: jnp.ndarray  # (N,)
    v: jnp.ndarray  # (N,)
    prim: jnp.ndarray  # (N,) int32 global primitive index (valid only where hit)


def _plane_candidate(cs: CompiledScene, i, ro: V3, rd: V3, t_min, best_t):
    """Finite-rectangle hit for plane ``i`` against all rays.

    Semantics of ``cuda_texture_renderer.py:445-521``: strict
    ``t_min < t < best_t``, inclusive ``0 <= u_hit <= u_len`` rect bounds.
    """
    n = cs.planes.normal.at_index(i)
    anchor = cs.planes.anchor.at_index(i)
    u_unit = cs.planes.u_unit.at_index(i)
    v_unit = cs.planes.v_unit.at_index(i)
    u_len = cs.planes.u_len[i]
    v_len = cs.planes.v_len[i]

    denom = rd.dot(n)
    nonparallel = jnp.abs(denom) > EPS
    t = (anchor - ro).dot(n) / jnp.where(nonparallel, denom, 1.0)
    rel = ro + rd * t - anchor
    u_hit = rel.dot(u_unit)
    v_hit = rel.dot(v_unit)
    valid = (
        nonparallel
        & (t > t_min)
        & (t < best_t)
        & (u_hit >= 0.0)
        & (u_hit <= u_len)
        & (v_hit >= 0.0)
        & (v_hit <= v_len)
    )
    return valid, t


def _sphere_candidate(cs: CompiledScene, i, ro: V3, rd: V3, t_min, best_t):
    """Quadratic two-root selection for sphere ``i``
    (``cuda_texture_renderer.py:548-570``): near root if in range, else far
    root (the inside-the-sphere exit hit), both tested against the running
    best.
    """
    center = cs.spheres.center.at_index(i)
    radius = cs.spheres.radius[i]

    oc = ro - center
    a = rd.dot(rd)
    b = oc.dot(rd)
    c = oc.dot(oc) - radius * radius
    disc = b * b - a * c
    has_roots = disc > 0.0
    sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sqrt_d) / a
    t2 = (-b + sqrt_d) / a
    t1_ok = (t1 > t_min) & (t1 < best_t)
    t2_ok = (t2 > t_min) & (t2 < best_t)
    t = jnp.where(t1_ok, t1, t2)
    valid = has_roots & (t1_ok | t2_ok) & (jnp.where(t1_ok, t1, jnp.where(t2_ok, t2, -1.0)) > 0.0)
    return valid, t


def _quad_candidate(cs: CompiledScene, i, ro: V3, rd: V3, t_min, best_t):
    """Parallelogram quad: plane hit + two dual-basis dot products
    (see ``compiler.QuadsSoA``).  Double-sided like the triangles it merged."""
    n = cs.quads.normal.at_index(i)
    origin = cs.quads.origin.at_index(i)
    du = cs.quads.du.at_index(i)
    dv = cs.quads.dv.at_index(i)

    denom = rd.dot(n)
    nonparallel = jnp.abs(denom) > EPS
    t = (origin - ro).dot(n) / jnp.where(nonparallel, denom, 1.0)
    rel = ro + rd * t - origin
    a = rel.dot(du)
    b = rel.dot(dv)
    valid = (
        nonparallel
        & (t > t_min)
        & (t < best_t)
        & (a >= 0.0)
        & (a <= 1.0)
        & (b >= 0.0)
        & (b <= 1.0)
    )
    return valid, t


def _triangle_candidate(cs: CompiledScene, i, ro: V3, rd: V3, t_min, best_t):
    """Möller–Trumbore for triangle ``i`` (``cuda_texture_renderer.py:636-677``)."""
    v0 = cs.triangles.v0.at_index(i)
    e1 = cs.triangles.v1.at_index(i) - v0
    e2 = cs.triangles.v2.at_index(i) - v0

    h = rd.cross(e2)
    det = e1.dot(h)
    nonparallel = jnp.abs(det) > EPS
    inv_det = 1.0 / jnp.where(nonparallel, det, 1.0)
    s = ro - v0
    u = inv_det * s.dot(h)
    q = s.cross(e1)
    v = inv_det * rd.dot(q)
    t = inv_det * e2.dot(q)
    valid = (
        nonparallel
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < best_t)
    )
    return valid, t


# Below this total primitive count, intersection uses the broadcast
# formulation: an (N, P) candidate matrix reduced with a first-occurrence
# argmin.  It has no sequential dependency chain across primitives — every
# candidate is independent — so XLA can fuse the candidate math into the
# reduction.  The sequential form carries best_t through every primitive and
# compiles to a long serial chain.  Above the limit the sequential loop
# remains (scenes that large take the BVH path when they are triangle
# meshes).
BROADCAST_LIMIT = 512


def _sweep(candidate_fn, cs, count, offset, ro, rd, t_min, best_t, best_idx):
    """Run one primitive type's loop, updating the (best_t, best_idx) carry."""

    def body(i, carry):
        bt, bi = carry
        valid, t = candidate_fn(cs, i, ro, rd, t_min, bt)
        bt = jnp.where(valid, t, bt)
        bi = jnp.where(valid, jnp.int32(offset) + i, bi)
        return bt, bi

    return jax.lax.fori_loop(0, count, body, (best_t, best_idx))


def _lift(v: V3) -> V3:
    """(N,) SoA vector → (N, 1) so arithmetic against (P,) prim tables
    broadcasts to (N, P)."""
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


_ALL = slice(None)  # candidate fns take either a scalar index or the full table


def _closest_broadcast(cs: CompiledScene, ro: V3, rd: V3, t_min, t_max,
                       include_tris: bool = True):
    """All-pairs candidates + first-occurrence argmin (type order preserved:
    planes, spheres, triangles — ties resolve exactly like the reference's
    sequential strict-< scan)."""
    n = ro.x.shape[0]
    ro1, rd1 = _lift(ro), _lift(rd)
    bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))[:, None]

    inf = jnp.float32(jnp.inf)
    vp, tp = _plane_candidate(cs, _ALL, ro1, rd1, t_min, bound)
    vs, ts = _sphere_candidate(cs, _ALL, ro1, rd1, t_min, bound)
    vq, tq = _quad_candidate(cs, _ALL, ro1, rd1, t_min, bound)
    parts = [jnp.where(vp, tp, inf), jnp.where(vs, ts, inf), jnp.where(vq, tq, inf)]
    if include_tris:
        vt, tt = _triangle_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        parts.append(jnp.where(vt, tt, inf))
    t_all = jnp.concatenate(parts, axis=1)
    best_idx = jnp.argmin(t_all, axis=1).astype(jnp.int32)
    best_t = jnp.take_along_axis(t_all, best_idx[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(best_t)
    best_t = jnp.where(hit, best_t, jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)))
    return jnp.where(hit, best_idx, -1), best_t, hit


def scene_hit(cs: CompiledScene, ro: V3, rd: V3, t_min: float, t_max) -> SceneHit:
    """Closest hit of every ray against the whole scene.

    ``t_max`` may be a scalar or an (N,)-array (per-ray shadow distances).
    """
    P, S, Q, T = cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles

    if cs.bvh is not None:
        # planes/spheres/quads by broadcast, triangles by the BVH walk
        ps_idx, ps_t, ps_hit = _closest_broadcast(
            cs, ro, rd, t_min, t_max, include_tris=False
        )
        from .bvh import traverse_closest

        tri_t, tri_idx = traverse_closest(
            cs.bvh, cs.triangles, ro, rd, t_min, t_max, tri_offset=P + S + Q
        )
        tri_hit = tri_idx >= 0
        tri_wins = tri_hit & (~ps_hit | (tri_t < ps_t))
        best_idx = jnp.where(tri_wins, tri_idx, ps_idx)
        best_t = jnp.where(tri_wins, tri_t, ps_t)
        hit = ps_hit | tri_hit
    elif P + S + Q + T <= BROADCAST_LIMIT:
        best_idx, best_t, hit = _closest_broadcast(cs, ro, rd, t_min, t_max)
    else:
        best_idx, best_t, hit = closest_sequential(cs, ro, rd, t_min, t_max)
    return winner_attributes(cs, ro, rd, best_idx, best_t, hit)


def closest_sequential(cs: CompiledScene, ro: V3, rd: V3, t_min, t_max):
    """Closest hit by one ``fori_loop`` per primitive type, reading each
    primitive's fields as scalars — the scan order and strict ``<`` of the
    reference.  Returns ``(best_idx, best_t, hit)`` like
    ``_closest_broadcast``.  Also the sweep of the fused GPU bounce kernel
    (``ops/pallas/bounce_triton.py``), where ``cs`` holds table views."""
    n = ro.x.shape
    P, S, Q, T = cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), n)
    best_idx = jnp.full(n, -1, dtype=jnp.int32)
    best_t, best_idx = _sweep(_plane_candidate, cs, P, 0, ro, rd, t_min, best_t, best_idx)
    best_t, best_idx = _sweep(_sphere_candidate, cs, S, P, ro, rd, t_min, best_t, best_idx)
    best_t, best_idx = _sweep(_quad_candidate, cs, Q, P + S, ro, rd, t_min, best_t, best_idx)
    best_t, best_idx = _sweep(
        _triangle_candidate, cs, T, P + S + Q, ro, rd, t_min, best_t, best_idx
    )
    return best_idx, best_t, best_idx >= 0


def winner_attributes(cs: CompiledScene, ro: V3, rd: V3, best_idx, best_t,
                      hit) -> SceneHit:
    """The ``SceneHit`` record of each ray's winning primitive: hit point,
    normal and UV recomputed from the winner's gathered primitive data
    (``x[idx]`` gathers, so table views work here too)."""
    P, S, Q, T = cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles
    point = ro + rd * best_t

    is_plane = hit & (best_idx < P)
    is_sphere = hit & (best_idx >= P) & (best_idx < P + S)
    is_quad = hit & (best_idx >= P + S) & (best_idx < P + S + Q)
    is_tri = hit & (best_idx >= P + S + Q)

    pi = jnp.clip(best_idx, 0, P - 1)
    si = jnp.clip(best_idx - P, 0, S - 1)
    qi = jnp.clip(best_idx - P - S, 0, Q - 1)
    ti = jnp.clip(best_idx - P - S - Q, 0, T - 1)

    # plane attributes
    pn = cs.planes.normal.at_index(pi)
    p_anchor = cs.planes.anchor.at_index(pi)
    rel = point - p_anchor
    p_u = rel.dot(cs.planes.u_unit.at_index(pi)) / cs.planes.u_len[pi]
    p_v = rel.dot(cs.planes.v_unit.at_index(pi)) / cs.planes.v_len[pi]

    # sphere attributes (UV fixed at 0 — reference quirk, SURVEY §2 quirk 3)
    s_center = cs.spheres.center.at_index(si)
    s_rad = cs.spheres.radius[si]
    sn = (point - s_center) * (1.0 / jnp.where(s_rad > 0, s_rad, 1.0))

    # quad attributes: dual-basis coordinates, normal flipped toward ray
    q_origin = cs.quads.origin.at_index(qi)
    q_rel = point - q_origin
    qa = q_rel.dot(cs.quads.du.at_index(qi))
    qb = q_rel.dot(cs.quads.dv.at_index(qi))
    qn_raw = cs.quads.normal.at_index(qi)
    qn = V3.where(qn_raw.dot(rd) > 0.0, -qn_raw, qn_raw)
    q_u = cs.quads.uv0[0][qi] + qa * cs.quads.uva[0][qi] + qb * cs.quads.uvb[0][qi]
    q_v = cs.quads.uv0[1][qi] + qa * cs.quads.uva[1][qi] + qb * cs.quads.uvb[1][qi]

    # triangle attributes: barycentrics recomputed from gathered vertices
    tv0 = cs.triangles.v0.at_index(ti)
    e1 = cs.triangles.v1.at_index(ti) - tv0
    e2 = cs.triangles.v2.at_index(ti) - tv0
    h = rd.cross(e2)
    det = e1.dot(h)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > EPS, det, 1.0)
    s_vec = ro - tv0
    bu = inv_det * s_vec.dot(h)
    bv = inv_det * rd.dot(s_vec.cross(e1))
    tn_raw = cs.triangles.normal.at_index(ti)
    bw = 1.0 - bu - bv
    tn = V3.where(tn_raw.dot(rd) > 0.0, -tn_raw, tn_raw)
    if cs.tri_uv_used is None or cs.tri_uv_used.shape[0]:
        t_u = bu * cs.triangles.uv1[0][ti] + bv * cs.triangles.uv2[0][ti] + bw * cs.triangles.uv0[0][ti]
        t_v = bu * cs.triangles.uv1[1][ti] + bv * cs.triangles.uv2[1][ti] + bw * cs.triangles.uv0[1][ti]
    else:
        # no textured triangle in the scene → nothing reads triangle uv;
        # skip the 6 per-lane gathers (shape-encoded static flag)
        t_u = t_v = jnp.zeros_like(bu)

    normal = V3.where(
        is_plane, pn, V3.where(is_sphere, sn, V3.where(is_quad, qn, tn))
    )
    u = jnp.where(is_plane, p_u, jnp.where(is_quad, q_u, jnp.where(is_tri, t_u, 0.0)))
    v = jnp.where(is_plane, p_v, jnp.where(is_quad, q_v, jnp.where(is_tri, t_v, 0.0)))

    # Miss default normal matches the reference's (0, 1, 0)
    # (cuda_texture_renderer.py:439) though no consumer reads it on miss.
    normal = V3.where(hit, normal, V3.of(0.0, 1.0, 0.0))

    return SceneHit(hit=hit, t=best_t, point=point, normal=normal, u=u, v=v, prim=best_idx)


def scene_hit_any(cs: CompiledScene, ro: V3, rd: V3, t_min: float, t_max) -> jnp.ndarray:
    """Existence-only occlusion query for shadow rays (cheaper than closest hit).

    Equivalent to the reference's pattern of calling the full scene hit and
    using only the flag (``cuda_texture_renderer.py:264-266``).
    """
    n = ro.x.shape
    limit = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), n)
    P, S, Q, T = cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles

    if cs.bvh is not None:
        ro1, rd1 = _lift(ro), _lift(rd)
        bound = limit[:, None]
        vp, _ = _plane_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        vs, _ = _sphere_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        vq, _ = _quad_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        ps_any = jnp.any(vp, axis=1) | jnp.any(vs, axis=1) | jnp.any(vq, axis=1)
        from .bvh import traverse_any

        return ps_any | traverse_any(cs.bvh, cs.triangles, ro, rd, t_min, limit)

    if P + S + Q + T <= BROADCAST_LIMIT:
        ro1, rd1 = _lift(ro), _lift(rd)
        bound = limit[:, None]
        vp, _ = _plane_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        vs, _ = _sphere_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        vq, _ = _quad_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        vt, _ = _triangle_candidate(cs, _ALL, ro1, rd1, t_min, bound)
        return (jnp.any(vp, axis=1) | jnp.any(vs, axis=1) | jnp.any(vq, axis=1)
                | jnp.any(vt, axis=1))

    return any_sequential(cs, ro, rd, t_min, limit)


def any_sequential(cs: CompiledScene, ro: V3, rd: V3, t_min, t_max) -> jnp.ndarray:
    """Occlusion by one ``fori_loop`` per primitive type (scalar primitive
    reads), the any-hit counterpart of ``closest_sequential``."""
    limit = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), ro.x.shape)
    occluded = jnp.zeros(ro.x.shape, dtype=bool)

    def run(candidate_fn, count, acc):
        def body(i, acc):
            valid, _ = candidate_fn(cs, i, ro, rd, t_min, limit)
            return acc | valid

        return jax.lax.fori_loop(0, count, body, acc)

    occluded = run(_plane_candidate, cs.n_planes, occluded)
    occluded = run(_sphere_candidate, cs.n_spheres, occluded)
    occluded = run(_quad_candidate, cs.n_quads, occluded)
    occluded = run(_triangle_candidate, cs.n_triangles, occluded)
    return occluded


def gather_material(mats: MatSoA, prim_idx: jnp.ndarray):
    """Fetch the winning primitive's material record (one gather per field)."""
    idx = jnp.maximum(prim_idx, 0)
    return (
        mats.color.at_index(idx),
        mats.diffuse[idx],
        mats.specular[idx],
        mats.reflective[idx],
        mats.refractive[idx],
        mats.ior[idx],
        mats.has_tex[idx],
        mats.tex_id[idx],
    )


def resolve_material(cs: CompiledScene, prim_idx: jnp.ndarray):
    """``gather_material`` through the unique-material compression when the
    scene carries one (``compiler`` builds it for ≤ SELECT_LIMIT distinct
    materials): ONE int32 gather (prim → unique id) plus a gather-free
    select chain for the nine fields, instead of ten per-lane gathers.
    Bit-exact: the select chain copies rows, no arithmetic touches the
    values."""
    if cs.mat_table is None:
        return gather_material(cs.materials, prim_idx)
    from .select_table import take_rows

    mid = cs.mat_uid[jnp.maximum(prim_idx, 0)]
    mt = cs.mat_table
    (cx, cy, cz, diffuse, specular, reflective, refractive, ior, has_tex,
     tex_id) = take_rows(
        mid,
        (mt.color.x, mt.color.y, mt.color.z, mt.diffuse, mt.specular,
         mt.reflective, mt.refractive, mt.ior, mt.has_tex, mt.tex_id),
    )
    return (V3(cx, cy, cz), diffuse, specular, reflective, refractive, ior,
            has_tex, tex_id)
