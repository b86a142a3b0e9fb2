"""CPU-parity Whitted renderer — the wavefront form of the reference's
``cpu_raytracer`` (``renderers/cpu_renderer.py``), which serves as the slow
physics oracle the GPU renderers were compared against.

Physics (all from ``cpu_renderer.py:75-151``):

* ambient = ``diffuse · base · scene.ambient`` — the only renderer that reads
  the scene's tuned ``ambient``/``light_color`` globals (SURVEY.md §2
  quirk 12);
* per-light Lambert with **no distance falloff**, Phong with the reference's
  inverted half-vector (``to_light.reflect(n)`` against the view vector) and
  fixed shininess 32;
* unlike every GPU renderer, the recursion **forks into both** reflection and
  refraction (``cpu_renderer.py:113-142``), mixed as
  ``local·(1−kr−kt) + kr·R + kt·T``.

The fork makes the wavefront cost 2^depth, so this renderer statically
unrolls the recursion and clamps depth to ``ORACLE_MAX_DEPTH`` (the energy in
deeper fork chains is below 0.85^8 of a single glass path; documented in
QUIRKS.md).  It compiles the scene with the host conventions: plane
``v = n × u`` and no GPU wire-format masking (planes/triangles may refract,
any primitive may be textured).
"""
from __future__ import annotations

import math
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng
from ..ops.camera import generate_rays
from ..ops.intersect import resolve_material, scene_hit, scene_hit_any
from ..ops.texture import resolve_base_color
from ..ops.v3 import V3, refract
from .base import RendererFactory
from .wavefront import WavefrontRenderer, pixel_coords

_T_MIN = 1e-3
_EPS_OFFSET = 1e-3
# Fork-evaluation depth cap.  The heap-synchronous evaluation (see ``_trace``)
# compiles one shade/fork body regardless of depth, so the cap is purely a
# memory/runtime bound: the heap holds 2^(d+1) n-lane segments (~16 f32
# fields each) and the forward pass runs 2^(d+1)-1 sequential segment
# evaluations.  Depth 12 ≈ 1 GB of buffers at the clamped chunk width and
# ~8K segment evaluations; fork chains beyond that carry < 0.85^12 of a
# glass path's energy (QUIRKS.md).  Round 1's compile-driven clamp was 8.
ORACLE_MAX_DEPTH = 12
# deepest-level lane budget: bounds the heap buffers' memory (the forward
# pass carries ~16 floats per lane across 2·2^d segments)
_LEVEL_LANE_BUDGET = 1 << 22


def _shade_local(cs, hit, base_color, mats, ray_origin: V3) -> V3:
    (_c, diffuse, specular, _refl, _refr, _ior, _ht, _tid) = mats
    normal = hit.normal
    point = hit.point

    local = base_color * cs.ambient * diffuse
    n_lights = cs.n_lights
    if n_lights == 0:
        return local

    shadow_org = point + normal * _EPS_OFFSET
    inv_n = 1.0 / n_lights

    def light_body(li, acc):
        lp = cs.lights.at_index(li)
        to_light_raw = lp - point
        dist = to_light_raw.norm()
        ldir = to_light_raw.normalized()
        occluded = scene_hit_any(cs, shadow_org, ldir, _T_MIN, dist)

        diff = jnp.maximum(normal.dot(ldir), 0.0)
        lambert = base_color * cs.light_color * (diffuse * diff * inv_n)

        # reference Phong: reflect the *light* vector (cpu_renderer.py:107-110)
        view = (ray_origin - point).normalized()
        refl_l = ldir.reflect(normal)
        spec = jnp.maximum(view.dot(refl_l), 0.0)
        phong = cs.light_color * (specular * jnp.power(spec, 32.0) * inv_n)

        return acc + V3.where(~occluded, lambert + phong, V3.of(0.0, 0.0, 0.0))

    zero = V3.full(0.0, hit.t.shape)
    return local + jax.lax.fori_loop(0, n_lights, light_body, zero)


def _trace(cs, org: V3, rd: V3, depth: int, max_depth: int, active) -> V3:
    """Heap-synchronous evaluation of the reference's fork recursion.

    The reference CPU renderer forks into *both* reflection and refraction
    (``cpu_renderer.py:113-142``).  Round 1 statically unrolled that
    recursion — 2^depth inlined subgraphs, 244 s to compile at depth 8; the
    first level-synchronous rewrite still inlined one shade/fork body per
    level.  This formulation lays the fork tree out as a **binary heap of
    constant-width n-lane segments**: node ``j``'s children live at ``2j+1``
    (reflection) and ``2j+2`` (refraction), the forward pass is ONE
    ``fori_loop`` over all ``2^(d+1)-1`` nodes in heap (BFS) order, and the
    backward pass is one reverse ``fori_loop`` combining
    ``local·(1−kr−kt) + kr·R + kt·T``.  The compiled graph holds exactly one
    copy of the shade/fork body regardless of depth; per-lane arithmetic is
    identical to the recursive form.
    """
    n = int(org.x.shape[0])
    M = 2 ** (max_depth + 1) - 1  # heap nodes over levels 0..max_depth
    # leaf fan-out writes land in a scratch tail no later node reads:
    # max child index is 2(M-1)+2 = 2M, so buffers span 2M+1 segments
    CB = 2 * M + 1

    def seg(buf, j):
        return jax.lax.dynamic_slice(buf, (j * n,), (n,))

    def put(buf, val, j):
        return jax.lax.dynamic_update_slice(buf, val, (j * n,))

    def seg3(bufs, j):
        return V3(seg(bufs[0], j), seg(bufs[1], j), seg(bufs[2], j))

    def put3(bufs, v, j):
        return (put(bufs[0], v.x, j), put(bufs[1], v.y, j), put(bufs[2], v.z, j))

    def shade_fork(o, d, act):
        """Shade one heap node and produce its two child rays (both always
        computed; activity masks gate their contribution)."""
        hit = scene_hit(cs, o, d, _T_MIN, 1e30)
        mats = resolve_material(cs, hit.prim)
        (mcolor, _diff, _spec, reflective, refractive, ior, has_tex, tex_id) = mats
        base = resolve_base_color(cs, mcolor, has_tex, tex_id, hit.u, hit.v)
        local = _shade_local(cs, hit, base, mats, o)
        lane = act & hit.hit

        normal = hit.normal
        point = hit.point
        # reflection branch (cpu_renderer.py:113-117); Ray() normalizes
        refl_dir = d.reflect(normal).normalized()
        refl_org = point + normal * _EPS_OFFSET
        want_refl = lane & (reflective > 0.0)

        # refraction branch (cpu_renderer.py:119-142)
        inside = d.dot(normal) > 0.0
        outward = V3.where(inside, -normal, normal)
        eta = jnp.where(inside, ior, 1.0 / ior)
        ok, refr_dir = refract(d, outward, eta)
        # quirk: refracted rays always offset along −n, even when exiting
        refr_org = point - normal * _EPS_OFFSET
        branch_dir = V3.where(ok, refr_dir.normalized(), refl_dir)
        branch_org = V3.where(ok, refr_org, refl_org)
        want_refr = lane & (refractive > 0.0)

        return (
            (local, reflective, refractive, lane),
            (refl_org, refl_dir, want_refl),
            (branch_org, branch_dir, want_refr),
        )

    zf_cb = jnp.zeros((CB * n,), jnp.float32)
    zb_cb = jnp.zeros((CB * n,), bool)
    zf_m = jnp.zeros((M * n,), jnp.float32)
    zb_m = jnp.zeros((M * n,), bool)

    # ---- forward: one fori over heap nodes (root seeded at j=0) -------------
    iox, ioy, ioz = put3((zf_cb, zf_cb, zf_cb), org, 0)
    idx_, idy_, idz_ = put3((zf_cb, zf_cb, zf_cb), rd, 0)
    iact = put(zb_cb, active, 0)

    def fwd_body(j, carry):
        (iox, ioy, ioz, idx_, idy_, idz_, iact,
         lx, ly, lz, akr, akt, alane) = carry
        o = seg3((iox, ioy, ioz), j)
        d = seg3((idx_, idy_, idz_), j)
        act = seg(iact, j)
        (local, kr, kt, lane), refl, refr = shade_fork(o, d, act)
        lx, ly, lz = put(lx, local.x, j), put(ly, local.y, j), put(lz, local.z, j)
        akr, akt, alane = put(akr, kr, j), put(akt, kt, j), put(alane, lane, j)
        for child, (co, cd, cact) in ((2 * j + 1, refl), (2 * j + 2, refr)):
            iox, ioy, ioz = put3((iox, ioy, ioz), co, child)
            idx_, idy_, idz_ = put3((idx_, idy_, idz_), cd, child)
            iact = put(iact, cact, child)
        return (iox, ioy, ioz, idx_, idy_, idz_, iact,
                lx, ly, lz, akr, akt, alane)

    (_iox, _ioy, _ioz, _idx, _idy, _idz, _iact,
     lx, ly, lz, akr, akt, alane) = jax.lax.fori_loop(
        0, M, fwd_body,
        (iox, ioy, ioz, idx_, idy_, idz_, iact,
         zf_m, zf_m, zf_m, zf_m, zf_m, zb_m),
    )

    # ---- backward: reverse fori; leaf children read the zeroed tail ---------
    def bwd_body(i, cb):
        cx, cy, cz = cb
        j = M - 1 - i
        local = seg3((lx, ly, lz), j)
        kr, kt, lane = seg(akr, j), seg(akt, j), seg(alane, j)
        refl = seg3((cx, cy, cz), 2 * j + 1)
        refr = seg3((cx, cy, cz), 2 * j + 2)
        c = local * (1.0 - kr - kt) + refl * kr + refr * kt
        c = V3.where(lane, c, V3.full(0.0, lane.shape))
        return put3((cx, cy, cz), c, j)

    cx, cy, cz = jax.lax.fori_loop(0, M, bwd_body, (zf_cb, zf_cb, zf_cb))
    return V3(cx[:n], cy[:n], cz[:n])


@partial(
    jax.jit,
    static_argnames=(
        "n_pix", "width", "height", "spp", "max_depth", "n_samples", "jitter",
    ),
)
def _oracle_chunk(
    cs,
    cam12,
    pix0,
    seed,
    sample_base,
    *,
    n_pix: int,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    n_samples: int,
    jitter: str,
):
    idx, x, y = pixel_coords(pix0, n_pix, width, height)
    grid_n = int(math.isqrt(spp))
    grid_total = grid_n * grid_n

    def sample_body(s, acc):
        cell = sample_base + s
        a = (cell // grid_n).astype(jnp.float32)
        b = (cell % grid_n).astype(jnp.float32)
        key = rng.ray_key(seed, idx, cell)
        # the reference CPU sampler draws two independent uniforms
        # (cpu_renderer.py:49-50) — no du==dv quirk here
        if jitter == "center":
            r1 = r2 = jnp.float32(0.5)
        else:
            r1 = rng.uniform(key, max_depth, 0)
            r2 = r1 if jitter == "diagonal" else rng.uniform(key, max_depth, 1)
        u = (x + (a + r1) / grid_n) / width
        v = (y + (b + r2) / grid_n) / height
        o, d = generate_rays(cam12, u, v)
        ones = jnp.ones((n_pix,), dtype=bool)
        radiance = _trace(cs, o, d, 0, max_depth, ones)
        return acc + V3.where(cell < grid_total, radiance, V3.of(0.0, 0.0, 0.0))

    return jax.lax.fori_loop(0, n_samples, sample_body, V3.full(0.0, (n_pix,)))


class CPUParityRayTracer(WavefrontRenderer):
    """Registered as ``cpu_raytracer``: the reference oracle's physics
    (``cpu_renderer.py``), executed as vectorized XLA."""

    convention = "cpu"
    gpu_parity = False
    # reference prints "CPU is working for you...: <rows>" every 50 rows
    # (cpu_renderer.py:64-65); here each finished chunk reports row progress
    progress_label = "CPU is working for you..."

    def __init__(self, **kw):
        kw.setdefault("jitter", "independent")
        # pinned to the host by design: the upstream's cpu_raytracer is its
        # CPU renderer, so this one runs on the CPU backend beside the GPU
        # ones (pass device=None to run it on the default device instead)
        kw.setdefault("device", "cpu")
        super().__init__("cpu_raytracer", **kw)

    def get_capabilities(self) -> List[str]:
        return [
            "ray_tracing",
            "shadows",
            "reflection",
            "refraction",
            "area_lights",
            "anti_aliasing",
            "bvh_acceleration",
        ]

    def _samples_per_group(self, spp: int) -> int:
        return max(1, int(math.isqrt(spp)) ** 2)

    def _plan(self, w, h, spp, max_depth):
        # level-synchronous evaluation allocates n_pix·2^depth lanes at the
        # deepest level; shrink the pixel chunk so that stays bounded
        depth = min(max_depth, ORACLE_MAX_DEPTH)
        if depth < max_depth:
            from ..utils.logging import log_event

            log_event("depth_clamped", requested=max_depth, effective=depth)
        group = self._samples_per_group(spp)
        budget_rays = max(1024, _LEVEL_LANE_BUDGET >> depth) * max(group, 1)
        old = self.chunk_rays
        self.chunk_rays = min(old, budget_rays)
        try:
            return super()._plan(w, h, spp, max_depth)
        finally:
            self.chunk_rays = old

    def _make_chunk_fn(self, static_key):
        n_pix, w, h, spp, max_depth, group, jitter = static_key
        depth = min(max_depth, ORACLE_MAX_DEPTH)
        return partial(
            _oracle_chunk,
            n_pix=n_pix,
            width=w,
            height=h,
            spp=spp,
            max_depth=depth,
            n_samples=group,
            jitter=jitter,
        )

    def render_sums(self, scene, camera, settings, sample_offset=0, n_samples=None):
        return super().render_sums(
            scene,
            camera,
            settings,
            sample_offset=0,
            n_samples=self._samples_per_group(settings.samples_per_pixel),
        )

    def _finalize_dev(self, sums, spp_total: int, settings):
        # same ⌊√spp⌋²-sum / requested-spp division as the reference
        # (cpu_renderer.py:40,58)
        return jnp.asarray(sums) / float(spp_total)


RendererFactory.register("cpu_raytracer", CPUParityRayTracer)
