"""Wavefront Whitted ray tracers — the wavefront forms of the reference's
``cuda_raytracer`` (``renderers/cuda_renderer.py``) and
``cuda_texture_raytracer`` (``renderers/cuda_texture_renderer.py``, the CLI
default that produced ``output_RayTracer.png``).

The per-thread bounce loop becomes a ``lax.while_loop`` over a masked SoA ray
batch: one scene-intersection pass, one shading pass (with a shadow query per
area-light sample), then a branchless reflect/refract continuation.  The loop
exits early once every lane is dead, so typical frames pay for ~2 bounces,
not ``max_depth``.

Physics constants are reproduced exactly, quirks included (SURVEY.md §2):
hard-coded 0.4 ambient, the two falloff variants, the shininess table,
``max(0.1, 1−kr−kt)`` base energy, spheres-only refraction, and the
"effective spp = ⌊√spp⌋² summed but divided by requested spp" grid sampler.
"""
from __future__ import annotations

import math
from functools import partial
from typing import List, NamedTuple

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


class WhittedVariant(NamedTuple):
    """Static physics switches distinguishing the two Whitted GPU renderers."""

    textured: bool  # sample the atlas for base color
    refraction: bool  # spheres may refract
    falloff_scale: float  # 1.0 basic (cuda_renderer.py:195) / 1.5 texture (:277)
    diffuse_gain: float  # 1.0 basic / 0.6 texture (cuda_texture_renderer.py:281)
    spec_table: bool  # material-dependent shininess (cuda_texture_renderer.py:305-330)
    base_floor: bool  # max(0.1, 1-kr-kt) (texture :338) vs (1-kr) (basic :228)


BASIC = WhittedVariant(False, False, 1.0, 1.0, False, False)
TEXTURE = WhittedVariant(True, True, 1.5, 0.6, True, True)

_EPS_OFFSET = 1e-3
_T_MIN = 1e-3
_T_MAX = 1e6
_AMBIENT = 0.4  # hard-coded GPU ambient (cuda_renderer.py:144)


def _direct_lighting(cs, hit, base_color, mats, view_dir, variant: WhittedVariant) -> V3:
    """Ambient + per-light-sample Lambert/Phong with shadow rays.

    Loops the area light's point samples (``fori_loop``), issuing one
    vectorized occlusion query per sample — the wavefront form of
    ``cuda_texture_renderer.py:221-334``.
    """
    (_, diffuse, specular, reflective, _refr, _ior, _ht, _tid) = mats
    local = base_color * _AMBIENT
    n_lights = cs.n_lights
    if n_lights == 0:
        return local

    normal = hit.normal
    shadow_org = hit.point + normal * _EPS_OFFSET

    def light_body(li, acc):
        lp = cs.lights.at_index(li)
        to_light = lp - hit.point
        dist = to_light.norm()
        ldir = to_light * (1.0 / jnp.where(dist > 0.001, dist, 1.0))
        near_ok = dist > 0.001

        occluded = scene_hit_any(cs, shadow_org, ldir, _T_MIN, dist - 0.001)
        lit = near_ok & ~occluded

        diff = jnp.maximum(normal.dot(ldir), 0.0)
        atten = variant.falloff_scale / (1.0 + 0.001 * dist + 0.0001 * dist * dist)
        diffuse_term = base_color * (
            diff * atten / n_lights * diffuse * variant.diffuse_gain
        )

        # Phong: R = 2(N·L)N − L against the view vector
        dot_nl = normal.dot(ldir)
        refl_l = normal * (2.0 * dot_nl) - ldir
        dot_rv = jnp.maximum(refl_l.dot(view_dir), 0.0)

        if variant.spec_table:
            chrome = (reflective > 0.9) & (specular > 0.9)
            metal = reflective > 0.7
            glossy = specular > 0.5
            shininess = jnp.where(
                chrome, 256.0, jnp.where(metal, 128.0, jnp.where(glossy, 64.0, 32.0))
            )
            multiplier = jnp.where(chrome, 1.5, jnp.where(metal, 1.2, 1.0))
            spec_gate = (specular > 0.01) & (diff > 0.0)
            spec_int = jnp.power(dot_rv, shininess) * atten * multiplier / n_lights
            white = V3(spec_int, spec_int, spec_int) * specular
            tinted = base_color * (spec_int * specular)
            spec_term = V3.where(metal, tinted, white)
        else:
            spec_gate = specular > 0.01
            s = jnp.power(dot_rv, 32.0) * specular * atten / n_lights
            spec_term = V3(s, s, s)

        contrib = diffuse_term + V3.where(spec_gate, spec_term, V3.of(0.0, 0.0, 0.0))
        return acc + V3.where(lit, contrib, V3.of(0.0, 0.0, 0.0))

    zero = V3.full(0.0, hit.t.shape)
    return local + jax.lax.fori_loop(0, n_lights, light_body, zero)


def whitted_radiance(cs, org: V3, rd: V3, max_depth: int, variant: WhittedVariant) -> V3:
    """Trace one batch of rays to completion, returning radiance."""
    def cond(state):
        depth, *_rest, active = state
        return (depth < max_depth) & jnp.any(active)

    def body(state):
        depth, o, d, atten, color, active = state
        hit = scene_hit(cs, o, d, _T_MIN, _T_MAX)
        mats = resolve_material(cs, hit.prim)
        (mcolor, _diff, _spec, reflective, refractive, ior, has_tex, tex_id) = mats

        if variant.textured:
            base_color = resolve_base_color(cs, mcolor, has_tex, tex_id, hit.u, hit.v)
        else:
            base_color = mcolor

        local = _direct_lighting(cs, hit, base_color, mats, -d, variant)

        if variant.base_floor:
            base_energy = jnp.maximum(0.1, 1.0 - reflective - refractive)
        else:
            base_energy = 1.0 - reflective

        lane = active & hit.hit
        color = color + V3.where(lane, local * atten * base_energy, V3.of(0.0, 0.0, 0.0))

        # -- continuation (reflect / refract), cuda_texture_renderer.py:344-423
        normal = hit.normal
        refl_dir = d.reflect(normal)
        refl_org = hit.point + normal * _EPS_OFFSET

        if variant.refraction:
            want = ((reflective > 0.01) | (refractive > 0.01)) & (depth < max_depth - 1)
            use_refr = (refractive > reflective) & (refractive > 0.1)

            inside = d.dot(normal) > 0.0
            outward = V3.where(inside, -normal, normal)
            eta = jnp.where(inside, ior, 1.0 / ior)
            offset = V3.where(inside, normal, -normal)
            ok, refr_dir = refract(d, outward, eta)
            refr_org = hit.point + offset * _EPS_OFFSET

            new_d = V3.where(use_refr, V3.where(ok, refr_dir, refl_dir), refl_dir)
            new_o = V3.where(use_refr, V3.where(ok, refr_org, refl_org), refl_org)
            mult = jnp.where(
                use_refr, jnp.where(ok, refractive * 0.95, reflective), reflective
            )
        else:
            want = (reflective > 0.01) & (depth < max_depth - 1)
            new_d, new_o, mult = refl_dir, refl_org, reflective

        cont = lane & want
        o = V3.where(cont, new_o, o)
        d = V3.where(cont, new_d, d)
        atten = V3.where(cont, atten * mult, atten)
        return depth + 1, o, d, atten, color, cont

    n = org.x.shape
    init = (
        jnp.int32(0),
        org,
        rd,
        V3.full(1.0, n),
        V3.full(0.0, n),
        jnp.ones(n, dtype=bool),
    )
    *_d, color, _a = jax.lax.while_loop(cond, body, init)
    return color


@partial(
    jax.jit,
    static_argnames=(
        "n_pix",
        "width",
        "height",
        "spp",
        "max_depth",
        "n_samples",
        "jitter",
        "variant",
    ),
)
def _whitted_chunk(
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
    variant: WhittedVariant,
):
    """Radiance sums over grid-sampler cells ``[sample_base, sample_base +
    n_samples)`` of the jittered ⌊√spp⌋² grid for one pixel chunk (cells past
    the grid are masked, so a mesh ``sample`` axis can split the grid).

    Reproduces the reference sampler (``cuda_texture_renderer.py:39-63``),
    including the du==dv diagonal-jitter quirk when ``faithful`` (the two
    ``cuda_random`` calls read the same unadvanced LCG state, SURVEY.md §2
    quirk 2).
    """
    idx, x, y = pixel_coords(pix0, n_pix, width, height)
    grid_n = int(math.isqrt(spp))
    grid_total = grid_n * grid_n

    def sample_body(s, acc):
        cell = sample_base + s
        a = (cell // grid_n).astype(jnp.float32)
        b = (cell % grid_n).astype(jnp.float32)
        key = rng.ray_key(seed, idx, cell)
        if jitter == "center":
            r1 = r2 = jnp.float32(0.5)
        else:
            r1 = rng.uniform(key, max_depth, 0)
            r2 = r1 if jitter == "diagonal" else rng.uniform(key, max_depth, 1)
        du = (a + r1) / grid_n
        dv = (b + r2) / grid_n
        u = (x + du) / width
        v = (y + dv) / height
        o, d = generate_rays(cam12, u, v)
        radiance = whitted_radiance(cs, o, d, max_depth, variant)
        in_grid = cell < grid_total
        return acc + V3.where(in_grid, radiance, V3.of(0.0, 0.0, 0.0))

    zero = V3.full(0.0, (n_pix,))
    return jax.lax.fori_loop(0, n_samples, sample_body, zero)


class _WhittedBase(WavefrontRenderer):
    variant: WhittedVariant = BASIC

    def _samples_per_group(self, spp: int) -> int:
        # the grid sampler is indivisible: one group integrates all cells
        return max(1, int(math.isqrt(spp)) ** 2)

    def _make_chunk_fn(self, static_key):
        n_pix, w, h, spp, max_depth, group, jitter = static_key
        return partial(
            _whitted_chunk,
            n_pix=n_pix,
            width=w,
            height=h,
            spp=spp,
            max_depth=max_depth,
            n_samples=group,
            jitter=jitter,
            variant=self.variant,
        )

    def render_sums(self, scene, camera, settings, sample_offset=0, n_samples=None):
        # a grid render is a single indivisible sample group
        return super().render_sums(
            scene, camera, settings, sample_offset=0, n_samples=self._samples_per_group(
                settings.samples_per_pixel
            ),
        )

    def _finalize_dev(self, sums, spp_total: int, settings):
        # faithful quirk: divide by the *requested* spp even though only
        # ⌊√spp⌋² samples were summed (cuda_renderer.py:39,64-66)
        return jnp.asarray(sums) / float(spp_total)


class WhittedRayTracer(_WhittedBase):
    """Parity renderer for ``cuda_raytracer`` (reflection-only Whitted,
    ``renderers/cuda_renderer.py``)."""

    variant = BASIC

    def __init__(self, **kw):
        super().__init__("tpu_raytracer", **kw)

    def get_capabilities(self) -> List[str]:
        return [
            "ray_tracing",
            "shadows",
            "reflection",
            "gpu_acceleration",
            "anti_aliasing",
            "xla_compute",
        ]


class TextureRayTracer(_WhittedBase):
    """Parity renderer for ``cuda_texture_raytracer`` (textured Whitted with
    refraction, ``renderers/cuda_texture_renderer.py`` — the CLI default)."""

    variant = TEXTURE

    def __init__(self, **kw):
        super().__init__("tpu_texture_raytracer", **kw)

    def get_capabilities(self) -> List[str]:
        return [
            "ray_tracing",
            "shadows",
            "reflection",
            "refraction",
            "textures",
            "gpu_acceleration",
            "anti_aliasing",
            "xla_compute",
            "all_geometry_types",
        ]


RendererFactory.register("tpu_raytracer", WhittedRayTracer)
RendererFactory.register("tpu_texture_raytracer", TextureRayTracer)
RendererFactory.register_alias("cuda_raytracer", "tpu_raytracer")
RendererFactory.register_alias("cuda_texture_raytracer", "tpu_texture_raytracer")
