"""Vectorized texture-atlas sampling (the wavefront form of
``cuda_sample_texture``, ``cuda_texture_renderer.py:117-143``):
nearest-neighbour with V flip, a single vector gather into the packed-int32
atlas.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..compiler import CompiledScene
from .select_table import SELECT_LIMIT, take_rows
from .v3 import V3

# Compacted per-bounce gather — built, bit-exact, gated off.  Idea: only the
# textured-hit lanes need a texel, so stable-sort them to the front, gather
# ONE static prefix of N/TEX_COMPACT_DIV elements, and index-sort the texels
# back; a lax.cond falls back to the full-width gather when the count
# overflows the prefix (bit-identical either way).  The two full-width sorts
# cost more than they save unless the gather dominates; unmeasured on the
# H100.
TEX_COMPACT = False
TEX_COMPACT_DIV = 4
# below this lane count the full gather is already cheap and the sort
# bookkeeping would dominate; also keeps tiny CPU-test batches on the
# simple path (the compact path is covered by its own equivalence test)
_COMPACT_MIN_LANES = 8192


def _nearest_index(tex_id, u, v, widths, heights, offsets, n_textures: int):
    """Flat texel index for nearest-neighbour + V-flip sampling
    (``cuda_texture_renderer.py:117-143``) against arbitrary w/h/offset
    tables (full atlas or mip)."""
    tid = jnp.clip(tex_id, 0, n_textures - 1)
    if n_textures <= SELECT_LIMIT:
        # gather-free row pick from the tiny info table (bit-exact)
        w, h, off = take_rows(tid, (widths, heights, offsets))
    else:
        w = widths[tid]
        h = heights[tid]
        off = offsets[tid]
    uu = jnp.clip(u, 0.0, 1.0)
    vv = jnp.clip(v, 0.0, 1.0)
    iu = jnp.clip((uu * (w - 1).astype(jnp.float32)).astype(jnp.int32), 0, w - 1)
    iv = jnp.clip(((1.0 - vv) * (h - 1).astype(jnp.float32)).astype(jnp.int32), 0, h - 1)
    return off + iv * w + iu


def _unpack_rgb(texel: jnp.ndarray) -> V3:
    inv255 = jnp.float32(1.0 / 255.0)
    return V3(
        (texel & 0xFF).astype(jnp.float32) * inv255,
        ((texel >> 8) & 0xFF).astype(jnp.float32) * inv255,
        ((texel >> 16) & 0xFF).astype(jnp.float32) * inv255,
    )


def sample_atlas(cs: CompiledScene, tex_id: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> V3:
    """Sample RGB in [0, 1] for each ray.  ``tex_id < 0`` yields white
    (the reference default, ``cuda_texture_renderer.py:143``); callers mask
    with ``has_tex`` anyway.
    """
    idx = _nearest_index(tex_id, u, v, cs.tex_width, cs.tex_height,
                         cs.tex_offset, cs.n_textures)
    texel = cs.atlas[idx]  # one gather; channels unpacked in registers
    rgb = _unpack_rgb(texel)
    return V3.where(tex_id >= 0, rgb, V3.of(1.0, 1.0, 1.0))


def _gather_texels_compact(cs: CompiledScene, textured, idx) -> jnp.ndarray:
    """Packed-int32 texels for the ``textured`` lanes (others: texel 0) via
    the compacted static-prefix gather (module note at ``TEX_COMPACT``).
    Exact: a ``lax.cond`` falls back to the full-width gather whenever the
    textured count overflows the prefix."""
    n = int(idx.shape[0])
    cap = -(-n // TEX_COMPACT_DIV)
    iota = jnp.arange(n, dtype=jnp.int32)
    # textured lanes first; stable, so their (coherent) lane order survives
    key = 1 - textured.astype(jnp.int32)
    _k, s_idx, s_iota = jax.lax.sort([key, idx, iota], num_keys=1, is_stable=True)
    cnt = jnp.sum(textured.astype(jnp.int32))

    def small(_):
        part = cs.atlas[s_idx[:cap]]
        tex_sorted = jnp.concatenate(
            [part, jnp.zeros((n - cap,), cs.atlas.dtype)]
        )
        _i, tex = jax.lax.sort([s_iota, tex_sorted], num_keys=1, is_stable=True)
        return tex

    def big(_):
        return cs.atlas[idx]

    return jax.lax.cond(cnt <= cap, small, big, None)


def resolve_base_color(cs: CompiledScene, mat_color: V3, has_tex, tex_id, u, v) -> V3:
    """Texture sample where textured, material color elsewhere
    (``cuda_texture_renderer.py:206-219``)."""
    if cs.any_textured is not None and cs.any_textured.shape[0] == 0:
        # no textured primitive in the scene: ``has_tex`` is all-zero, so
        # the select below is identically ``mat_color`` — skip the atlas
        # gather entirely
        return mat_color
    textured = has_tex > 0.5
    if TEX_COMPACT and textured.ndim == 1 and int(textured.shape[0]) >= _COMPACT_MIN_LANES:
        idx = _nearest_index(tex_id, u, v, cs.tex_width, cs.tex_height,
                             cs.tex_offset, cs.n_textures)
        # untextured lanes point at texel 0: they are masked below, and one
        # hot index keeps them off random atlas cache lines in the fallback
        idx = jnp.where(textured, idx, 0)
        rgb = _unpack_rgb(_gather_texels_compact(cs, textured, idx))
        return V3.where(textured, rgb, mat_color)
    sampled = sample_atlas(cs, jnp.where(textured, tex_id, -1), u, v)
    return V3.where(textured, sampled, mat_color)


def resolve_base_color_lod(cs: CompiledScene, mat_color: V3, tex_id_f,
                           u, v, exact_lane) -> V3:
    """Depth-LOD base-color resolve (path tracer, ``texture_lod`` mode):
    lanes with ``exact_lane`` True sample the reference-exact full-res
    atlas; the rest sample the small ``mip_budget`` atlas.

    Non-exact lanes are pointed at texel 0 of the big atlas, so only the
    exact lanes (camera and first bounces, which are screen-coherent) spread
    over its cache lines.
    """
    textured = tex_id_f >= 0.0
    tex_id = jnp.where(textured, tex_id_f, 0.0).astype(jnp.int32)
    idx = _nearest_index(tex_id, u, v, cs.tex_width, cs.tex_height,
                         cs.tex_offset, cs.n_textures)
    take_exact = textured & exact_lane
    rgb_exact = _unpack_rgb(cs.atlas[jnp.where(take_exact, idx, 0)])
    midx = _nearest_index(tex_id, u, v, cs.mip_width, cs.mip_height,
                          cs.mip_offset, cs.n_textures)
    rgb_mip = _unpack_rgb(cs.mip_atlas[jnp.where(textured & ~exact_lane, midx, 0)])
    rgb = V3.where(exact_lane, rgb_exact, rgb_mip)
    return V3.where(textured, rgb, mat_color)


def texel_index(cs: CompiledScene, tex_id_f: jnp.ndarray, u: jnp.ndarray,
                v: jnp.ndarray) -> jnp.ndarray:
    """Flat full-atlas texel index per ray (same mapping as
    ``sample_atlas``; untextured lanes, ``tex_id_f < 0``, clamp to texture 0
    and are masked by the caller)."""
    tid = jnp.where(tex_id_f >= 0.0, tex_id_f, 0.0).astype(jnp.int32)
    return _nearest_index(tid, u, v, cs.tex_width, cs.tex_height,
                          cs.tex_offset, cs.n_textures)


def resolve_base_color_mip(cs: CompiledScene, mat_color: V3, tex_id_f,
                           u, v) -> V3:
    """Base color from the small ``mip_budget`` atlas where textured,
    material color elsewhere (deferred-texture mode's secondary bounces)."""
    textured = tex_id_f >= 0.0
    tid = jnp.where(textured, tex_id_f, 0.0).astype(jnp.int32)
    idx = _nearest_index(tid, u, v, cs.mip_width, cs.mip_height,
                         cs.mip_offset, cs.n_textures)
    rgb = _unpack_rgb(cs.mip_atlas[idx])
    return V3.where(textured, rgb, mat_color)
