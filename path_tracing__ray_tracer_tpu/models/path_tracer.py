"""Wavefront Monte-Carlo path tracer — the wavefront form of the reference's
``cuda_path_raytracer`` (``renderers/cuda_path_tracer.py``): global
illumination with next-event estimation, Russian roulette, a stochastic
three-event glass model, and ACES tonemapping.

The per-thread path loop becomes a masked ``lax.while_loop`` over the SoA ray
batch.  Every data-dependent branch of the reference kernel (hit/miss,
material class, TIR, RR kill, event choice) is a lane-wise select; randomness
is a pure function of (seed, pixel, sample, depth, use) via the counter RNG,
so progressive batches and sharded renders are reproducible by construction.

Reproduced stylized-physics details (SURVEY.md §2 quirks 6–7, §7):

* NEE at every bounce for every material class, shadow rays with
  ``t_max = 1e6`` (an occluder *beyond* the light still shadows,
  ``cuda_path_tracer.py:275-277``);
* light pdf ``1/num_lights`` with material-class intensity constants
  (refractive 4.0×0.6 / reflective 2.5×0.8 / diffuse 2.0×1.0, ``:285-296``);
* Russian roulette from depth ≥ 3 with Rec.601-luma survival (``:307-314``);
* glass = 60/25/15 refract/reflect/diffuse event mixture with pdf-corrected
  throughput (``:320-428``); fixed Fresnel probabilities, as in the reference
  (its Schlick helper is defined but never called, ``:135-136``);
* constant 0.1 sky on miss (``:234-239``), throughput cutoff 1e-3 (``:468``);
* ACES fit on the spp-averaged radiance, then truncate-quantize (``:52-58``).
"""
from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng
from ..ops.bounce import (
    EPS_OFFSET,
    P_DIFFUSE,
    P_REFLECT,
    P_REFRACT,
    SKY,
    T_MAX,
    T_MIN,
    U_EVENT,
    U_HEMI1,
    U_HEMI2,
    U_JITX,
    U_JITY,
    U_LIGHT,
    U_RR,
    BounceOut,
)
from ..ops.camera import generate_rays
from ..ops.intersect import resolve_material, scene_hit, scene_hit_any
from ..ops.sampling import cosine_hemisphere, pick_light
from ..ops.texture import resolve_base_color
from ..ops.tonemap import aces
from ..ops.v3 import V3, refract
from ..ops.pallas import bounce_triton
from .base import RendererFactory
from .wavefront import WavefrontRenderer

# Phase-1 → phase-2 cutover: phase 1 ends once at most N // _TAIL_DIV lanes
# are unfinished (rounded up to a _TAIL_QUANT-lane width).  Bigger divisors
# keep phase 1 running longer at full width; smaller ones hand stragglers to
# the compact tail earlier.  Read at trace time; results are bit-identical
# for any value (see the phase-2 docstring).  Unmeasured on the H100.
_TAIL_DIV = 64
# Tail width floor/rounding; tests shrink it so small chunks still exercise
# the phase-1 loop.
_TAIL_QUANT = 1024

# Phase-1 accumulator fold cadence.  The (NS, N) accumulator is ~200 MB at
# the bench shapes, and reading and writing it every iteration is pure
# memory traffic.  A lane finishes at most ONE item per iteration and each
# (item, lane) cell receives exactly one total contribution, so the loop
# instead carries a per-lane running path sum, parks finished items in
# _FOLD_EVERY pending slot rows, and folds them into the accumulator once
# per _FOLD_EVERY iterations — bit-identical (the per-cell addition tree is
# unchanged: 0 + x == x).  Unmeasured on the H100.
_FOLD_EVERY = 8

# Shuffled work assignment in the regeneration scheduler (see _regen_chunk):
# it equalizes lane workloads, since path length is strongly
# pixel-correlated.  Read at trace time.  Unmeasured on the H100.
_REGEN_SHUFFLE = True


def _zero(shape):
    return V3.full(0.0, shape)


def path_radiance(cs, org: V3, rd: V3, key: jnp.ndarray, max_depth: int,
                  shadow_tmax: str = "reference", kernel: bool = True) -> V3:
    """Trace one batch of camera rays to completion (one radiance sample).

    One loop over the shared per-bounce body (``_make_bounce_and_resolve``:
    the fused GPU kernel or the XLA ``_bounce_xla`` formulation) — the same
    physics the chunked regeneration driver (``_regen_chunk``) runs, minus
    the lane scheduling.
    """
    bounce_fn, resolve_fn = _make_bounce_and_resolve(cs, shadow_tmax, kernel)
    n = org.x.shape

    def cond(state):
        depth, *_rest, active = state
        return (depth < max_depth) & jnp.any(active)

    def body(state):
        depth, o, d, thr, color, active = state
        out = bounce_fn(o, d, thr, key, depth)
        base = resolve_fn(out)
        contrib = thr * out.w_sky + thr * (base * out.w_nee)
        color = color + V3.where(active, contrib, _zero(n))
        live = active & out.hit & ~out.killed
        thr_new = thr * out.rr_scale * (
            base * out.t_thr + V3(out.s_thr, out.s_thr, out.s_thr)
        )
        thr = V3.where(live, thr_new, thr)
        live = live & (thr.max_component() >= 0.001)
        o = V3.where(live, out.new_org, o)
        d = V3.where(live, out.new_dir, d)
        return depth + 1, o, d, thr, color, live

    init = (
        jnp.int32(0),
        org,
        rd,
        V3.full(1.0, n),
        _zero(n),
        jnp.ones(n, dtype=bool),
    )
    *_s, color, _a = jax.lax.while_loop(cond, body, init)
    return color


def _bounce_xla(cs, o: V3, d: V3, thr: V3, key, depth, shadow_tmax: str = "reference",
                hit_fn=scene_hit, any_fn=scene_hit_any, mat_fn=resolve_material):
    """One path-tracer bounce as plain XLA, returning the ``BounceOut``
    weight record (``ops/bounce.py``).  This is the reference formulation
    that the fused GPU kernel is tested against.

    Physics identical to the reference ``cuda_path_tracer.py`` (quirks
    included; see module docstring).  ``depth`` may be per-lane.

    ``hit_fn``/``any_fn``/``mat_fn`` answer the closest-hit, occlusion and
    material queries.  The fused kernel (``ops/pallas/bounce_triton.py``)
    runs this same function inside its body, with sequential sweeps over
    table views in their place.
    """
    n = o.x.shape
    depth = jnp.broadcast_to(jnp.asarray(depth, jnp.int32), n)
    hit = hit_fn(cs, o, d, T_MIN, T_MAX)
    mats = mat_fn(cs, hit.prim)
    (mcolor, diffuse, _spec, reflective, refractive, ior, has_tex, tex_id) = mats
    normal = hit.normal
    point = hit.point
    above = point + normal * EPS_OFFSET

    w_sky = jnp.where(hit.hit, 0.0, jnp.float32(SKY))

    # ---- next-event estimation (every bounce, every material) --------------
    if cs.n_lights > 0:
        r_light = rng.uniform(key, depth, U_LIGHT)
        ldir, dist, pdf = pick_light(cs, point, r_light)
        # default reproduces the reference quirk (t_max = 1e6: occluders
        # *beyond* the light still shadow, cuda_path_tracer.py:275-277);
        # shadow_tmax="light" bounds the walk at the sampled light point —
        # physically correct and much cheaper for BVH scenes, where an
        # unbounded any-walk must scan the whole ray (QUIRKS.md).
        limit = T_MAX if shadow_tmax == "reference" else dist - 1e-3
        cos_theta = jnp.maximum(ldir.dot(normal), 0.0)
        # lanes whose NEE term is zero regardless of occlusion — missed the
        # scene, light below the surface horizon, or a zero-diffuse material
        # — don't need the occlusion answer; limit = -1 lets the BVH
        # any-walk park them from step 0 so their blocks early-exit instead
        # of walking the tree (exact: w_nee is masked/zero for them below)
        care = hit.hit & (cos_theta > 0.0) & (diffuse > 0.0)
        limit = jnp.where(care, jnp.asarray(limit, jnp.float32), -1.0)
        occluded = any_fn(cs, above, ldir, T_MIN, limit)
        is_glass_cls = refractive > 0.5
        is_mirror_cls = reflective > 0.7
        intensity = jnp.where(is_glass_cls, 4.0, jnp.where(is_mirror_cls, 2.5, 2.0))
        multiplier = jnp.where(is_glass_cls, 0.6, jnp.where(is_mirror_cls, 0.8, 1.0))
        w_nee = jnp.where(
            hit.hit & ~occluded,
            diffuse * cos_theta * intensity * multiplier / pdf,
            0.0,
        )
    else:
        w_nee = jnp.zeros_like(w_sky)

    # ---- Russian roulette from depth >= 3 -----------------------------------
    survival = jnp.maximum(0.1, thr.luminance())
    rr_on = depth >= 3
    killed = rr_on & (rng.uniform(key, depth, U_RR) > survival)
    rr_scale = jnp.where(rr_on & ~killed, 1.0 / survival, 1.0)

    # ---- scatter event -------------------------------------------------------
    choice = rng.uniform(key, depth, U_EVENT)
    r1 = rng.uniform(key, depth, U_HEMI1)
    r2 = rng.uniform(key, depth, U_HEMI2)

    refl_dir = d.reflect(normal)
    hemi_dir = cosine_hemisphere(normal, r1, r2)

    # glass refraction event (cuda_path_tracer.py:328-388)
    cos_i = jnp.maximum(0.0, -d.dot(normal))
    entering = cos_i > 0.0
    eta = jnp.where(entering, 1.0 / ior, ior)
    outward = V3.where(entering, normal, -normal)
    refr_ok, refr_dir = refract(d, outward, eta)
    refr_org = V3.where(entering, point - normal * EPS_OFFSET, above)

    glass = refractive > 0.1
    mirror = ~glass & (reflective > 0.5)
    ev_refract = glass & (choice < P_REFRACT)
    ev_reflect = glass & (choice >= P_REFRACT) & (choice < P_REFRACT + P_REFLECT)
    ev_diffuse = glass & (choice >= P_REFRACT + P_REFLECT)

    new_d = V3.where(
        ev_refract,
        V3.where(refr_ok, refr_dir, refl_dir),  # TIR falls back to mirror
        V3.where(ev_reflect | mirror, refl_dir, hemi_dir),
    )
    new_o = V3.where(
        ev_refract,
        V3.where(refr_ok, refr_org, above),
        above,  # reflect/diffuse/mirror/lambertian all offset along +n
    )

    # throughput multiplier in (s + base·t) form (reference constants)
    s_thr = jnp.where(
        ev_refract,
        jnp.where(refr_ok, refractive / P_REFRACT, 0.9),  # TIR: flat 0.9
        0.0,
    )
    t_thr = jnp.where(
        ev_refract,
        0.0,
        jnp.where(
            ev_reflect,
            0.9 / P_REFLECT,
            jnp.where(
                ev_diffuse,
                diffuse * 3.0 / P_DIFFUSE,
                jnp.where(mirror, reflective, diffuse),
            ),
        ),
    )

    return BounceOut(
        hit=hit.hit,
        killed=killed,
        w_sky=w_sky,
        w_nee=w_nee,
        rr_scale=rr_scale,
        s_thr=s_thr,
        t_thr=t_thr,
        new_org=new_o,
        new_dir=new_d,
        u=hit.u,
        v=hit.v,
        tex_id=jnp.where(has_tex > 0.5, tex_id.astype(jnp.float32), -1.0),
        mat_color=mcolor,
    )


def _make_bounce_and_resolve(cs, shadow_tmax: str = "reference",
                             kernel: bool = True):
    """(bounce_fn, resolve_fn) for this scene.  The bounce is the fused GPU
    kernel where ``bounce_triton.use_kernel`` chooses it (``kernel=False``
    forces the XLA formulation), the XLA formulation elsewhere — both return
    the same ``BounceOut`` record.

    ``shadow_tmax`` ("reference" | "light") selects the NEE occlusion bound
    and is honored by both paths."""
    if kernel and bounce_triton.use_kernel(cs):
        def bounce_fn(o, d, thr, key, depth):
            return bounce_triton.path_bounce(
                cs, o, d, thr, key, depth, shadow_tmax=shadow_tmax
            )
    else:
        def bounce_fn(o, d, thr, key, depth):
            return _bounce_xla(cs, o, d, thr, key, depth, shadow_tmax=shadow_tmax)

    def resolve_fn(out):
        return resolve_base_color(
            cs,
            out.mat_color,
            (out.tex_id >= 0.0).astype(jnp.float32),
            out.tex_id.astype(jnp.int32),
            out.u,
            out.v,
        )

    return bounce_fn, resolve_fn


def _regen_chunk(
    cs,
    cam12,
    pix0,
    seed,
    sample_base,
    *,
    n_pix: int,
    width: int,
    height: int,
    n_samples: int,
    max_depth: int,
    jitter: str,
    shadow_tmax: str = "reference",
    lod_depth: int = 0,
    kernel: bool = True,
):
    """Radiance sums via *ray regeneration*: one persistent pool of ``n_pix``
    lanes where a lane that finishes a path (miss / RR kill / throughput
    cutoff / max depth) immediately starts its next (pixel, sample) work item
    instead of idling.

    Measured motivation (Cornell, depth 8): mean path length is 2.66 bounces,
    so the plain per-sample loop (``n_samples × max_depth`` full-width
    iterations) runs at ~33% lane occupancy.  Regeneration needs only
    ``Σ path length`` iterations per lane — ~3× fewer bounce executions.

    Two design points make it exact and fast:

    * **Shuffled work assignment.**  Path length is strongly pixel-correlated
      (glass-sphere pixels are always slow), so a lane that kept one pixel for
      all its samples would straggle.  Lane ``i``'s ``s``-th item is pixel
      ``(i + s·STRIDE) mod n_pix`` — per-sample golden-ratio offsets
      decorrelate lane workloads, and because the permutation is a pure
      shift, re-binning the per-(item) sums to pixels is ``n_samples`` static
      ``jnp.roll``s, not gathers.
    * **Narrow tail phase.**  The main loop runs while more than ``tail``
      lanes are unfinished; the stragglers are then compacted into one small
      batch that finishes at low width.  Contributions always accumulate in
      (sample, depth) order per pixel, so the result is bit-identical
      *across phase boundaries* — where the tail cutover falls cannot change
      the image.  (Against the separate per-sample-loop implementation the
      match is FMA-level, not bitwise: the two compiled loop bodies may
      reassociate differently — see tests/test_regen.py.)

    RNG keys are pure functions of (seed, pixel, sample), so every radiance
    sample is identical to the per-sample loop's — only lane scheduling
    changes.

    The two texture-approximation modes — deferred-texture (``mip_budget``)
    and texture-LOD (``lod_depth``) — live in ``models/experimental.py``;
    requesting either delegates there so this production path stays
    single-mode.
    """
    if lod_depth > 0 or cs.mip_atlas is not None:
        from .experimental import regen_chunk_modes

        return regen_chunk_modes(
            cs, cam12, pix0, seed, sample_base, n_pix=n_pix, width=width,
            height=height, n_samples=n_samples, max_depth=max_depth,
            jitter=jitter, shadow_tmax=shadow_tmax, lod_depth=lod_depth,
            kernel=kernel,
        )

    NS = int(n_samples)
    N = int(n_pix)
    STRIDE = (int(N * 0.6180339887) | 1) % N if (NS > 1 and _REGEN_SHUFFLE) else 0
    total = width * height
    iter_cap = NS * max_depth + 2  # loop provably terminates; belt-and-braces
    bounce_fn, resolve_fn = _make_bounce_and_resolve(cs, shadow_tmax, kernel)

    def make_ray(lane_ids, s):
        """Camera ray + RNG key for lane ``lane_ids``'s item ``s`` — exactly
        the per-sample loop's ray for (pixel, sample), quirks included."""
        p_local = (lane_ids + s * STRIDE) % N
        idx = pix0 + p_local
        safe = jnp.minimum(idx, total - 1)
        x = (safe % width).astype(jnp.float32)
        y = (safe // width).astype(jnp.float32)
        key = rng.ray_key(seed, idx, sample_base + s)
        if jitter == "center":
            r1 = r2 = jnp.float32(0.5)
        else:
            r1 = rng.uniform(key, max_depth, U_JITX)
            r2 = r1 if jitter == "diagonal" else rng.uniform(key, max_depth, U_JITY)
        u = (x + r1) / width
        v = (y + r2) / height
        o, d = generate_rays(cam12, u, v)
        return o, d, key

    def bounce_step(lane_ids, st):
        """One bounce for every lane; finished lanes regenerate in place.
        Returns the new ray state plus this iteration's contribution, item
        id and done mask for the caller's accumulator."""
        o, d, thr, key, depth, s = st
        m = o.x.shape
        active = s < NS
        out = bounce_fn(o, d, thr, key, depth)
        base = resolve_fn(out)
        cA = thr * out.w_sky + thr * (base * out.w_nee)
        cA = V3.where(active, cA, V3.full(0.0, m))
        live = active & out.hit & ~out.killed
        thr_new = thr * out.rr_scale * (
            base * out.t_thr + V3(out.s_thr, out.s_thr, out.s_thr)
        )
        thr = V3.where(live, thr_new, thr)
        live = live & (thr.max_component() >= 0.001)
        ndepth = depth + 1
        live = live & (ndepth < max_depth)

        done = active & ~live
        s2 = s + done.astype(jnp.int32)
        o_new, d_new, key_new = make_ray(lane_ids, s2)
        regen = done & (s2 < NS)
        o = V3.where(regen, o_new, V3.where(live, out.new_org, o))
        d = V3.where(regen, d_new, V3.where(live, out.new_dir, d))
        thr = V3.where(regen, V3.full(1.0, m), thr)
        key = jnp.where(regen, key_new, key)
        depth = jnp.where(live, ndepth, jnp.int32(0))
        return (o, d, thr, key, depth, s2), cA, s, done

    lane = jnp.arange(N, dtype=jnp.int32)
    o0, d0, key0 = make_ray(lane, jnp.zeros((N,), jnp.int32))
    state0 = (
        o0, d0, V3.full(1.0, (N,)), key0,
        jnp.zeros((N,), jnp.int32), jnp.zeros((N,), jnp.int32),
    )
    acc0 = tuple(jnp.zeros((NS, N), jnp.float32) for _ in range(3))

    # ---- phase 1: full width, slot-buffered accumulation into (NS, N) ------
    q = _TAIL_QUANT
    tail = min(-(-max(q, N // _TAIL_DIV) // q) * q, N)
    item_rows = jax.lax.broadcasted_iota(jnp.int32, (NS, N), 0)

    # K-slot fold (module note at _FOLD_EVERY): the loop carries a per-
    # lane running path sum; a finishing lane parks (item, sum) in slot
    # row (k) and the (NS, N) accumulator is touched once per K bounces.
    # Bit-identical to the per-iteration fold: every (item, lane) cell
    # receives exactly one add, and the within-item chain is unchanged.
    K = _FOLD_EVERY
    zeroN = V3.full(0.0, (N,))

    def cond1(carry):
        st, _acc, _psum, it = carry
        return (jnp.sum(st[5] < NS) > tail) & (it < iter_cap)

    def body1(carry):
        st, acc, psum, it = carry
        slot_item0 = jnp.full((K, N), NS, jnp.int32)
        slot_val0 = V3.full(0.0, (K, N))

        def step(k, c):
            st, psum, s_item, s_val, it = c
            st, cA, item, done = bounce_step(lane, st)
            psum = psum + cA
            s_item = s_item.at[k].set(jnp.where(done, item, NS))
            s_val = V3(
                s_val.x.at[k].set(jnp.where(done, psum.x, 0.0)),
                s_val.y.at[k].set(jnp.where(done, psum.y, 0.0)),
                s_val.z.at[k].set(jnp.where(done, psum.z, 0.0)),
            )
            psum = V3.where(done, zeroN, psum)
            return st, psum, s_item, s_val, it + 1

        st, psum, s_item, s_val, it = jax.lax.fori_loop(
            0, K, step, (st, psum, slot_item0, slot_val0, it)
        )
        # distinct slots hold distinct items per lane, so the K one-hot
        # rows never overlap; the accumulator is read+written once here
        adds = [jnp.float32(0.0)] * 3
        for k in range(K):
            hit_row = item_rows == s_item[k][None, :]
            for c, ch in enumerate((s_val.x, s_val.y, s_val.z)):
                adds[c] = adds[c] + jnp.where(hit_row, ch[k][None, :], 0.0)
        acc = tuple(a + add for a, add in zip(acc, adds))
        return st, acc, psum, it

    st1, acc, psum1, _it = jax.lax.while_loop(
        cond1, body1, (state0, acc0, zeroN, jnp.int32(0))
    )
    o, d, thr, key, depth, s = st1

    # ---- phase 2: compact the ≤ tail stragglers, finish at low width --------
    unfinished = s < NS
    cnt = jnp.sum(unfinished.astype(jnp.int32))
    pos = jnp.cumsum(unfinished.astype(jnp.int32)) - 1
    scatter_to = jnp.where(unfinished, pos, tail)
    sel = jnp.zeros((tail,), jnp.int32).at[scatter_to].set(lane, mode="drop")
    valid = jnp.arange(tail, dtype=jnp.int32) < cnt

    st_t = (
        o.take(sel), d.take(sel), thr.take(sel), key[sel], depth[sel],
        jnp.where(valid, s[sel], NS),
    )
    # flush the carried mid-item path sums into their cells; phase 2
    # then keeps adding per-bounce — the per-cell chain stays sequential
    psum_t = psum1.take(sel)
    item_cur = st_t[5]
    acc = tuple(
        a.at[item_cur, sel].add(jnp.where(valid, c, 0.0), mode="drop")
        for a, c in zip(acc, (psum_t.x, psum_t.y, psum_t.z))
    )

    def cond2(carry):
        st, _acc, it = carry
        return jnp.any(st[5] < NS) & (it < iter_cap)

    def body2(carry):
        st, acc, it = carry
        st, cA, item, _done = bounce_step(sel, st)
        # contributions scatter straight into the phase-1 accumulator rows,
        # preserving per-item (sample, depth) addition order exactly
        item_safe = jnp.where(valid, item, NS)  # out of range → dropped
        new = tuple(
            a.at[item_safe, sel].add(jnp.where(valid, c, 0.0), mode="drop")
            for a, c in zip(acc, (cA.x, cA.y, cA.z))
        )
        return st, new, it + 1

    _st, acc, _it2 = jax.lax.while_loop(cond2, body2, (st_t, acc, jnp.int32(0)))

    # ---- re-bin items to pixels: inverse of the shift permutation ----------
    out = V3(acc[0][0], acc[1][0], acc[2][0])
    for si in range(1, NS):
        shift = (si * STRIDE) % N
        out = out + V3(
            jnp.roll(acc[0][si], shift),
            jnp.roll(acc[1][si], shift),
            jnp.roll(acc[2][si], shift),
        )
    return out


@partial(
    jax.jit,
    static_argnames=("n_pix", "width", "height", "n_samples", "max_depth",
                     "jitter", "shadow_tmax", "lod_depth", "kernel"),
)
def _path_chunk(
    cs,
    cam12,
    pix0,
    seed,
    sample_base,
    *,
    n_pix: int,
    width: int,
    height: int,
    n_samples: int,
    max_depth: int,
    jitter: str,
    shadow_tmax: str = "reference",
    lod_depth: int = 0,
    kernel: bool = True,
):
    """Radiance sums over ``n_samples`` independent samples for one pixel chunk.

    Per-sample pixel jitter is uniform (``cuda_path_tracer.py:34-36``); in
    ``faithful`` mode the x and y jitters share one draw (the reference reads
    the unadvanced RNG state twice — SURVEY.md §2 quirk 2).  Work is scheduled
    by ray regeneration (see ``_regen_chunk``): same RNG streams and per-item
    math as the per-sample loop over ``path_radiance``, equal up to FMA-level
    reassociation between the two compiled loop bodies (tests/test_regen.py
    bounds the drift; renders for a fixed scheduler are exactly
    deterministic and chunk/shard/progressive-invariant).
    """
    return _regen_chunk(
        cs,
        cam12,
        pix0,
        seed,
        sample_base,
        n_pix=n_pix,
        width=width,
        height=height,
        n_samples=n_samples,
        max_depth=max_depth,
        jitter=jitter,
        shadow_tmax=shadow_tmax,
        lod_depth=lod_depth,
        kernel=kernel,
    )


class PathTracer(WavefrontRenderer):
    """Parity renderer for ``cuda_path_raytracer`` — the flagship model."""

    def __init__(self, sample_group: int = 128, jitter: str = "independent",
                 shadow_tmax: str = "reference", mip_budget: int = 0,
                 texture_lod: int = 0, texture_lod_depth: int = 2, **kw):
        # sample_group 128: bigger groups amortize dispatch overhead and
        # regeneration tails, while the (NS, N) accumulator fold grows with
        # NS.  Unmeasured on the H100.  Groups clamp to spp, and renders are
        # group-invariant bit-for-bit (tests/test_regen.py), so this is a
        # pure scheduling knob.
        # independent x/y jitter by default: strictly better sampling, and the
        # reference hero image is a missing blob so there is no RMSE target
        # (BASELINE.md); pass jitter="diagonal" for the quirk-exact stream.
        # shadow_tmax="light" bounds NEE occlusion at the sampled light
        # (physically correct, cheaper for BVH scenes) instead of the
        # reference's 1e6 quirk.
        # mip_budget > 0 enables deferred-texture mode (_regen_chunk doc):
        # camera-bounce textures stay exact, bounces >= 1 sample a
        # mip_budget-capped mip — the exact atlas gather then runs once per
        # path instead of once per bounce.  Off by default.
        # texture_lod > 0 enables texture-LOD mode: camera rays and bounces
        # below ``texture_lod_depth`` keep the reference-exact full-res
        # gather, deeper bounces sample a texture_lod-capped mip, so only the
        # shallow (screen-coherent) lanes read the big atlas.  texture_budget
        # stays untouched.
        assert not (mip_budget and texture_lod), \
            "deferred-texture and texture-LOD modes are mutually exclusive"
        if mip_budget or texture_lod:
            co = dict(kw.pop("compile_overrides", None) or {})
            co.setdefault("mip_budget", int(mip_budget or texture_lod))
            kw["compile_overrides"] = co
        super().__init__("tpu_path_raytracer", jitter=jitter, **kw)
        self.sample_group = int(sample_group)
        self.shadow_tmax = str(shadow_tmax)
        self.lod_depth = int(texture_lod_depth) if texture_lod else 0

    def get_capabilities(self) -> List[str]:
        return [
            "path_tracing",
            "global_illumination",
            "monte_carlo",
            "next_event_estimation",
            "russian_roulette",
            "soft_shadows",
            "caustics",
            "reflection",
            "refraction",
            "textures",
            "aces_tonemapping",
            "gpu_acceleration",
            "progressive_rendering",
            "xla_compute",
        ]

    def _samples_per_group(self, spp: int) -> int:
        return max(1, min(self.sample_group, spp))

    def _make_chunk_fn(self, static_key):
        n_pix, w, h, _spp, max_depth, group, jitter = static_key
        return partial(
            _path_chunk,
            n_pix=n_pix,
            width=w,
            height=h,
            n_samples=group,
            max_depth=max_depth,
            jitter=jitter,
            shadow_tmax=self.shadow_tmax,
            lod_depth=self.lod_depth,
            kernel=bounce_triton.ENABLED,
        )

    def render_sums(self, scene, camera, settings, sample_offset=0, n_samples=None):
        spp = settings.samples_per_pixel if n_samples is None else n_samples
        group = self._samples_per_group(settings.samples_per_pixel)
        if spp % group != 0:
            # keep groups uniform so there is exactly one compiled chunk fn
            group = next(g for g in range(min(group, spp), 0, -1) if spp % g == 0)
            self.sample_group = group
        return super().render_sums(
            scene, camera, settings, sample_offset=sample_offset, n_samples=spp
        )

    def _finalize_dev(self, sums, spp_total: int, settings):
        return aces(jnp.asarray(sums) / float(spp_total))


RendererFactory.register("tpu_path_raytracer", PathTracer)
RendererFactory.register_alias("cuda_path_raytracer", "tpu_path_raytracer")
