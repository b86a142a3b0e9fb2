"""Texture-approximation scheduler modes of the path tracer.

This module holds the full-featured variant of the regeneration scheduler
with two modes that trade exact secondary-bounce textures for fewer reads of
the full-resolution atlas.  Both are off by default and proven against the
exact path in tests; neither is measured on the H100.

* **Deferred-texture mode** (``compile_scene(mip_budget=...)``): exact atlas
  gather once per path instead of once per bounce, secondary bounces from a
  mip.
* **Texture-LOD mode** (``PathTracer(texture_lod=...)``): full-res gather
  for shallow bounces, mip for deep ones.

``models.path_tracer._regen_chunk`` (the production path) delegates here
whenever one of the modes is requested, so the hot file stays single-mode.
The standard path of the scheduler below is equivalence-tested against the
production one (tests/test_regen.py), and the modes in
test_defer_texture.py and test_texture_lod.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import rng
from ..ops.bounce import U_JITX, U_JITY
from ..ops.camera import generate_rays
from ..ops.texture import (
    resolve_base_color_lod,
    resolve_base_color_mip,
    texel_index,
)
from ..ops.v3 import V3


def regen_chunk_modes(
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

    **Deferred-texture mode** (active when the scene carries a mip atlas,
    ``compile_scene(mip_budget=...)``): the exact atlas gather runs once per
    *item* instead of once per *bounce*.  A path's radiance is linear in its
    camera-bounce base color (each bounce's base enters its own NEE term and
    the throughput as an exponent-0/1 factor), so the loop accumulates
    ``A + base₀·B`` per item with base₀ symbolic: the camera bounce records
    its exact texel index (vector math, no gather), bounces ≥ 1 sample the
    small mip, and ONE bulk gather per chunk resolves every item's base₀ at
    the fold.  RR/cutoff decisions use the mip-estimated throughput, so with
    ``mip_budget == texture_budget`` the mode reproduces the exact path
    bit-for-bit up to FMA reassociation (tested); with a real (smaller) mip
    only secondary-bounce texture detail is approximated — the
    camera-visible texture stays exact.
    """
    # scheduler knobs are shared with the production module so tests that
    # monkeypatch path_tracer._TAIL_QUANT etc. affect both paths identically
    from . import path_tracer as _pt

    _REGEN_SHUFFLE = _pt._REGEN_SHUFFLE
    _TAIL_DIV = _pt._TAIL_DIV
    _TAIL_QUANT = _pt._TAIL_QUANT
    _FOLD_EVERY = _pt._FOLD_EVERY
    NS = int(n_samples)
    N = int(n_pix)
    STRIDE = (int(N * 0.6180339887) | 1) % N if (NS > 1 and _REGEN_SHUFFLE) else 0
    total = width * height
    iter_cap = NS * max_depth + 2  # loop provably terminates; belt-and-braces
    from .path_tracer import _make_bounce_and_resolve

    bounce_fn, resolve_fn = _make_bounce_and_resolve(cs, shadow_tmax, kernel)
    # texture-LOD mode (``texture_lod``): bounces at depth >= lod_depth
    # sample the small mip atlas instead of the full-res one — see
    # resolve_base_color_lod.  Takes precedence over deferred-texture mode.
    lod = lod_depth > 0 and cs.mip_atlas is not None
    defer = not lod and cs.mip_atlas is not None

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
        Returns the new ray state plus this iteration's contributions and
        item ids for the caller's accumulator.  In deferred mode ``thr`` is
        the base₀-free throughput, ``e`` says whether base₀ is pending in it,
        and ``b0m`` is the mip estimate of base₀ (RR/cutoff decisions use
        ``thr·b0m^e`` so they match the exact path when mip == atlas)."""
        if defer:
            o, d, thr, key, depth, s, e, b0m = st
        else:
            o, d, thr, key, depth, s = st
            e = b0m = None
        m = o.x.shape
        active = s < NS
        thr_dec = V3.where(e, thr * b0m, thr) if defer else thr
        out = bounce_fn(o, d, thr_dec, key, depth)
        zero = V3.full(0.0, m)
        if defer:
            base = resolve_base_color_mip(
                cs, out.mat_color, out.tex_id, out.u, out.v
            )
            defer_now = (depth == 0) & (out.tex_id >= 0.0)
            idx0 = texel_index(cs, out.tex_id, out.u, out.v)
            full = thr * out.w_sky + thr * (base * out.w_nee)
            cA = V3.where(defer_now, thr * out.w_sky, V3.where(e, zero, full))
            cB = V3.where(defer_now, thr * out.w_nee, V3.where(e, full, zero))
            cA = V3.where(active, cA, zero)
            cB = V3.where(active, cB, zero)
            base_thr = V3.where(defer_now, V3.full(1.0, m), base)
            e2 = jnp.where(defer_now, out.t_thr > 0.0, e)
            b0m2 = V3.where(defer_now, base, b0m)
        else:
            if lod:
                base = resolve_base_color_lod(
                    cs, out.mat_color, out.tex_id, out.u, out.v,
                    depth < lod_depth,
                )
            else:
                base = resolve_fn(out)
            cA = thr * out.w_sky + thr * (base * out.w_nee)
            cA = V3.where(active, cA, zero)
            cB = idx0 = defer_now = None
            base_thr = base
            e2 = b0m2 = None
        live = active & out.hit & ~out.killed
        thr_new = thr * out.rr_scale * (
            base_thr * out.t_thr + V3(out.s_thr, out.s_thr, out.s_thr)
        )
        thr = V3.where(live, thr_new, thr)
        thr_cut = V3.where(e2, thr * b0m2, thr) if defer else thr
        live = live & (thr_cut.max_component() >= 0.001)
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
        if defer:
            e2 = jnp.where(regen, False, e2)
            b0m2 = V3.where(regen, V3.full(1.0, m), b0m2)
            st2 = (o, d, thr, key, depth, s2, e2, b0m2)
        else:
            st2 = (o, d, thr, key, depth, s2)
        return st2, cA, cB, idx0, defer_now, s, done

    lane = jnp.arange(N, dtype=jnp.int32)
    o0, d0, key0 = make_ray(lane, jnp.zeros((N,), jnp.int32))
    state0 = (
        o0, d0, V3.full(1.0, (N,)), key0,
        jnp.zeros((N,), jnp.int32), jnp.zeros((N,), jnp.int32),
    )
    if defer:
        state0 = state0 + (jnp.zeros((N,), bool), V3.full(1.0, (N,)))
    acc0 = tuple(jnp.zeros((NS, N), jnp.float32) for _ in range(6 if defer else 3))
    if defer:
        acc0 = acc0 + (jnp.zeros((NS, N), jnp.int32),)  # exact base₀ texel ids

    def chans(cA, cB):
        return (cA.x, cA.y, cA.z) + ((cB.x, cB.y, cB.z) if defer else ())

    # ---- phase 1: full width, slot-buffered accumulation into (NS, N) ------
    q = _TAIL_QUANT
    tail = min(-(-max(q, N // _TAIL_DIV) // q) * q, N)
    item_rows = jax.lax.broadcasted_iota(jnp.int32, (NS, N), 0)

    if defer:
        # deferred-texture mode (gated off by default) keeps the simple
        # per-iteration one-hot fold: its extra idx0/cB bookkeeping is per-
        # bounce, and the mode is not the production path
        def cond1(carry):
            st, _acc, it = carry
            return (jnp.sum(st[5] < NS) > tail) & (it < iter_cap)

        def body1(carry):
            st, acc, it = carry
            st, cA, cB, idx0, dmask, item, _done = bounce_step(lane, st)
            hit_row = item_rows == item[None, :]
            new = tuple(
                a + jnp.where(hit_row, c[None, :], 0.0)
                for a, c in zip(acc, chans(cA, cB))
            )
            new = new + (
                acc[-1] + jnp.where(hit_row & dmask[None, :], idx0[None, :], 0),
            )
            return st, new, it + 1

        st1, acc, _it = jax.lax.while_loop(
            cond1, body1, (state0, acc0, jnp.int32(0))
        )
        psum1 = None
    else:
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
                st, cA, _cB, _i0, _dm, item, done = bounce_step(lane, st)
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
    o, d, thr, key, depth, s = st1[:6]

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
    if defer:
        st_t = st_t + (st1[6][sel], st1[7].take(sel))
    else:
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
        st, cA, cB, idx0, dmask, item, _done = bounce_step(sel, st)
        # contributions scatter straight into the phase-1 accumulator rows,
        # preserving per-item (sample, depth) addition order exactly
        item_safe = jnp.where(valid, item, NS)  # out of range → dropped
        new = tuple(
            a.at[item_safe, sel].add(jnp.where(valid, c, 0.0), mode="drop")
            for a, c in zip(acc, chans(cA, cB))
        )
        if defer:
            new = new + (
                acc[-1].at[item_safe, sel].add(
                    jnp.where(valid & dmask, idx0, 0), mode="drop"
                ),
            )
        return st, new, it + 1

    _st, acc, _it2 = jax.lax.while_loop(cond2, body2, (st_t, acc, jnp.int32(0)))

    # ---- resolve deferred base₀ (ONE bulk gather per chunk) -----------------
    if defer:
        idxs = jnp.clip(acc[-1].reshape(-1), 0, int(cs.atlas.shape[0]) - 1)
        texel = cs.atlas[idxs].reshape(NS, N)
        inv255 = jnp.float32(1.0 / 255.0)
        b0 = (
            (texel & 0xFF).astype(jnp.float32) * inv255,
            ((texel >> 8) & 0xFF).astype(jnp.float32) * inv255,
            ((texel >> 16) & 0xFF).astype(jnp.float32) * inv255,
        )
        rows = tuple(acc[c] + b0[c] * acc[3 + c] for c in range(3))
    else:
        rows = acc[:3]

    # ---- re-bin items to pixels: inverse of the shift permutation ----------
    out = V3(rows[0][0], rows[1][0], rows[2][0])
    for si in range(1, NS):
        shift = (si * STRIDE) % N
        out = out + V3(
            jnp.roll(rows[0][si], shift),
            jnp.roll(rows[1][si], shift),
            jnp.roll(rows[2][si], shift),
        )
    return out


