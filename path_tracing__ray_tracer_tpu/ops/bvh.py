"""Flat BVH: deterministic host-side build, stackless device traversal.

The reference's pointer-tree BVH (``core/acceleration.py``) is CPU-only and
random-axis (SURVEY.md §2 quirks 1 & 11); no GPU renderer uses it.  This is
the device-side replacement for large scenes:

* **Build** (host, numpy; optionally the C++ builder in ``native/``): binned
  SAH over triangle centroids, deterministic, emitting nodes in DFS order.
* **Layout**: SoA node arrays with *skip links* — node ``i``'s first child is
  ``i+1``; ``skip[i]`` jumps over the subtree when its box is missed (and
  past a leaf after its primitives are tested).  Leaves hold exactly
  ``LEAF_SIZE`` primitive slots, padded with ``-1`` sentinels, so every leaf
  visit tests a fixed number of primitives — no data-dependent trip counts
  inside the lock-step walk.
* **Traversal** (device): every ray carries its own node cursor; one
  ``lax.while_loop`` advances all cursors until all rays run off the end.
  All node/primitive accesses are vectorized gathers.

Used for triangles only: planes and spheres stay in the brute-force broadcast
sweep (scenes carry a handful of each; meshes are where N explodes).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .v3 import V3

# leaves hold up to LEAF_SIZE triangles.  Fat leaves shrink the tree (fewer
# walk steps, each a full-width gather of node boxes) at the price of more
# triangle tests per leaf visit.  Unmeasured on the H100.
LEAF_SIZE = 16
_SAH_BINS = 16
# candidate split axes per node: 1 = largest centroid-extent axis only
# (round-1 builder, matches native/bvh_builder.cpp), 3 = evaluate all three
# axes and take the global minimum SAH cost.  Walk-simulated on the 11.5K-tri
# mesh (sim_traversal, subtree+octant+morton key): 3-axis trades pops −4%
# for leaf visits +1% — net flat, so the default stays 1 and the native
# builder needs no port (recorded negative, round 3).
SAH_AXES = 1


class FlatBVH(NamedTuple):
    lo: jnp.ndarray  # (M, 3) f32 box min (kept packed: gathered whole per step)
    hi: jnp.ndarray  # (M, 3) f32 box max
    skip: jnp.ndarray  # (M,) i32: next node when this box is missed / leaf done
    is_leaf: jnp.ndarray  # (M,) bool
    slots: jnp.ndarray  # (M, LEAF_SIZE) i32 triangle ids, -1 padded

    @property
    def n_nodes(self) -> int:
        return int(self.skip.shape[0])


class _Node:
    __slots__ = ("lo", "hi", "left", "right", "prims")

    def __init__(self, lo, hi, left=None, right=None, prims=None):
        self.lo, self.hi = lo, hi
        self.left, self.right = left, right
        self.prims = prims  # leaf primitive ids (np array) or None


def _build_tree(tri_min, tri_max, centroids, idx, leaf_size) -> _Node:
    lo = tri_min[idx].min(axis=0)
    hi = tri_max[idx].max(axis=0)
    if len(idx) <= leaf_size:
        return _Node(lo, hi, prims=idx)

    c = centroids[idx]
    major = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    axes = (major,) if SAH_AXES == 1 else (0, 1, 2)

    def half_area(a, b):
        d = np.maximum(b - a, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    left_idx = right_idx = None
    best_cost = np.inf
    for axis in axes:
        cmin, cmax = float(c[:, axis].min()), float(c[:, axis].max())
        if cmax - cmin <= 1e-12:
            continue
        bins = np.minimum(
            ((c[:, axis] - cmin) / (cmax - cmin) * _SAH_BINS).astype(np.int32),
            _SAH_BINS - 1,
        )
        for split in range(1, _SAH_BINS):
            mask = bins < split
            nl = int(mask.sum())
            if nl == 0 or nl == len(idx):
                continue
            cost = half_area(
                tri_min[idx[mask]].min(axis=0), tri_max[idx[mask]].max(axis=0)
            ) * nl + half_area(
                tri_min[idx[~mask]].min(axis=0), tri_max[idx[~mask]].max(axis=0)
            ) * (len(idx) - nl)
            if cost < best_cost:
                best_cost = cost
                left_idx, right_idx = idx[mask], idx[~mask]

    if left_idx is None:  # degenerate spread → stable median split
        order = np.argsort(c[:, major], kind="stable")
        half = len(idx) // 2
        left_idx, right_idx = idx[order[:half]], idx[order[half:]]

    left = _build_tree(tri_min, tri_max, centroids, left_idx, leaf_size)
    right = _build_tree(tri_min, tri_max, centroids, right_idx, leaf_size)
    return _Node(lo, hi, left=left, right=right)


def build_bvh(
    tri_min: np.ndarray,
    tri_max: np.ndarray,
    leaf_size: int = LEAF_SIZE,
    use_native: bool = True,
):
    """Binned-SAH BVH over triangle AABBs ``(T, 3)``.

    Prefers the C++ builder (``native/bvh_builder.cpp``, same output format);
    falls back to this module's numpy implementation.
    """
    if use_native:
        try:
            from ..native import load_bvh_builder

            native = load_bvh_builder()
            if native is not None:
                arrs = native(
                    np.asarray(tri_min, np.float32),
                    np.asarray(tri_max, np.float32),
                    leaf_size,
                )
                if arrs is not None:
                    return arrs
        except Exception:
            pass  # never let the fast path break a render

    import sys

    t = tri_min.shape[0]
    assert t > 0
    centroids = ((tri_min + tri_max) * 0.5).astype(np.float64)

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 8 * t + 1000))
    try:
        root = _build_tree(
            tri_min.astype(np.float64), tri_max.astype(np.float64),
            centroids, np.arange(t, dtype=np.int32), leaf_size,
        )
    finally:
        sys.setrecursionlimit(limit)

    lo, hi, skip, is_leaf, slots = [], [], [], [], []

    def flatten(node: _Node, skip_to: int):
        """DFS emit; ``skip_to`` is the node index control flow resumes at
        when this subtree is done/missed.  Uses a sentinel then patches,
        because child indices aren't known until emitted."""
        me = len(lo)
        lo.append(node.lo)
        hi.append(node.hi)
        skip.append(skip_to)
        if node.prims is not None:
            is_leaf.append(True)
            row = np.full(leaf_size, -1, dtype=np.int32)
            row[: len(node.prims)] = node.prims
            slots.append(row)
        else:
            is_leaf.append(False)
            slots.append(np.full(leaf_size, -1, dtype=np.int32))
            flatten(node.left, skip_to=-1)  # patched: right root known after
            right_root = len(lo)
            _patch_subtree_skip(me + 1, right_root)
            flatten(node.right, skip_to=skip_to)
        return me

    def _patch_subtree_skip(left_root: int, right_root: int):
        # every skip in the left subtree that still points at the sentinel
        # resolves to the right subtree root
        for j in range(left_root, right_root):
            if skip[j] == -1:
                skip[j] = right_root

    _END = -2  # sentinel for "walk finished"
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 8 * t + 1000))
    flatten(root, skip_to=_END)
    m = len(lo)
    skip_np = np.asarray(skip, dtype=np.int32)
    skip_np[skip_np == _END] = m
    skip_np[skip_np == -1] = m  # safety: unresolved sentinels exit the walk

    return {
        "lo": np.asarray(lo, dtype=np.float32),
        "hi": np.asarray(hi, dtype=np.float32),
        "skip": skip_np,
        "is_leaf": np.asarray(is_leaf, dtype=bool),
        "slots": np.stack(slots).astype(np.int32),
    }


def to_device(arrs) -> FlatBVH:
    """Upload a ``build_bvh`` result."""
    return FlatBVH(
        lo=jnp.asarray(arrs["lo"]),
        hi=jnp.asarray(arrs["hi"]),
        skip=jnp.asarray(arrs["skip"]),
        is_leaf=jnp.asarray(arrs["is_leaf"]),
        slots=jnp.asarray(arrs["slots"]),
    )


def traverse_closest(
    bvh: FlatBVH,
    tris,  # TrianglesSoA
    ro: V3,
    rd: V3,
    t_min: float,
    t_max,
    tri_offset: int = 0,
):
    """Closest triangle hit via skip-link walk.

    Returns ``(best_t, best_idx)`` where ``best_idx`` is the *global*
    primitive id (``tri_offset`` + triangle index) or ``-1``.  Semantics
    match the brute-force sweep: strict ``<`` against the running best, so
    results are identical up to tie order (the BVH visits in SAH order, not
    list order — ties between *exactly* equal t may differ; see QUIRKS.md).
    """
    n = ro.x.shape[0]
    m = bvh.n_nodes
    inv = V3(
        1.0 / jnp.where(jnp.abs(rd.x) > 1e-12, rd.x, 1e-12),
        1.0 / jnp.where(jnp.abs(rd.y) > 1e-12, rd.y, 1e-12),
        1.0 / jnp.where(jnp.abs(rd.z) > 1e-12, rd.z, 1e-12),
    )

    # Safety bound: the skip-walk advances every cursor monotonically, so a
    # correct tree terminates in ≤ m iterations; the cap turns a corrupted
    # tree (cycle) into a truncated render instead of a hung device.
    def cond(state):
        step, cursor, _bt, _bi = state
        return (step < m + 1) & jnp.any(cursor < m)

    def body(state):
        step, cursor, best_t, best_idx = state
        node = jnp.minimum(cursor, m - 1)

        lo = bvh.lo[node]  # (N, 3) gathers
        hi = bvh.hi[node]
        t0 = (lo[:, 0] - ro.x) * inv.x
        t1 = (hi[:, 0] - ro.x) * inv.x
        tx0, tx1 = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        t0 = (lo[:, 1] - ro.y) * inv.y
        t1 = (hi[:, 1] - ro.y) * inv.y
        ty0, ty1 = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        t0 = (lo[:, 2] - ro.z) * inv.z
        t1 = (hi[:, 2] - ro.z) * inv.z
        tz0, tz1 = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        enter = jnp.maximum(jnp.maximum(tx0, ty0), jnp.maximum(tz0, t_min))
        exit_ = jnp.minimum(jnp.minimum(tx1, ty1), jnp.minimum(tz1, best_t))
        box_hit = enter <= exit_

        active = cursor < m
        leaf = bvh.is_leaf[node] & box_hit & active

        # fixed-size leaf test: LEAF_SIZE Möller–Trumbore evaluations
        for k in range(bvh.slots.shape[1]):
            tri = bvh.slots[node, k]
            valid_slot = leaf & (tri >= 0)
            ti = jnp.maximum(tri, 0)
            v0 = tris.v0.take(ti)
            e1 = tris.v1.take(ti) - v0
            e2 = tris.v2.take(ti) - v0
            h = rd.cross(e2)
            det = e1.dot(h)
            ok = jnp.abs(det) > 1e-6
            inv_det = 1.0 / jnp.where(ok, det, 1.0)
            s = ro - v0
            u = inv_det * s.dot(h)
            q = s.cross(e1)
            v = inv_det * rd.dot(q)
            t = inv_det * e2.dot(q)
            win = (
                valid_slot & ok
                & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > t_min) & (t < best_t)
            )
            best_t = jnp.where(win, t, best_t)
            best_idx = jnp.where(win, tri_offset + ti, best_idx)

        # advance: into subtree on inner-box hit, else skip
        descend = box_hit & ~bvh.is_leaf[node] & active
        nxt = jnp.where(descend, cursor + 1, bvh.skip[node])
        cursor = jnp.where(active, nxt, cursor)
        return step + 1, cursor, best_t, best_idx

    init = (
        jnp.int32(0),
        jnp.zeros(n, dtype=jnp.int32),
        jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)),
        jnp.full(n, -1, dtype=jnp.int32),
    )
    _s, _c, best_t, best_idx = jax.lax.while_loop(cond, body, init)
    return best_t, best_idx


def traverse_any(bvh: FlatBVH, tris, ro: V3, rd: V3, t_min: float, t_max):
    """Existence-only occlusion walk: rays park (cursor → m) on first
    accepted hit, so occluded rays stop paying for the rest of the tree."""
    n = ro.x.shape[0]
    m = bvh.n_nodes
    limit = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    inv = V3(
        1.0 / jnp.where(jnp.abs(rd.x) > 1e-12, rd.x, 1e-12),
        1.0 / jnp.where(jnp.abs(rd.y) > 1e-12, rd.y, 1e-12),
        1.0 / jnp.where(jnp.abs(rd.z) > 1e-12, rd.z, 1e-12),
    )

    def cond(state):
        step, cursor, _found = state
        return (step < m + 1) & jnp.any(cursor < m)

    def body(state):
        step, cursor, found = state
        node = jnp.minimum(cursor, m - 1)
        lo = bvh.lo[node]
        hi = bvh.hi[node]
        t0 = (lo[:, 0] - ro.x) * inv.x
        t1 = (hi[:, 0] - ro.x) * inv.x
        tx0, tx1 = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        t0 = (lo[:, 1] - ro.y) * inv.y
        t1 = (hi[:, 1] - ro.y) * inv.y
        ty0, ty1 = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        t0 = (lo[:, 2] - ro.z) * inv.z
        t1 = (hi[:, 2] - ro.z) * inv.z
        tz0, tz1 = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        enter = jnp.maximum(jnp.maximum(tx0, ty0), jnp.maximum(tz0, t_min))
        exit_ = jnp.minimum(jnp.minimum(tx1, ty1), jnp.minimum(tz1, limit))
        box_hit = enter <= exit_

        active = (cursor < m) & ~found
        leaf = bvh.is_leaf[node] & box_hit & active

        for k in range(bvh.slots.shape[1]):
            tri = bvh.slots[node, k]
            valid_slot = leaf & (tri >= 0)
            ti = jnp.maximum(tri, 0)
            v0 = tris.v0.take(ti)
            e1 = tris.v1.take(ti) - v0
            e2 = tris.v2.take(ti) - v0
            h = rd.cross(e2)
            det = e1.dot(h)
            ok = jnp.abs(det) > 1e-6
            inv_det = 1.0 / jnp.where(ok, det, 1.0)
            s = ro - v0
            u = inv_det * s.dot(h)
            q = s.cross(e1)
            v = inv_det * rd.dot(q)
            t = inv_det * e2.dot(q)
            found = found | (
                valid_slot & ok
                & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > t_min) & (t < limit)
            )

        descend = box_hit & ~bvh.is_leaf[node] & active
        nxt = jnp.where(descend, cursor + 1, bvh.skip[node])
        cursor = jnp.where(found, m, jnp.where(active, nxt, cursor))
        return step + 1, cursor, found

    init = (jnp.int32(0), jnp.zeros(n, dtype=jnp.int32), jnp.zeros(n, bool))
    _s, _c, found = jax.lax.while_loop(cond, body, init)
    return found
