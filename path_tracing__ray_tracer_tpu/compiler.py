"""Scene compiler: host object graph → static-shaped device SoA pytree.

The device-side form of the reference's per-renderer flatteners
(``cuda_texture_renderer.py:790-973``): the object-oriented ``Scene`` is
lowered once into structure-of-arrays ``jnp`` buffers that every wavefront
pass consumes.  Differences from the reference wire format, by design:

* SoA (x/y/z as separate arrays) instead of interleaved float records —
  vector lanes want dense same-component arrays (see ``ops/v3.py``).
* One unified per-primitive material table in plane→sphere→triangle order,
  so a single gather by "global primitive index" fetches the winner's
  material after intersection.
* Primitive counts are padded up to a lane-friendly multiple with
  *unhittable* sentinel primitives (zero normal / zero radius at 1e9 /
  degenerate triangle), so no validity masks are needed in the hot loop.
* The texture atlas is one packed-int32 plane (0x00BBGGRR per texel — one
  hardware-native gather per sample) plus an ``[offset, width, height]`` info
  table, path-sorted for stable IDs exactly like the reference
  (``cuda_texture_renderer.py:798-813``).

GPU-parity mode reproduces the reference wire-format quirks needed for
pixel-RMSE matching: planes and triangles never carry refraction
(``cuda_texture_renderer.py:519-520,701-702``) and planes are untextured on
the device path.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from .core.camera import Camera
from .core.geometry import Plane, Sphere, Triangle
from .core.scene import Scene
from .ops.v3 import V3


class MatSoA(NamedTuple):
    """Per-primitive material table, indexed by global primitive id."""

    color: V3  # (M,)
    diffuse: jnp.ndarray
    specular: jnp.ndarray
    reflective: jnp.ndarray
    refractive: jnp.ndarray
    ior: jnp.ndarray
    has_tex: jnp.ndarray  # float 0/1
    tex_id: jnp.ndarray  # int32, -1 when untextured


class PlanesSoA(NamedTuple):
    anchor: V3  # (P,)
    normal: V3
    u_unit: V3
    v_unit: V3
    u_len: jnp.ndarray
    v_len: jnp.ndarray


class SpheresSoA(NamedTuple):
    center: V3  # (S,)
    radius: jnp.ndarray


class TrianglesSoA(NamedTuple):
    v0: V3  # (T,)
    v1: V3
    v2: V3
    normal: V3
    uv0: Tuple[jnp.ndarray, jnp.ndarray]
    uv1: Tuple[jnp.ndarray, jnp.ndarray]
    uv2: Tuple[jnp.ndarray, jnp.ndarray]


class QuadsSoA(NamedTuple):
    """Parallelogram quads merged from adjacent triangle pairs.

    An optimization with no reference counterpart: the Cornell
    scene's 26 triangles are 13 parallelograms (12 cube faces + canvas), and
    one quad test costs less than half of two Möller–Trumbore tests in the
    brute-force sweep.  ``du``/``dv`` are the precomputed dual vectors of the
    edge basis, so the in-plane coordinates are two dot products:
    ``a = (p − origin)·du``, ``b = (p − origin)·dv`` with hit iff
    ``0 ≤ a,b ≤ 1``.  Double-sided with normal flipped toward the ray — the
    same convention as the triangles they replace.
    """

    origin: V3  # (Q,)
    eu: V3  # edge to the "a" corner
    ev: V3  # edge to the "b" corner
    normal: V3  # unit, same orientation as the source triangles
    du: V3  # dual of eu
    dv: V3  # dual of ev
    uv0: Tuple[jnp.ndarray, jnp.ndarray]  # UV at origin
    uva: Tuple[jnp.ndarray, jnp.ndarray]  # d(UV)/da
    uvb: Tuple[jnp.ndarray, jnp.ndarray]  # d(UV)/db


class CompiledScene(NamedTuple):
    planes: PlanesSoA
    spheres: SpheresSoA
    quads: "QuadsSoA"
    triangles: TrianglesSoA
    materials: MatSoA  # size P + S + Q + T (global primitive order)
    lights: V3  # (L,) — point samples of area lights
    light_color: V3  # scalars
    ambient: V3  # scalars
    atlas: jnp.ndarray  # (Npix,) int32, 0x00BBGGRR packed texels
    tex_offset: jnp.ndarray  # (T,) int32, in pixels
    tex_width: jnp.ndarray
    tex_height: jnp.ndarray
    bvh: object = None  # Optional[ops.bvh.FlatBVH] over triangles (big scenes)
    # optional low-resolution mip of the atlas (``mip_budget`` compile arg):
    # sampled by secondary bounces in the path tracer's deferred-texture mode
    # (models/experimental.py).  None = not built.
    mip_atlas: jnp.ndarray = None  # (Mpix,) int32 packed texels
    mip_offset: jnp.ndarray = None  # (T,) int32
    mip_width: jnp.ndarray = None
    mip_height: jnp.ndarray = None
    # static shape-encoded flag (a jit arg keeps shapes, loses Python
    # values): (1,) int8 when any TRIANGLE material is textured, (0,)
    # otherwise — scene_hit skips the 6 per-lane triangle-uv interpolation
    # gathers when nothing reads them (mesh scenes).  None (hand-built
    # scenes) = assume textured.
    tri_uv_used: jnp.ndarray = None
    # same encoding for "ANY primitive is textured": (0,) lets
    # resolve_base_color return the material color without the per-lane
    # atlas gather into the 1-texel dummy atlas.  None (hand-built scenes) =
    # assume textured.
    any_textured: jnp.ndarray = None
    # Unique-material compression: scenes carry few *distinct* materials
    # (Cornell: 16; the 11.5K-tri mesh scene: a handful), so the per-lane
    # material fetch needs ONE int32 gather (prim → unique id) instead of
    # ten — the other nine fields resolve from ``mat_table`` by select
    # chain (ops/select_table.py).  Unmeasured on the H100.  None when the
    # scene has more than
    # ``select_table.SELECT_LIMIT`` distinct materials (falls back to the
    # per-prim gather form).
    mat_uid: jnp.ndarray = None  # (M,) int32 unique-material index
    mat_table: MatSoA = None  # (U,) unique rows, U <= SELECT_LIMIT

    @property
    def n_planes(self) -> int:
        return int(self.planes.u_len.shape[0])

    @property
    def n_spheres(self) -> int:
        return int(self.spheres.radius.shape[0])

    @property
    def n_quads(self) -> int:
        return int(self.quads.uv0[0].shape[0])

    @property
    def n_triangles(self) -> int:
        return int(self.triangles.uv0[0].shape[0])

    @property
    def n_lights(self) -> int:
        return int(self.lights.x.shape[0])

    @property
    def n_textures(self) -> int:
        return int(self.tex_offset.shape[0])


# triangle count above which compile_scene builds the flat BVH
BVH_THRESHOLD = 256


def _pad_to(n: int, multiple: int = 1) -> int:
    """Pad a primitive count (minimum 1 so gathers stay well-defined).

    Counts are per-type loop bounds, not lane dimensions — the lanes are the
    rays — so no hardware alignment is needed and padding is pure waste;
    ``multiple`` exists for jit-cache reuse across similar scenes.
    """
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def _v3_table(vecs: List, pad: int, fill=(0.0, 0.0, 0.0)) -> V3:
    arr = np.full((pad, 3), fill, dtype=np.float32)
    for i, v in enumerate(vecs):
        arr[i] = (v.x, v.y, v.z)
    return V3(jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1]), jnp.asarray(arr[:, 2]))


def _f32_table(vals: List[float], pad: int, fill=0.0) -> jnp.ndarray:
    arr = np.full((pad,), fill, dtype=np.float32)
    arr[: len(vals)] = vals
    return jnp.asarray(arr)


def _merge_quads(tris: List[Triangle]):
    """Merge adjacent triangle pairs into parallelogram quads.

    A pair (i, i+1) merges when it forms the two halves of a parallelogram
    with a consistent bilinear UV map — the pattern every quad-emitting
    builder produces: ``(q0, q1, q2)`` + ``(q0, q2, q3)`` with
    ``q2 == q1 + q3 − q0``.  Returns ``(quad_records, leftover_triangles)``;
    each record is ``(origin, eu, ev, normal, uv0, uva, uvb, material)``.
    """
    import numpy as np

    def uv_of(t, which):
        # reference wire-format defaults for missing vertex UVs
        # (cuda_texture_renderer.py:869-874)
        defaults = {0: (0.0, 0.0), 1: (1.0, 0.0), 2: (1.0, 1.0)}
        uv = (t.uv0, t.uv1, t.uv2)[which]
        return (
            (float(uv[0]), float(uv[1])) if uv is not None else defaults[which]
        )

    # Pair by shared diagonal edge via a hash (the scene's BVH build sorts
    # the object list in place — reference behavior — so pairs are not
    # adjacent).  A t1=(q0,q1,q2) matches a t2=(q0,q2,q3): key both by the
    # quantized (v0, shared-vertex) edge + material identity.
    def quant(v):
        return (round(v.x, 5), round(v.y, 5), round(v.z, 5))

    by_edge = {}
    for j, t in enumerate(tris):
        by_edge.setdefault((quant(t.v0), quant(t.v1), id(t.material)), []).append(j)

    used = [False] * len(tris)
    quads, leftovers = [], []
    for i, t1 in enumerate(tris):
        if used[i]:
            continue
        merged = False
        for j in by_edge.get((quant(t1.v0), quant(t1.v2), id(t1.material)), []):
            if j == i or used[j]:
                continue
            t2 = tris[j]
            q0, q1, q2, q3 = t1.v0, t1.v1, t1.v2, t2.v2
            scale = max((q1 - q0).length(), (q3 - q0).length(), 1e-6)
            if (q2 - (q1 + q3 - q0)).length() >= 1e-5 * scale:
                continue
            uv0 = np.array(uv_of(t1, 0))
            uv1 = np.array(uv_of(t1, 1))
            uv2 = np.array(uv_of(t1, 2))
            uv3 = np.array(uv_of(t2, 2))
            uv_ok = (
                np.abs(uv2 - (uv1 + uv3 - uv0)).max() < 1e-5
                and np.abs(np.array(uv_of(t2, 0)) - uv0).max() < 1e-5
                and np.abs(np.array(uv_of(t2, 1)) - uv2).max() < 1e-5
            )
            if not uv_ok:
                continue
            eu, ev = q1 - q0, q3 - q0
            n = eu.cross(ev)
            if n.dot(n) <= 1e-12:
                continue
            du = ev.cross(n) / ev.cross(n).dot(eu)
            dv = n.cross(eu) / n.cross(eu).dot(ev)
            quads.append(
                (q0, eu, ev, n.normalize(), du, dv,
                 tuple(uv0), tuple(uv1 - uv0), tuple(uv3 - uv0), t1.material)
            )
            used[i] = used[j] = True
            merged = True
            break
        if not merged:
            leftovers.append(t1)
    return quads, leftovers


def collect_texture_paths(scene: Scene) -> List[str]:
    """All distinct texture paths, sorted — the reference's stable-ID rule
    (``cuda_texture_renderer.py:798-813``)."""
    paths: List[str] = []
    for obj in scene.objects:
        mat = getattr(obj, "material", None)
        if mat is not None and mat.texture is not None:
            path = getattr(mat.texture, "path", None)
            if path and path not in paths:
                paths.append(path)
    return sorted(paths)


def compile_scene(
    scene: Scene,
    convention: str = "gpu",
    gpu_parity: bool = True,
    with_textures: bool = True,
    texture_budget: int = 0,
    mip_budget: int = 0,
    merge_quads: bool = True,
    use_bvh: bool = None,
) -> CompiledScene:
    """Lower a host ``Scene`` to the device SoA form.

    ``convention`` selects the plane V-axis rule: ``"gpu"`` normalizes the
    given ``v_dir`` (``cuda_renderer.py:336-341``); ``"cpu"`` derives
    ``v = normal × u`` (``core/geometry.py:36``).  ``gpu_parity`` reproduces
    the wire-format quirks of the reference GPU flatteners (see module doc).

    ``texture_budget`` caps each texture's max dimension (box-filter
    downsample at atlas build).  0 keeps the reference-exact full resolution.
    A smaller atlas is a smaller random-gather working set, while renders at
    typical resolutions minify these textures anyway.  Unmeasured on the
    H100.
    """
    planes = [o for o in scene.objects if isinstance(o, Plane)]
    spheres = [o for o in scene.objects if isinstance(o, Sphere)]
    tris = [o for o in scene.objects if isinstance(o, Triangle)]
    quad_recs = []
    if merge_quads:
        quad_recs, tris = _merge_quads(tris)

    texture_paths = collect_texture_paths(scene) if with_textures else []
    tex_ids = {p: i for i, p in enumerate(texture_paths)}

    p_pad, s_pad, t_pad = _pad_to(len(planes)), _pad_to(len(spheres)), _pad_to(len(tris))
    q_pad = _pad_to(len(quad_recs))

    # ---- geometry tables ---------------------------------------------------
    plane_v_units = []
    for pl in planes:
        if convention == "gpu":
            plane_v_units.append(pl.v_dir.normalize())
        else:
            plane_v_units.append(pl.normal.cross(pl.u_dir.normalize()).normalize())

    planes_soa = PlanesSoA(
        anchor=_v3_table([p.anchor for p in planes], p_pad),
        normal=_v3_table([p.normal for p in planes], p_pad),  # zero normal = unhittable pad
        u_unit=_v3_table([p.u_unit for p in planes], p_pad),
        v_unit=_v3_table(plane_v_units, p_pad),
        u_len=_f32_table([p.u_len for p in planes], p_pad, fill=1.0),
        v_len=_f32_table([p.v_len for p in planes], p_pad, fill=1.0),
    )
    spheres_soa = SpheresSoA(
        # zero radius at 1e9 → discriminant never strictly positive
        center=_v3_table([s.center for s in spheres], s_pad, fill=(0.0, 0.0, 1e9)),
        radius=_f32_table([s.radius for s in spheres], s_pad, fill=0.0),
    )

    def _uv_pair(uvs, default):
        u = _f32_table([float(t[0]) if t is not None else default[0] for t in uvs], t_pad)
        v = _f32_table([float(t[1]) if t is not None else default[1] for t in uvs], t_pad)
        return (u, v)

    tris_soa = TrianglesSoA(
        v0=_v3_table([t.v0 for t in tris], t_pad),  # degenerate (all-zero) pad tri
        v1=_v3_table([t.v1 for t in tris], t_pad),
        v2=_v3_table([t.v2 for t in tris], t_pad),
        normal=_v3_table([t.normal for t in tris], t_pad),
        # Reference default UVs for missing vertex UVs: (0,0),(1,0),(1,1)
        # (cuda_texture_renderer.py:869-874).
        uv0=_uv_pair([t.uv0 for t in tris], (0.0, 0.0)),
        uv1=_uv_pair([t.uv1 for t in tris], (1.0, 0.0)),
        uv2=_uv_pair([t.uv2 for t in tris], (1.0, 1.0)),
    )

    def _uv_scalar_pair(vals, pad):
        u = _f32_table([v[0] for v in vals], pad)
        v = _f32_table([v[1] for v in vals], pad)
        return (u, v)

    quads_soa = QuadsSoA(
        origin=_v3_table([q[0] for q in quad_recs], q_pad),
        # zero edges + zero duals: a/b stay 0... make pads unhittable via
        # zero normal (plane-style parallel rejection needs |rd.n|>eps)
        eu=_v3_table([q[1] for q in quad_recs], q_pad),
        ev=_v3_table([q[2] for q in quad_recs], q_pad),
        normal=_v3_table([q[3] for q in quad_recs], q_pad),  # zero normal pad
        du=_v3_table([q[4] for q in quad_recs], q_pad),
        dv=_v3_table([q[5] for q in quad_recs], q_pad),
        uv0=_uv_scalar_pair([q[6] for q in quad_recs] or [(0.0, 0.0)], q_pad),
        uva=_uv_scalar_pair([q[7] for q in quad_recs] or [(0.0, 0.0)], q_pad),
        uvb=_uv_scalar_pair([q[8] for q in quad_recs] or [(0.0, 0.0)], q_pad),
    )

    # ---- unified material table (plane → sphere → quad → triangle order) ----
    m_total = p_pad + s_pad + q_pad + t_pad
    color = np.zeros((m_total, 3), dtype=np.float32)
    diffuse = np.zeros(m_total, dtype=np.float32)
    specular = np.zeros(m_total, dtype=np.float32)
    reflective = np.zeros(m_total, dtype=np.float32)
    refractive = np.zeros(m_total, dtype=np.float32)
    ior = np.ones(m_total, dtype=np.float32)
    has_tex = np.zeros(m_total, dtype=np.float32)
    tex_id = np.full(m_total, -1, dtype=np.int32)

    def _fill(row: int, mat, allow_refraction: bool, allow_texture: bool):
        color[row] = (mat.color.x, mat.color.y, mat.color.z)
        diffuse[row] = mat.diffuse
        specular[row] = mat.specular
        reflective[row] = mat.reflective
        refractive[row] = mat.refractive if allow_refraction else 0.0
        ior[row] = mat.ior if allow_refraction else 1.0
        if allow_texture and mat.texture is not None:
            path = getattr(mat.texture, "path", None)
            if path in tex_ids:
                has_tex[row] = 1.0
                tex_id[row] = tex_ids[path]

    for i, p in enumerate(planes):
        _fill(i, p.material, allow_refraction=not gpu_parity, allow_texture=not gpu_parity)
    for i, s in enumerate(spheres):
        _fill(p_pad + i, s.material, allow_refraction=True, allow_texture=not gpu_parity)
    for i, q in enumerate(quad_recs):
        _fill(p_pad + s_pad + i, q[9], allow_refraction=not gpu_parity, allow_texture=True)
    for i, t in enumerate(tris):
        _fill(p_pad + s_pad + q_pad + i, t.material, allow_refraction=not gpu_parity,
              allow_texture=True)

    materials = MatSoA(
        color=V3(jnp.asarray(color[:, 0]), jnp.asarray(color[:, 1]), jnp.asarray(color[:, 2])),
        diffuse=jnp.asarray(diffuse),
        specular=jnp.asarray(specular),
        reflective=jnp.asarray(reflective),
        refractive=jnp.asarray(refractive),
        ior=jnp.asarray(ior),
        has_tex=jnp.asarray(has_tex),
        tex_id=jnp.asarray(tex_id),
    )

    # ---- unique-material compression (see CompiledScene.mat_uid) -------------
    from .ops.select_table import SELECT_LIMIT

    mat_rows = np.stack(
        [color[:, 0], color[:, 1], color[:, 2], diffuse, specular,
         reflective, refractive, ior, has_tex, tex_id.astype(np.float64)],
        axis=1,
    )
    uniq, uid = np.unique(mat_rows, axis=0, return_inverse=True)
    uid = uid.reshape(-1)  # numpy 2.x returns (M, 1) for axis-unique inverse
    mat_uid = mat_table = None
    if uniq.shape[0] <= SELECT_LIMIT:
        uq = uniq.astype(np.float32)
        mat_uid = jnp.asarray(uid.astype(np.int32))
        mat_table = MatSoA(
            color=V3(jnp.asarray(uq[:, 0]), jnp.asarray(uq[:, 1]), jnp.asarray(uq[:, 2])),
            diffuse=jnp.asarray(uq[:, 3]),
            specular=jnp.asarray(uq[:, 4]),
            reflective=jnp.asarray(uq[:, 5]),
            refractive=jnp.asarray(uq[:, 6]),
            ior=jnp.asarray(uq[:, 7]),
            has_tex=jnp.asarray(uq[:, 8]),
            tex_id=jnp.asarray(uniq[:, 9].astype(np.int32)),
        )

    # ---- lights & globals ----------------------------------------------------
    n_lights = max(1, len(scene.lights))
    lights = _v3_table(scene.lights, max(1, len(scene.lights)))
    if not scene.lights:
        lights = V3(lights.x[:0], lights.y[:0], lights.z[:0])  # truly empty
        n_lights = 0

    # ---- texture atlas ---------------------------------------------------------
    atlas, offs, ws, hs = _build_atlas(texture_paths, texture_budget)
    # optional mip: a second, much smaller atlas for secondary-bounce lookups
    # (deferred-texture mode).  ``mip_budget`` caps each texture's max
    # dimension the same way ``texture_budget`` does.
    mip = (None,) * 4
    if mip_budget:
        mip = _build_atlas(texture_paths, mip_budget)

    # ---- acceleration structure -------------------------------------------------
    # Brute-force sweeps beat tree walks below a few hundred primitives
    # (every candidate is one fused elementwise pass); beyond that, build the
    # flat BVH.  ``use_bvh=False`` forces the sequential fori sweep even for
    # big scenes.
    flat_bvh = None
    if use_bvh is None:
        use_bvh = len(tris) > BVH_THRESHOLD
    if use_bvh and len(tris) > 0:
        from .ops import bvh as bvh_mod

        v0 = np.stack([np.asarray(t.v0.to_np()) for t in tris])
        v1 = np.stack([np.asarray(t.v1.to_np()) for t in tris])
        v2 = np.stack([np.asarray(t.v2.to_np()) for t in tris])
        tri_min = np.minimum(np.minimum(v0, v1), v2)
        tri_max = np.maximum(np.maximum(v0, v1), v2)
        flat_bvh = bvh_mod.to_device(bvh_mod.build_bvh(tri_min, tri_max))

    tri_textured = any(
        t.material is not None and t.material.texture is not None for t in tris
    )

    return CompiledScene(
        tri_uv_used=jnp.zeros((1 if tri_textured else 0,), jnp.int8),
        any_textured=jnp.zeros((1 if bool(np.any(has_tex > 0.0)) else 0,), jnp.int8),
        mat_uid=mat_uid,
        mat_table=mat_table,
        bvh=flat_bvh,
        planes=planes_soa,
        spheres=spheres_soa,
        quads=quads_soa,
        triangles=tris_soa,
        materials=materials,
        lights=lights,
        light_color=V3.of(scene.light_color.x, scene.light_color.y, scene.light_color.z),
        ambient=V3.of(scene.ambient.x, scene.ambient.y, scene.ambient.z),
        atlas=atlas,
        tex_offset=offs,
        tex_width=ws,
        tex_height=hs,
        mip_atlas=mip[0],
        mip_offset=mip[1],
        mip_width=mip[2],
        mip_height=mip[3],
    )


def _build_atlas(texture_paths: List[str], texture_budget: int = 0):
    """Concatenate all textures row-major into one packed-int32 atlas
    (the device-side form of ``cuda_texture_renderer.py:910-955``).

    One int32 per texel (0x00BBGGRR): a single vector gather per sample
    instead of three uint8 gathers.  Textures are decoded with Pillow.
    """
    from PIL import Image

    chunks = []
    offs, ws, hs = [], [], []
    offset = 0
    for path in texture_paths:
        try:
            with Image.open(path) as img:
                rgb = img.convert("RGB")
                if texture_budget and max(rgb.size) > texture_budget:
                    scale = texture_budget / max(rgb.size)
                    rgb = rgb.resize(
                        (max(1, int(rgb.size[0] * scale)),
                         max(1, int(rgb.size[1] * scale))),
                        Image.BOX,
                    )
                pixels = np.asarray(rgb, dtype=np.uint8)
            h, w = pixels.shape[:2]
            chunks.append(pixels.reshape(-1, 3))
            offs.append(offset)
            ws.append(w)
            hs.append(h)
            offset += w * h
        except Exception:
            # Reference fallback: a 1×1 white texel (cuda_texture_renderer.py:948-953).
            chunks.append(np.full((1, 3), 255, dtype=np.uint8))
            offs.append(offset)
            ws.append(1)
            hs.append(1)
            offset += 1

    if chunks:
        flat = np.concatenate(chunks, axis=0)
    else:
        flat = np.full((1, 3), 255, dtype=np.uint8)
        offs, ws, hs = [0], [1], [1]

    flat32 = flat.astype(np.int32)
    packed = flat32[:, 0] | (flat32[:, 1] << 8) | (flat32[:, 2] << 16)
    return (
        jnp.asarray(packed),
        jnp.asarray(np.asarray(offs, dtype=np.int32)),
        jnp.asarray(np.asarray(ws, dtype=np.int32)),
        jnp.asarray(np.asarray(hs, dtype=np.int32)),
    )


def pack_camera(camera: Camera) -> jnp.ndarray:
    """Camera 12-float wire format (``cuda_renderer.py:655-662``)."""
    return jnp.asarray(camera.packed())


def scene_summary(cs: CompiledScene) -> dict:
    """Structured counterpart of the reference's scene-flattening prints
    (``cuda_renderer.py:595-651``)."""
    return {
        "planes": cs.n_planes,
        "spheres": cs.n_spheres,
        "quads": cs.n_quads,
        "triangles": cs.n_triangles,
        "lights": cs.n_lights,
        "textures": cs.n_textures,
        "atlas_pixels": int(cs.atlas.shape[0]),
    }
