"""JAX ray tracer / path tracer.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``enginism/Path-Tracing__ray-tracer`` (a CUDA Cornell-box renderer): the same
scene/camera/material/geometry API and the same four renderer modes behind a
factory, re-architected as wavefront SoA passes over device meshes.  The
package and ``tpu_*`` renderer names are kept as public API.

Quick start::

    import path_tracing__ray_tracer_tpu as ptrt
    scene = ptrt.CustomSceneBuilder().build_scene()
    cam = ptrt.CustomSceneBuilder().create_camera(4 / 3)
    renderer = ptrt.RendererFactory.create("tpu_path_raytracer")
    img = renderer.render(scene, cam, ptrt.RenderSettings(512, 384, 64, 8))
"""

from .core import (  # noqa: F401
    AABB,
    Camera,
    CameraParams,
    HitRecord,
    Hittable,
    Material,
    Plane,
    Ray,
    RenderSettings,
    Scene,
    Sphere,
    Texture,
    Triangle,
    Vec3,
    create_area_light,
)
from .compiler import CompiledScene, compile_scene, pack_camera  # noqa: F401
from .models.base import BaseRenderer, RendererFactory  # noqa: F401

# importing renderer modules registers them with the factory (same
# self-registration pattern as the reference, base_renderer.py:36-39)
from .models import whitted as _whitted  # noqa: F401,E402
from .models import path_tracer as _path_tracer  # noqa: F401,E402
from .models import whitted_oracle as _whitted_oracle  # noqa: F401,E402

from .scene_builders.custom_scene_builder import CustomSceneBuilder  # noqa: F401,E402

__version__ = "0.1.0"
