"""Backend probing, the GPU requirement of the measuring scripts, and the
compile-cache helper.  Nothing switches to the CPU behind the caller's
back: a backend that fails raises, and the scripts that report device
numbers exit without a result when the default device is not a GPU."""
import json
import os

import jax
import pytest

import path_tracing__ray_tracer_tpu as ptrt
from path_tracing__ray_tracer_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_probe_backend_reports_platform():
    assert backend.probe_backend() == jax.devices()[0].platform == "cpu"


def test_probe_backend_raises_instead_of_falling_back(monkeypatch):
    def broken(*_a, **_k):
        raise RuntimeError("backend init failed")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="failed to start"):
        backend.probe_backend()


def test_require_gpu_exits_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        backend.require_gpu("test")
    assert exc.value.code == 2
    assert "needs a GPU" in capsys.readouterr().err


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert backend.compile_cache_dir() == path  # no pid, time or temp name


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert backend.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_absent_device_backend_raises(cornell):
    """A renderer pinned to a backend this process lacks raises rather than
    quietly rendering on the default device."""
    scene, cam = cornell
    r = ptrt.RendererFactory.create("tpu_raytracer", device="gpu")
    with pytest.raises(RuntimeError, match="needs the 'gpu' backend"):
        r.render(scene, cam, ptrt.RenderSettings(16, 12, 1, 1))


def test_cpu_raytracer_is_pinned_to_host():
    r = ptrt.RendererFactory.create("cpu_raytracer")
    assert r.device == "cpu"


@pytest.mark.parametrize("script", ["chip_smoke", "bench", "benchmarks"])
def test_measuring_scripts_exit_without_gpu(script, capsys):
    """No GPU: exit status 2 and no result line on stdout."""
    mod = __import__(script)
    with pytest.raises(SystemExit) as exc:
        raise SystemExit(mod.main([]) if script != "bench" else mod.main())
    assert exc.value.code == 2
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_chip_smoke_result_line():
    import chip_smoke

    line = chip_smoke.result_line([_Dev()])
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert json.loads(chip_smoke.result_line([_Dev()] * 4))["device"]["count"] == 4


@pytest.mark.parametrize("four_cards", [False, True])
def test_chip_smoke_phase_selection(four_cards):
    import chip_smoke

    phases = chip_smoke.select_phases(four_cards)
    if four_cards:
        assert phases == ("four_cards",)
    else:
        assert phases == ("path", "bounce_kernel", "whitted", "card_vs_cpu",
                          "mesh")
