"""CLI flag-surface parity and plumb-through (parse-level, no renders).

The reference's flag names/defaults (its ``main.py:24-46``) are the
compatibility contract; the additive flags ride alongside.
"""
import main as cli


def test_reference_flag_defaults():
    args = cli.build_parser().parse_args([])
    assert args.renderer == "tpu_texture_raytracer"  # = cuda_texture default
    assert args.width == 2000 and args.height == 1500
    assert args.samples == 25 and args.depth == 16
    assert args.output == "output.png"
    assert args.path_samples == 1024
    assert args.scene == "custom"


def test_reference_short_flags():
    args = cli.build_parser().parse_args(
        ["-r", "cuda_path_raytracer", "-w", "64", "-s", "4", "-d", "2",
         "-o", "x.png"]
    )
    assert args.renderer == "cuda_path_raytracer"
    assert (args.width, args.samples, args.depth, args.output) == (
        64, 4, 2, "x.png")


def test_tpu_flags_parse():
    args = cli.build_parser().parse_args(
        ["--shadow-tmax", "light", "--texture-budget", "256",
         "--progressive", "64", "--checkpoint", "acc.npz", "--devices", "4",
         "--jitter", "center", "--scene", "mesh"]
    )
    assert args.shadow_tmax == "light"
    assert args.texture_budget == 256
    assert args.progressive == 64 and args.checkpoint == "acc.npz"
    assert args.devices == 4 and args.jitter == "center"
    assert args.scene == "mesh"
    # default reproduces the reference quirk
    assert cli.build_parser().parse_args([]).shadow_tmax == "reference"


def test_cli_end_to_end_path_tracer(tmp_path, capsys):
    """Drive main() for real: render, save, and the reference-surface prints
    (reference main.py:89-124 — save path, total time, throughput, quality)."""
    out = tmp_path / "pt.png"
    rc = cli.main(
        ["-r", "tpu_path_raytracer", "-w", "16", "--height", "12",
         "--path-samples", "2", "-d", "2", "-o", str(out), "--no-show"]
    )
    assert rc == 0
    assert out.exists()
    from PIL import Image

    img = Image.open(out)
    assert img.size == (16, 12)
    text = capsys.readouterr().out
    assert "Path tracer mode: 2 spp" in text
    assert f"Saved: {out}" in text
    assert "Total time:" in text
    assert "rays/sec" in text
    assert "Render quality: Global Illumination (highest)" in text


def test_cli_end_to_end_whitted_default(tmp_path, capsys):
    """Default renderer path (tpu_texture_raytracer) at tiny size; also the
    shadow-tmax drop warning for non-path renderers (ADVICE round 2)."""
    out = tmp_path / "wh.png"
    rc = cli.main(
        ["-w", "16", "--height", "12", "-s", "1", "-d", "2",
         "--shadow-tmax", "light", "-o", str(out), "--no-show"]
    )
    assert rc == 0
    assert out.exists()
    text = capsys.readouterr().out
    assert "Ray tracer mode: 1 spp" in text
    assert "Warning: --shadow-tmax light only applies to the path tracer" in text
    assert "Render quality: Whitted ray tracing + textures (high)" in text
