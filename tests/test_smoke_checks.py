"""The comparison helpers of ``chip_smoke.py`` on synthetic arrays: they
must pass what the tolerances allow and catch what they are there to catch."""
import numpy as np
import pytest

import chip_smoke
from path_tracing__ray_tracer_tpu.ops.bounce import BounceOut
from path_tracing__ray_tracer_tpu.ops.v3 import V3

N = 20000


def _record(seed=0):
    rng = np.random.default_rng(seed)

    def f():
        return rng.uniform(-2, 2, N).astype(np.float32)

    return BounceOut(
        hit=rng.uniform(size=N) < 0.8, killed=rng.uniform(size=N) < 0.1,
        w_sky=f(), w_nee=f(), rr_scale=f(), s_thr=f(), t_thr=f(),
        new_org=V3(f(), f(), f()), new_dir=V3(f(), f(), f()), u=f(), v=f(),
        tex_id=f(), mat_color=V3(f(), f(), f()),
    )


def _flip(rec, lanes):
    hit = rec.hit.copy()
    hit[lanes] = ~hit[lanes]
    return rec._replace(hit=hit)


@pytest.mark.parametrize("case,ok", [
    ("identical", True),
    ("last_bit", True),        # float noise far inside rtol 1e-5
    ("two_flips", True),       # 2 of 20000 lanes: 0.9999 agree
    ("three_flips", False),    # 3 of 20000: below 0.9999
    ("field_off", False),      # one agreeing lane outside tolerance
    ("geometry_off", False),   # a scattered direction outside tolerance
])
def test_compare_bounce(case, ok):
    want = _record()
    got = want
    if case == "last_bit":
        got = want._replace(w_nee=np.nextafter(want.w_nee, np.float32(np.inf)))
    elif case == "two_flips":
        got = _flip(want, [3, 7])
    elif case == "three_flips":
        got = _flip(want, [3, 7, 11])
    elif case == "field_off":
        d = want.w_nee.copy()
        d[5] += 1e-3
        got = want._replace(w_nee=d)
    elif case == "geometry_off":
        d = want.new_dir.y.copy()
        d[5] += 1e-3
        got = want._replace(new_dir=V3(want.new_dir.x, d, want.new_dir.z))
    stats = chip_smoke.compare_bounce(got, want)
    assert chip_smoke.bounce_ok(stats) is ok, stats


def test_compare_bounce_ignores_fields_of_disagreeing_lanes():
    want = _record()
    got = _flip(want, [9])
    d = want.w_nee.copy()
    d[9] += 5.0  # the flipped lane took another branch: any value
    got = got._replace(w_nee=d)
    stats = chip_smoke.compare_bounce(got, want)
    assert stats["fields"]["w_nee"]["outside_tol"] == 0
    assert chip_smoke.bounce_ok(stats)


def test_rmse():
    a = np.zeros((4, 4, 3))
    assert chip_smoke.rmse(a, a) == 0.0
    assert chip_smoke.rmse(a, a + 2.0) == pytest.approx(2.0)
    b = a.copy()
    b[0, 0, 0] = 4.0
    assert chip_smoke.rmse(a, b) == pytest.approx(np.sqrt(16 / 48))


def test_sums_match():
    rng = np.random.default_rng(1)
    want = rng.uniform(0, 50, (10000, 3))
    got = want * (1 + 1e-7)  # one reordered addition per pixel
    assert chip_smoke.sums_match(got, want)["pixel_share"] == 1.0
    got[:3, 1] += 1.0  # three pixels took a different branch
    m = chip_smoke.sums_match(got, want)
    assert m["pixels_outside"] == 3 and m["pixel_share"] == pytest.approx(0.9997)


def test_u8_outside_share():
    a = np.full((100, 100, 3), 128, np.uint8)
    b = a.copy()
    b[0, 0, 0] = 129  # off by one: allowed
    assert chip_smoke.u8_outside_share(b, a) == 0.0
    b[0, 1, 0] = 131
    assert chip_smoke.u8_outside_share(b, a) == pytest.approx(1 / 30000)
