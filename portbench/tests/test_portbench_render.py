"""The PyTorch renderer: repeatable from the seed, and the numpy recipe
of ``chip_smoke.py`` pixel for pixel."""

import numpy as np

from gen import ring_orbit

K_SMALL = np.array([[180.0, 0, 155], [0, 180.0, 47], [0, 0, 1]])


def _frames(seed, n=3):
    rng = ring_orbit.seed_rng(seed)
    corners, tex = ring_orbit.ring_world(rng, "cpu")
    R, C = ring_orbit.orbit(n, 60, 4.0, 0.25)
    return corners, tex, R, C, ring_orbit.render(corners, tex, R, C, K_SMALL,
                                                 310, 94, batch=2).numpy()


def test_same_seed_same_frames_other_seed_other_frames():
    a = _frames(2 ** 31 + 11)[-1]
    b = _frames(2 ** 31 + 11)[-1]
    c = _frames(7)[-1]
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.dtype == np.uint8 and a.shape == (3, 94, 310)


def test_agrees_with_the_numpy_recipe():
    import chip_smoke

    seed = 5
    corners, tex, R, C, mine = _frames(seed)
    planes = chip_smoke._ring_world(np.random.default_rng(seed))
    assert np.array_equal(np.stack([c for c, _ in planes]), corners)
    assert np.array_equal(np.stack([t for _, t in planes]), tex.numpy())
    for k in range(len(R)):
        ref = chip_smoke._render(planes, R[k], -R[k] @ C[k], K_SMALL, 310,
                                 94)
        assert np.array_equal(ref, mine[k])


def test_orbit_matches_the_recipe_at_6_degrees():
    from scipy.spatial.transform import Rotation

    R, C = ring_orbit.orbit(61, 60, 4.0, 0.25)
    phi = 2 * np.pi * np.arange(61) / 60
    want = Rotation.from_euler("y", -phi[:, None]).as_matrix()
    assert np.abs(R - want).max() < 1e-15
    assert abs(np.linalg.norm(C[60]) - 3.75) < 1e-12


def test_a_world_seed_fixes_the_scene_and_the_seed_draws_noise():
    cfg = {"camera": {"width": 310, "height": 94, "fx": 180.0, "fy": 180.0,
                      "cx": 155.0, "cy": 47.0}}
    traffic = {"frames_per_lap": 300, "radius_m": 4.0,
               "shrink_per_lap_m": 0.0, "world_seed": 13,
               "noise_sigma": 2.0}
    a, sa = ring_orbit.generate(traffic, cfg, 5, 2, "cpu")
    b, sb = ring_orbit.generate(traffic, cfg, 5, 2, "cpu")
    c, sc = ring_orbit.generate(traffic, cfg, 6, 2, "cpu")
    clean, _ = ring_orbit.generate(dict(traffic, noise_sigma=0.0), cfg, 5, 2,
                                   "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(sa.corners, sc.corners)
    assert not np.array_equal(a[0], c[0])
    d = a[0].astype(float) - clean[0]
    assert 1.5 < d.std() < 2.5 and abs(d.mean()) < 0.2
