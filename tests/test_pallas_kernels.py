"""RANSAC hypothesis scoring (ops/ransac.score_lines) against a NumPy
brute force."""
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.ops.ransac import score_lines


def _brute_force(pts, valid, lines, thresh):
    """Every point against every line, one at a time, in the points'
    precision."""
    one = pts.dtype.type(1.0)
    counts = []
    for m, b in lines:
        n = 0
        for (x, y), ok in zip(pts, valid):
            d = abs(m * x - y + b) / np.sqrt(m * m + one)
            n += bool(ok and d < thresh)
        counts.append(n)
    return np.asarray(counts)


def test_score_lines_matches_ref(rng):
    B, NH = 700, 37
    pts = rng.uniform(-5, 5, (B, 2)).astype(np.float32)
    valid = rng.random(B) > 0.2
    lines = np.stack([rng.uniform(-3, 3, NH), rng.uniform(-4, 4, NH)],
                     -1).astype(np.float32)
    out = score_lines(jnp.asarray(pts), jnp.asarray(valid),
                      jnp.asarray(lines), 0.25)
    assert out.dtype == jnp.int32 and out.shape == (NH,)
    np.testing.assert_array_equal(
        np.asarray(out), _brute_force(pts, valid, lines, np.float32(0.25)))


def test_score_lines_counts_known_geometry():
    # 100 points on y=0, 50 on y=2; line y=0 catches exactly the first set
    pts = np.zeros((150, 2), np.float32)
    pts[:100, 0] = np.linspace(-5, 5, 100)
    pts[100:, 0] = np.linspace(-5, 5, 50)
    pts[100:, 1] = 2.0
    lines = np.asarray([[0.0, 0.0], [0.0, 2.0]], np.float32)
    valid = np.ones((150,), bool)
    valid[:10] = False
    out = score_lines(jnp.asarray(pts), jnp.asarray(valid),
                      jnp.asarray(lines), 0.25)
    np.testing.assert_array_equal(np.asarray(out), [90, 50])
    np.testing.assert_array_equal(
        np.asarray(out), _brute_force(pts, valid, lines, 0.25))
