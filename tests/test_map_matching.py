import jax.numpy as jnp
import numpy as np
import pytest

from racing_slam_tpu.ops.matching import match_map_to_frame
from tests.geometry_fixtures import default_camera, project_np, synthetic_scene


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _setup(rng, P=60, K=80, D=32, O=3):
    """Map points whose first K slots project onto the frame's keypoints; each
    point's observation descriptors are noisy copies of the keypoint's."""
    cam = default_camera()
    pose = np.eye(4, dtype=np.float32)
    X = synthetic_scene(rng, P)
    uv = project_np(cam, pose, X)

    kp_desc = _unit(rng.standard_normal((K, D)).astype(np.float32))
    # keypoints 0..P-1 sit at the projections (sub-pixel jitter), rest random
    kp_uv = np.concatenate(
        [uv + rng.uniform(-2, 2, (P, 2)).astype(np.float32),
         rng.uniform(0, 600, (K - P, 2)).astype(np.float32)]
    )
    obs_desc = np.zeros((P, O, D), np.float32)
    for o in range(O):
        obs_desc[:, o] = _unit(kp_desc[:P] + 0.1 * rng.standard_normal((P, D)).astype(np.float32))
    obs_valid = np.ones((P, O), bool)
    return cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid


def _match(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid,
           point_mask=None, kp_matched=None, pt_matched=None, max_distance=0.8):
    P, K = X.shape[0], kp_uv.shape[0]
    return match_map_to_frame(
        cam, jnp.asarray(pose), jnp.asarray(X),
        jnp.asarray(np.ones(P, bool) if point_mask is None else point_mask),
        jnp.asarray(obs_desc), jnp.asarray(obs_valid),
        jnp.asarray(kp_uv), jnp.asarray(kp_desc), jnp.ones(K, bool),
        jnp.asarray(np.zeros(K, bool) if kp_matched is None else kp_matched),
        jnp.asarray(np.zeros(P, bool) if pt_matched is None else pt_matched),
        max_distance=max_distance, chunk=32,
    )


def test_matches_correct_keypoints(rng):
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng)
    m = _match(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid)
    valid = np.asarray(m.valid)
    pts = np.asarray(m.point_idx)
    # Keypoint k < P should be matched to point k (its descriptor source).
    correct = sum(1 for k in range(60) if valid[k] and pts[k] == k)
    assert correct > 50, f"only {correct} correct matches"
    # Distractor keypoints (no corresponding point nearby) unmatched.
    assert valid[60:].sum() <= 2


def test_radius_gate(rng):
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng)
    # Move keypoints far from all projections: nothing can match.
    kp_uv_far = kp_uv + 50.0
    m = _match(cam, pose, X, kp_uv_far, kp_desc, obs_desc, obs_valid)
    assert np.asarray(m.valid).sum() == 0


def test_point_filter_mask(rng):
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng)
    mask = np.zeros(60, bool)
    mask[:20] = True  # only first 20 points eligible (observed-by-last-KF analogue)
    m = _match(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid, point_mask=mask)
    pts = np.asarray(m.point_idx)[np.asarray(m.valid)]
    assert (pts < 20).all()


def test_dedup_already_matched(rng):
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng)
    kp_matched = np.zeros(80, bool)
    kp_matched[:10] = True
    pt_matched = np.zeros(60, bool)
    pt_matched[20:30] = True
    m = _match(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid,
               kp_matched=kp_matched, pt_matched=pt_matched)
    valid = np.asarray(m.valid)
    pts = np.asarray(m.point_idx)
    assert not valid[:10].any()  # matched keypoints skipped
    assert not np.isin(pts[valid], np.arange(20, 30)).any()  # matched points skipped


def test_at_most_one_point_per_keypoint(rng):
    # Two identical points at the same position competing for one keypoint.
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng, P=10, K=12)
    X[1] = X[0]
    obs_desc[1] = obs_desc[0]
    m = _match(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid)
    valid = np.asarray(m.valid)
    pts = np.asarray(m.point_idx)[valid]
    assert len(np.unique(pts)) == len(pts)  # no point matched twice


def _stage1_inputs(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid,
                   gate=None, kp_ok=None):
    from racing_slam_tpu.ops.camera import project

    P, K = X.shape[0], kp_uv.shape[0]
    uv_p = project(cam, jnp.asarray(pose), jnp.asarray(X))
    return (
        uv_p,
        jnp.asarray(np.ones(P, bool) if gate is None else gate),
        jnp.asarray(obs_desc), jnp.asarray(obs_valid),
        jnp.asarray(kp_uv), jnp.asarray(kp_desc),
        jnp.asarray(np.ones(K, bool) if kp_ok is None else kp_ok),
    )


def _assert_stage1_equal(args, **kernel_kw):
    from racing_slam_tpu.ops.matching import guided_match_stage1_xla
    from racing_slam_tpu.ops.pallas.match_kernel import guided_match_stage1

    rk, rd = guided_match_stage1_xla(*args, radius_px=20.0, chunk=32)
    bk, bd = guided_match_stage1(*args, radius_px=20.0, **kernel_kw)
    rk, rd, bk, bd = map(np.asarray, (rk, rd, bk, bd))
    np.testing.assert_array_equal(bk, rk)
    np.testing.assert_allclose(bd, rd, atol=1e-5)
    return rk, rd


def test_pallas_backend_matches_xla(rng, pallas_interpret):
    """The fused Pallas stage-1 kernel (interpreted) agrees with the XLA
    stage 1 exactly: same gates, same lowest-index tie rule."""
    setup = _setup(rng, P=64, K=80)
    rk, rd = _assert_stage1_equal(_stage1_inputs(*setup), tile_p=16, tile_k=32)
    assert (rd < 1e9).sum() > 50  # the comparison saw real matches


def test_pallas_keypoint_tiling_matches_xla(rng, pallas_interpret):
    """Several keypoint tiles in the kernel's fori_loop: the running argmin
    across tiles is exact and earlier tiles win ties."""
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng, P=64, K=300)
    # Duplicate keypoint 3 into the last tile: equal distance, higher index.
    kp_uv[299], kp_desc[299] = kp_uv[3], kp_desc[3]
    args = _stage1_inputs(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid)
    rk, _ = _assert_stage1_equal(args, tile_p=32, tile_k=64)
    assert rk[3] == 3


@pytest.mark.parametrize(
    "P,K,tile_p,tile_k",
    [(37, 80, 16, 32), (64, 77, 32, 32), (5, 130, 16, 64), (64, 16, 64, 16)],
)
def test_pallas_padding_edges(rng, P, K, tile_p, tile_k, pallas_interpret):
    """P and K that are not multiples of the tiles: the wrapper's padded
    points are ungated and padded keypoints invalid."""
    setup = _setup(rng, P=P, K=max(K, P))
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = setup
    args = _stage1_inputs(cam, pose, X, kp_uv[:K], kp_desc[:K], obs_desc,
                          obs_valid)
    _assert_stage1_equal(args, tile_p=tile_p, tile_k=tile_k)


@pytest.mark.parametrize("case", ["no_gated_points", "no_valid_keypoints",
                                  "invalid_obs_slots"])
def test_pallas_masks(rng, case, pallas_interpret):
    """All rows invalid (nothing passes: best_d = _BIG, best_k = 0), and
    invalid observation slots, whose descriptors must never win."""
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng, P=40, K=64)
    gate = kp_ok = None
    if case == "no_gated_points":
        gate = np.zeros(40, bool)
    elif case == "no_valid_keypoints":
        kp_ok = np.zeros(64, bool)
    else:
        # Slot 0 holds an exact copy of the keypoint descriptor but is
        # invalid; the valid noisy slots must decide the distance.
        obs_desc[:, 0] = kp_desc[:40]
        obs_valid[:, 0] = False
        obs_valid[::3, 1:] = False  # and some points with no valid slot
    args = _stage1_inputs(cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid,
                          gate=gate, kp_ok=kp_ok)
    rk, rd = _assert_stage1_equal(args, tile_p=16, tile_k=32)
    if case != "invalid_obs_slots":
        assert (rd == 1e9).all() and (rk == 0).all()
    else:
        assert (rd[::3] == 1e9).all() and (rd[1::3] > 1e-3).all()


@pytest.mark.parametrize("backend", ["pallas", "banded", "interpret"])
def test_forced_or_removed_backend_raises(rng, backend):
    """Without a GPU, a forced kernel raises instead of interpreting; names
    of removed paths are rejected."""
    setup = _setup(rng, P=16, K=20)
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = setup
    with pytest.raises(ValueError):
        match_map_to_frame(
            cam, jnp.asarray(pose), jnp.asarray(X), jnp.ones(16, bool),
            jnp.asarray(obs_desc), jnp.asarray(obs_valid),
            jnp.asarray(kp_uv), jnp.asarray(kp_desc), jnp.ones(20, bool),
            jnp.zeros(20, bool), jnp.zeros(16, bool),
            max_distance=0.8, backend=backend,
        )
