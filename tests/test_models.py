import jax
import jax.numpy as jnp
import numpy as np
import pytest

from racing_slam_tpu.models import lightglue, superpoint
from racing_slam_tpu.utils.synthetic import random_texture, shift_image


def test_superpoint_shapes_and_selection(rng):
    fr = superpoint.SuperPointFrontend(seed=1, cell=16, n_per_cell=2)
    img = jnp.asarray(random_texture(96, 128, rng))
    feat = jax.jit(fr.extract)(img)
    K = fr.num_keypoints(96, 128)
    assert feat.xy.shape == (K, 2)
    assert feat.desc.shape == (K, superpoint.DESC_DIM)
    # Descriptors unit-norm.
    norms = np.linalg.norm(np.asarray(feat.desc), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    # Keypoints inside the image.
    xy = np.asarray(feat.xy)
    assert (xy[:, 0] < 128).all() and (xy[:, 1] < 96).all()


def test_superpoint_mask(rng):
    fr = superpoint.SuperPointFrontend(seed=1)
    img = jnp.asarray(random_texture(96, 128, rng))
    mask = np.zeros((96, 128), np.float32)
    mask[:, 64:] = 1.0
    feat = fr.extract(img, jnp.asarray(mask))
    xy = np.asarray(feat.xy)[np.asarray(feat.valid)]
    assert (xy[:, 0] >= 64).all()


def test_superpoint_params_roundtrip(tmp_path):
    p = superpoint.init_params(jax.random.PRNGKey(3))
    superpoint.save_params(tmp_path / "sp.npz", p)
    q = superpoint.load_params(tmp_path / "sp.npz")
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(q)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_lightglue_zero_layers_is_exact_dual_softmax(rng):
    """With 0 layers and identity-ish descriptors, mutual matches must be the
    ground-truth permutation."""
    K, D = 32, 64
    d0 = _unit(rng.standard_normal((K, D)).astype(np.float32))
    perm = rng.permutation(K)
    d1 = d0[perm] + 0.05 * rng.standard_normal((K, D)).astype(np.float32)
    d1 = _unit(d1)
    xy = rng.uniform(0, 100, (K, 2)).astype(np.float32)

    params = lightglue.init_params(jax.random.PRNGKey(0), in_dim=D, dim=D, n_layers=0)
    # Make the projections identity so raw similarity drives the assignment.
    params = params._replace(
        in_proj_w=jnp.eye(D), match_proj_w=jnp.eye(D) * 8.0,
        matchability_w=jnp.zeros((D, 1)), matchability_b=jnp.full((1,), 10.0),
    )
    m = lightglue.match(
        params, jnp.asarray(d0), jnp.asarray(xy), jnp.ones(K, bool),
        jnp.asarray(d1), jnp.asarray(xy), jnp.ones(K, bool),
        image_size=(100.0, 100.0), threshold=0.05,
    )
    valid = np.asarray(m.valid)
    ti = np.asarray(m.train_idx)
    assert valid.mean() > 0.9
    assert (ti[valid] == perm[valid]).mean() > 0.95


def test_lightglue_respects_validity(rng):
    K, D = 16, 32
    d = _unit(rng.standard_normal((K, D)).astype(np.float32))
    xy = rng.uniform(0, 50, (K, 2)).astype(np.float32)
    params = lightglue.init_params(jax.random.PRNGKey(1), in_dim=D, dim=D, n_layers=1)
    v1 = np.ones(K, bool)
    v1[:8] = False
    m = lightglue.match(
        params, jnp.asarray(d), jnp.asarray(xy), jnp.ones(K, bool),
        jnp.asarray(d), jnp.asarray(xy), jnp.asarray(v1),
        image_size=(50.0, 50.0), threshold=0.0,
    )
    assert not np.asarray(m.valid)[:8].any()


def test_lightglue_layers_jit_and_grad(rng):
    """The transformer stack must be differentiable (for training) and jit."""
    K, D = 24, 64
    d0 = jnp.asarray(_unit(rng.standard_normal((K, D)).astype(np.float32)))
    d1 = jnp.asarray(_unit(rng.standard_normal((K, D)).astype(np.float32)))
    xy = jnp.asarray(rng.uniform(0, 64, (K, 2)).astype(np.float32))
    params = lightglue.init_params(jax.random.PRNGKey(2), in_dim=D, dim=D, n_layers=2)

    @jax.jit
    def loss(p):
        s, m0, m1 = lightglue.assignment_scores(
            p, d0, xy, jnp.ones(K, bool), d1, xy, jnp.ones(K, bool), (64.0, 64.0)
        )
        return -jnp.mean(jnp.log(jnp.diagonal(s) + 1e-9))

    g = jax.grad(loss)(params)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert any(float(jnp.abs(x).max()) > 0 for x in leaves)


def test_train_smoke(rng):
    """A few optimization steps must run and reduce nothing crazy (finite)."""
    from racing_slam_tpu.models import train

    sp = train.train_superpoint(steps=2, img_size=(64, 64), n_corr=32, log_every=0)
    leaves = jax.tree_util.tree_leaves(sp)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)

    lg = train.train_lightglue(steps=2, K=32, dim=32, n_layers=1, log_every=0)
    leaves = jax.tree_util.tree_leaves(lg)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)


def _permutation_match_stats(params, n_pairs=3, K=48, dim=32, noise=0.35, seed=123):
    r = np.random.default_rng(seed)
    hits, total = 0, 0
    for _ in range(n_pairs):
        d0 = r.standard_normal((K, dim)).astype(np.float32)
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
        xy0 = r.uniform(0, 128, (K, 2)).astype(np.float32)
        perm = r.permutation(K)
        d1 = d0[perm] + noise * r.standard_normal((K, dim)).astype(np.float32)
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        m = lightglue.match(
            params, jnp.asarray(d0), jnp.asarray(xy0), jnp.ones(K, bool),
            jnp.asarray(d1), jnp.asarray(xy0[perm]), jnp.ones(K, bool),
            image_size=(128.0, 128.0), threshold=0.05,
        )
        v = np.asarray(m.valid)
        ti = np.asarray(m.train_idx)
        hits += (ti[v] == perm[v]).sum()
        total += int(v.sum())
    return hits, total


def test_lightglue_training_improves_matching(rng):
    """A short training run must lift correct-match recall far above the
    untrained network (validates the loss wiring; production-grade weights
    need a long run via models/train.py)."""
    from racing_slam_tpu.models import train

    untrained = lightglue.init_params(jax.random.PRNGKey(5), 32, 32, 1)
    hits_u, _ = _permutation_match_stats(untrained)

    params = train.train_lightglue(steps=600, K=48, dim=32, n_layers=1,
                                   noise=0.35, log_every=0, seed=5, lr=2e-3)
    hits_t, total_t = _permutation_match_stats(params)
    assert total_t >= 20
    assert hits_t > max(3 * hits_u, 15), (hits_u, hits_t, total_t)


def test_xla_flash_attention_matches_dense(rng):
    """The lax.scan online-softmax path (_flash_mha_xla, the "auto" default)
    must reproduce the dense einsum path to f32 accuracy — including the
    fully-masked uniform-softmax case and ragged (non-tile-multiple) K."""
    Kq, Kk, H, dh = 200, 333, 4, 64
    q = jnp.asarray(rng.normal(size=(Kq, H, dh)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(Kk, H, dh)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(Kk, H, dh)), jnp.float32)
    mask_q = jnp.asarray(rng.random(Kq) < 0.8)
    for mask_k in (
        jnp.asarray(rng.random(Kk) < 0.8),
        jnp.zeros((Kk,), bool),  # all masked -> uniform over the Kk keys
    ):
        ref = lightglue._mha(q, k, v, mask_q, mask_k, backend="xla")
        got = lightglue._mha(q, k, v, mask_q, mask_k, backend="xla_flash")
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


def _lightglue_inputs(rng, K0=96, K1=128):
    params = lightglue.init_params(
        jax.random.PRNGKey(1), in_dim=32, dim=64, n_layers=2
    )
    d0 = jnp.asarray(rng.normal(size=(K0, 32)), jnp.float32)
    d1 = jnp.asarray(rng.normal(size=(K1, 32)), jnp.float32)
    xy0 = jnp.asarray(rng.uniform(0, 320, size=(K0, 2)), jnp.float32)
    xy1 = jnp.asarray(rng.uniform(0, 320, size=(K1, 2)), jnp.float32)
    v0 = jnp.asarray(rng.random(K0) < 0.9)
    v1 = jnp.asarray(rng.random(K1) < 0.9)
    return params, d0, xy0, v0, d1, xy1, v1


def test_lightglue_flash_backend_matches_dense(rng):
    """Full assignment_scores parity between the dense einsum attention and
    the "auto" (lax.scan online-softmax) attention."""
    args = _lightglue_inputs(rng)
    s_ref, m0r, m1r = lightglue.assignment_scores(
        *args, (320.0, 240.0), attn_backend="xla"
    )
    s_got, m0g, m1g = lightglue.assignment_scores(*args, (320.0, 240.0))
    np.testing.assert_allclose(np.asarray(s_got), np.asarray(s_ref),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(m0g), np.asarray(m0r), atol=1e-5)
    np.testing.assert_allclose(np.asarray(m1g), np.asarray(m1r), atol=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
def test_removed_attention_backend_raises(rng, backend):
    """The attention kernel is gone; its backend names are rejected."""
    with pytest.raises(ValueError):
        lightglue.assignment_scores(
            *_lightglue_inputs(rng, 16, 16), (320.0, 240.0),
            attn_backend=backend,
        )
