"""PyTorch port: square-root linear algebra vs the JAX package.

float64 on the CPU. Tolerances: 1e-12 relative for products and solves
(same LAPACK/BLAS kernels, different call paths); 1e-10 on Cholesky
factors of matrices with condition up to ~1e4.

``chol_psd_flagged`` is the one place where the two frameworks' failure
semantics differ (JAX's Cholesky returns NaN, torch's raises), so its repair
ladder is tested rung by rung on matrices built to need each rung.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu import ops as jops
from cv_monoslam_tpu.ops import linalg as jla
from cv_monoslam_tpu_torch import ops as tops
from cv_monoslam_tpu_torch.ops import linalg as tla


def _spd(n, eigs, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, n)))
    return (q * np.asarray(eigs)) @ q.T


def _tall(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d))


def test_gram_matches_jax():
    a = _tall(40, 12, 0)
    np.testing.assert_allclose(tla.gram(torch.as_tensor(a)).numpy(),
                               np.asarray(jla.gram(jnp.asarray(a))),
                               rtol=1e-12, atol=1e-12)


def test_cholqr_matches_jax():
    a = _tall(60, 16, 1) * np.logspace(0, -2, 16)
    got = tla.cholqr(torch.as_tensor(a)).numpy()
    want = np.asarray(jla.cholqr(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.T @ got, a.T @ a, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("mode", ["gram", "householder"])
def test_qr_r_matches_jax(mode):
    a = _tall(50, 10, 2)
    got = tops.qr_r(torch.as_tensor(a), mode).numpy()
    want = np.asarray(jops.qr_r(jnp.asarray(a), mode))
    # R is unique up to row signs: compare R^T R and |R|
    np.testing.assert_allclose(got.T @ got, want.T @ want, rtol=1e-10)
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-9,
                               atol=1e-12)
    assert np.allclose(np.tril(got, -1), 0.0)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("vector", [False, True])
def test_tri_solve_matches_jax(trans, lower, vector):
    rng = np.random.default_rng(3)
    r = np.triu(rng.normal(size=(8, 8))) + 4 * np.eye(8)
    if lower:
        r = r.T
    b = rng.normal(size=(8,) if vector else (8, 3))
    got = tla.tri_solve(torch.as_tensor(r), torch.as_tensor(b), trans=trans,
                        lower=lower).numpy()
    want = np.asarray(jla.tri_solve(jnp.asarray(r), jnp.asarray(b),
                                    trans=trans, lower=lower))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# smallest eigenvalue -> the rung that repairs it (jitter 1e-6, scale 1):
# rungs add 1e-6, 1e-4, 1e-3 and 1.0 times the scale to the diagonal
@pytest.mark.parametrize("lam_min,level,finite", [
    (0.1, 0, True),
    (-3e-7, 1, True),
    (-3e-5, 2, True),
    (-3e-4, 3, True),
    (-0.3, 4, True),
    (-50.0, 4, False),
])
def test_chol_psd_flagged_levels_match_jax(lam_min, level, finite):
    eigs = np.linspace(lam_min, 1.0, 6)
    g = _spd(6, eigs, seed=4)
    if lam_min > -1.0:
        assert np.abs(np.diag(g)).max() <= 1.0      # jitter scale is 1
    r, lv = tla.chol_psd_flagged(torch.as_tensor(g), 1e-6)
    jr, jlv = jla.chol_psd_flagged(jnp.asarray(g), 1e-6)
    assert lv == int(jlv) == level
    r, jr = r.numpy(), np.asarray(jr)
    assert np.isfinite(r).all() == np.isfinite(jr).all() == finite
    if finite:
        np.testing.assert_allclose(r, jr, rtol=1e-10, atol=1e-10)
    else:
        # NaN on and above the diagonal, 0 below, in both
        np.testing.assert_array_equal(np.isnan(r), np.isnan(jr))
        np.testing.assert_array_equal(np.nan_to_num(r), np.nan_to_num(jr))
