"""Hasenbusch preconditioning, the mixed-precision CG, the dense operator
and log-determinant, and the fermion observables of fthmc_tpu_torch.fermion
against fthmc_tpu.fermion, and mirrors of their tests in
tests/test_fermion.py.

fp32 throughout, as the JAX fermion code is. Tolerances: the heatbath on
JAX's chi 1e-5 relative; the ratio action and its gradient 1e-4 relative
in norm; the dense operator 1e-6; the log-determinant 1e-5 relative, its
gradient 1e-4; the observables on the same noise 1e-5 relative (solves at
1e-12 / 1e-14). The mixed CG's twin against JAX's _cg_solve_mixed: every
chain's final rel <= tol, the solutions within 10 sqrt(tol) relative, the
iterations within 25% (bf16 rounds at other places in torch and in XLA)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import fermion as jf
from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops import fermion_kernels as fk

B, L, MASS = 3, 8, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes that share the cores, and the dense log-determinant's
    OpenMP parallel regions stalled for minutes when the workers' threads
    outnumbered them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _links(seed, b=B, l=L, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, 2, l, l))
            * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _chi(kr, ki, shape):
    return ((jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
            * math.sqrt(0.5)).astype(jnp.complex64)


@pytest.mark.parametrize("eo", [True, False])
def test_hasenbusch_refresh_matches_jax_on_its_chi(eo):
    x = _links(1)
    key = jax.random.PRNGKey(2)
    p1, p2, s0 = jf.hasenbusch_refresh(key, jnp.asarray(x), 0.2, 0.6,
                                       tol=1e-12, maxiter=600, eo=eo)
    shape = (B, L, L, 2)
    k1r, k1i, k2r, k2i = jax.random.split(key, 4)
    chi1, chi2 = (torch.as_tensor(np.array(_chi(a, b, shape)))
                  for a, b in ((k1r, k1i), (k2r, k2i)))
    q1, q2, t0, res = tf.hasenbusch_refresh_from(
        chi1, chi2, torch.as_tensor(x), 0.2, 0.6, tol=1e-12, maxiter=600,
        eo=eo)
    assert _rel(q1, p1) < 1e-5 and _rel(q2, p2) < 1e-5
    np.testing.assert_allclose(t0.numpy(), np.asarray(s0), rtol=1e-5)
    assert float(res.rsq.max()) <= 1e-12


@pytest.mark.parametrize("eo", [True, False])
def test_ratio_action_lin_and_its_gradient_match_jax(eo):
    x = _links(3)
    phi2 = _chi(*jax.random.split(jax.random.PRNGKey(4)), (B, L, L, 2))
    y = _chi(*jax.random.split(jax.random.PRNGKey(5)), (B, L, L, 2))
    if eo:
        mask = jf.parity_mask((L, L, 2), 0)
        phi2, y = phi2 * mask, y * mask
    jx = jnp.asarray(x)
    want = np.asarray(jf.ratio_action_lin(jx, phi2, y, 0.2, 0.6, eo=eo))
    wgrad = np.asarray(jax.grad(lambda t: jnp.sum(jf.ratio_action_lin(
        t, phi2, y, 0.2, 0.6, eo=eo)))(jx))
    tphi, ty = (torch.as_tensor(np.array(a)) for a in (phi2, y))
    got = tf.ratio_action_lin(torch.as_tensor(x), tphi, ty, 0.2, 0.6, eo)
    grad = tf.ratio_force_at(torch.as_tensor(x), tphi, ty, 0.2, 0.6, eo)
    assert _rel(got, want) < 1e-4 and _rel(grad, wgrad) < 1e-4


@pytest.mark.parametrize("layout", ["cf", "cl"])
@pytest.mark.parametrize("eo", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_mixed_cg_twin_matches_jax(layout, eo, warm):
    x = _links(6)
    phi, _ = jf.pf_refresh(jax.random.PRNGKey(7), jnp.asarray(x), 0.3, eo=eo)
    x0 = None
    if warm:
        x0 = jf._cg_solve_xla(jnp.asarray(x), phi, 0.3, tol=1e-4,
                              maxiter=400, eo=eo).x
    tol = 1e-9
    want = jf._cg_solve_mixed(jnp.asarray(x), phi, 0.3, x0, tol=tol,
                              maxiter=600, eo=eo)
    before = _build.PLAIN_CALLS["K11_bf16"]
    got = fk.cg_solve_mixed(torch.as_tensor(x),
                            torch.as_tensor(np.array(phi)), 0.3,
                            None if x0 is None else
                            torch.as_tensor(np.array(x0)), tol=tol,
                            maxiter=600, eo=eo, layout=layout)
    assert float(got.rsq.max()) <= tol
    assert _rel(got.x, want.x) < 10 * math.sqrt(tol)
    assert abs(got.iters - int(want.iters)) <= 0.25 * int(want.iters)
    assert got.launched == got.iters and got.reads >= 2
    assert _build.PLAIN_CALLS["K11_bf16"] > before


def test_mixed_cg_freezes_chains_and_refuses_odd_sites():
    """A chain with b = 0 never runs (its x stays 0); an eo b that is not
    zero on an odd site is refused, as by the fused CG."""
    x = torch.as_tensor(_links(8))
    phi, _ = tf.pf_refresh(torch.Generator().manual_seed(1), x, 0.3, eo=True)
    phi[1] = 0
    res = fk.cg_solve_mixed(x, phi, 0.3, tol=1e-9, maxiter=600, eo=True)
    assert bool((res.x[1] == 0).all()) and float(res.rsq.max()) <= 1e-9
    odd = phi.clone()
    odd[:, 0, 1, 0] = 1.0
    with pytest.raises(ValueError, match="odd sites"):
        fk.cg_solve_mixed(x, odd, 0.3, tol=1e-9, maxiter=600, eo=True)


def test_bf16_inner_twin_reduces_its_residual():
    """K11_bf16's twin (the JAX inner loop): bf16 planes in and out, the
    rsq reduction of MIXED_INNER_TOL reached within MIXED_INNER_MAX sweeps
    at this size, the true residual of d a few 1e-2 of |r| (bf16)."""
    x = torch.as_tensor(_links(9))
    phi, _ = tf.pf_refresh(torch.Generator().manual_seed(2), x, 0.3, eo=True)
    op = fk._PackedOperator(x, "cf")
    r = op.pack(phi)
    d, k = fk.cg_planes_bf16_plain(op.ur.bfloat16(), op.ui.bfloat16(),
                                   r.bfloat16(), 0.3, fk.MIXED_INNER_TOL,
                                   fk.MIXED_INNER_MAX, True, False)
    assert d.dtype == torch.bfloat16 and 0 < k < fk.MIXED_INNER_MAX
    res = r - fk.mdagm_plain(op.ur, op.ui, d.float(), 0.3, True)
    assert float(res.norm() / r.norm()) < 5e-2


def test_dirac_dense_matches_jax():
    x = _links(10, b=1, l=4)[0]
    want = np.asarray(jf.dirac_dense(jnp.asarray(x), MASS))
    got = tf.dirac_dense(torch.as_tensor(x), MASS)
    assert got.shape == want.shape == (64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    batched = tf.dirac_dense(torch.as_tensor(_links(10, b=2, l=4)), MASS)
    assert torch.equal(batched[0], got)


def test_logdet_mdagm_and_its_gradient_match_jax():
    x = _links(11, b=2)
    jx = jnp.asarray(x)
    want = np.asarray(jf.logdet_mdagm(jx, MASS))
    wgrad = np.asarray(jax.grad(lambda t: jnp.sum(jf.logdet_mdagm(t, MASS)))(
        jx))
    tx = torch.as_tensor(x).requires_grad_(True)
    got = tf.logdet_mdagm(tx, MASS)
    (grad,) = torch.autograd.grad(got.sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert _rel(grad, wgrad) < 1e-4


def test_logdet_mdagm_matches_complex_slogdet():
    """The mirror of the JAX test: the real representation's log-det ==
    the complex slogdet of D^dag D (float64 numpy), 2e-5."""
    x = torch.as_tensor(_links(12, l=4))
    ld = tf.logdet_mdagm(x, MASS).numpy()
    for b in range(x.shape[0]):
        n = 2 * 4 * 4
        basis = torch.eye(n, dtype=torch.complex64).reshape(n, 4, 4, 2)
        d = tf.dirac(x[b], basis, MASS).reshape(n, n).T.numpy()
        d = d.astype(np.complex128)
        _, want = np.linalg.slogdet(d.conj().T @ d)
        np.testing.assert_allclose(ld[b], want, rtol=2e-5)


def test_chiral_condensate_matches_jax_on_its_noise():
    x = _links(13)
    key = jax.random.PRNGKey(14)
    want = np.asarray(jf.chiral_condensate(key, jnp.asarray(x), MASS,
                                           n_noise=4, tol=1e-12))
    shape = (B, L, L, 2)
    eta = np.stack([np.array(_chi(*jax.random.split(k), shape))
                    for k in jax.random.split(key, 4)])
    got = tf.chiral_condensate_from(torch.as_tensor(eta),
                                    torch.as_tensor(x), MASS, tol=1e-12)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("batched", [True, False])
def test_pion_correlator_matches_jax(batched):
    x = _links(15) if batched else _links(15)[0]
    want = np.asarray(jf.pion_correlator(jnp.asarray(x), MASS, tol=1e-12))
    got = tf.pion_correlator(torch.as_tensor(x), MASS, tol=1e-12)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_chiral_condensate_free_field():
    """The mirror of the JAX test: theta = 0, the momentum-space value
    within 5% over 256 noises."""
    theta = torch.zeros((2, L, L))
    got = float(tf.chiral_condensate(torch.Generator().manual_seed(15),
                                     theta, MASS, n_noise=256, tol=1e-12))
    k0 = (2 * np.pi * (np.arange(L) + 0.5)) / L
    k1 = (2 * np.pi * np.arange(L)) / L
    tot = 0.0
    for a in k0:
        for b in k1:
            wil = MASS + 2 - np.cos(a) - np.cos(b)
            tot += 2 * wil / (wil ** 2 + np.sin(a) ** 2 + np.sin(b) ** 2)
    expect = tot / (L * L * 2)
    assert abs(got - expect) < 0.05 * abs(expect), (got, expect)


def test_pion_correlator_free_field():
    """The mirror of the JAX test: theta = 0, the exact free propagator's
    correlator (1e-3), positive and time-reflection symmetric."""
    c = tf.pion_correlator(torch.zeros((2, L, L)), MASS, tol=1e-14).numpy()
    assert c.shape == (L,) and np.all(c > 0)
    k0 = 2 * np.pi * (np.arange(L) + 0.5) / L
    k1 = 2 * np.pi * np.arange(L) / L
    g0 = np.array([[0, 1], [1, 0]], complex)
    g1 = np.array([[0, -1j], [1j, 0]], complex)
    prop = np.zeros((L, L, 2, 2), complex)
    for a in k0:
        for b in k1:
            wil = MASS + 2 - np.cos(a) - np.cos(b)
            num = wil * np.eye(2) - 1j * (np.sin(a) * g0 + np.sin(b) * g1)
            den = wil ** 2 + np.sin(a) ** 2 + np.sin(b) ** 2
            phase = np.exp(1j * (a * np.arange(L)[:, None]
                                 + b * np.arange(L)[None, :]))
            prop += phase[..., None, None] * (num / den)
    prop /= L * L
    c_exact = (np.abs(prop) ** 2).sum(axis=(1, 2, 3))
    np.testing.assert_allclose(c, c_exact, rtol=1e-3)
    np.testing.assert_allclose(c[1:], c[1:][::-1], rtol=1e-3)
