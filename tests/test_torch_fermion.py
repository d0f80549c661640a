"""fthmc_tpu_torch.fermion against fthmc_tpu.fermion, and mirrors of
tests/test_fermion.py for the ported functions.

The JAX fermion code is fp32 (complex64) whatever the dtype, so these
comparisons are fp32: operators 2e-6 x max|ref| (a few dozen flops a site
in another order; measured ~1e-7 relative); CG solutions 1e-4 relative in
norm (relative residual 1e-5 at tol 1e-10, condition number ~10); the
fermion force 1e-4 relative in norm against jax.grad (the same fixed X,
autograd against jax.grad through the same ops). The dense mirrors keep
the JAX tests' bounds."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import fermion as jf
from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.ops import _build

L = 4
MASS = 0.3


def _theta(seed, batch=None, l=L):
    shape = (2, l, l) if batch is None else (batch, 2, l, l)
    return np.random.default_rng(seed).uniform(
        -math.pi, math.pi, shape).astype(np.float32)


def _psi(seed, lead=(), l=L):
    rng = np.random.default_rng(seed)
    shape = lead + (l, l, 2)
    return (rng.normal(size=shape)
            + 1j * rng.normal(size=shape)).astype(np.complex64)


def _chi(seed, lead=(), l=L):
    return (_psi(seed, lead, l) * math.sqrt(0.5)).astype(np.complex64)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def _even(shape):
    return np.asarray(jf.parity_mask(shape, 0))


@pytest.mark.parametrize("name", ["dirac", "dirac_dag", "apply_mdagm",
                                  "dirac_hat", "dirac_hat_dag",
                                  "apply_mdagm_eo", "_hop"])
def test_operators_match_jax(name):
    theta, psi = _theta(1, batch=3, l=8), _psi(2, (3,), l=8)
    if "hat" in name or name.endswith("_eo"):
        psi = psi * _even(psi.shape)
    jfn, tfn = getattr(jf, name), getattr(tf, name)
    args = () if name == "_hop" else (MASS,)
    want = np.asarray(jfn(jnp.asarray(theta), jnp.asarray(psi), *args))
    got = tfn(_t(theta), _t(psi), *args).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_links_and_parity_match_jax():
    theta = _theta(3, batch=2)
    for a, b in zip(tf._links(_t(theta)), jf._links(jnp.asarray(theta))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for parity in (0, 1):
        np.testing.assert_array_equal(
            tf.parity_mask((2, 6, 4, 2), parity, device="cpu").numpy(),
            np.asarray(jf.parity_mask((2, 6, 4, 2), parity)))


@pytest.mark.parametrize("eo", [False, True])
def test_xla_cg_matches_jax(eo):
    theta = _theta(4, batch=3, l=8)
    phi, _ = jf.pf_refresh(jax.random.PRNGKey(5), jnp.asarray(theta), MASS,
                           eo=eo)
    want = jf._cg_solve_xla(jnp.asarray(theta), phi, MASS, tol=1e-10,
                            maxiter=400, eo=eo)
    got = tf.cg_solve(_t(theta), _t(phi), MASS, tol=1e-10, maxiter=400,
                      eo=eo, backend="xla")
    assert _rel(got.x.numpy(), want.x) < 1e-4
    assert abs(got.iters - int(want.iters)) <= 1
    assert got.launched == got.iters
    assert float(got.rsq.max()) <= 1e-10
    # 'fused' on the CPU is the K9 twin's CG: the same solution
    before = _build.PLAIN_CALLS["K11"]
    fused = tf.cg_solve(_t(theta), _t(phi), MASS, tol=1e-10, maxiter=400,
                        eo=eo, backend="fused")
    assert _rel(fused.x.numpy(), want.x) < 1e-4
    assert _build.PLAIN_CALLS["K11"] > before


def test_cg_backends_resolve():
    assert tf.resolve_cg_backend(None, "cpu") == "xla"
    assert tf.resolve_cg_backend("auto", "cuda") == "fused"
    assert tf.resolve_cg_backend("xla", "cuda") == "xla"
    assert tf.resolve_cg_backend("mixed", "cpu") == "mixed"
    assert tf.resolve_cg_backend("mixed", "cuda") == "mixed"
    with pytest.raises(ValueError):
        tf.set_cg_backend("nope")
    tf.set_cg_backend("fused")
    try:
        assert tf.resolve_cg_backend(None, "cpu") == "fused"
    finally:
        tf.set_cg_backend("auto")


@pytest.mark.parametrize("eo", [False, True])
def test_pf_refresh_matches_jax_on_the_same_chi(eo):
    """phi = D^dag chi and s0 = chi^dag chi from JAX's own chi (its key
    splits, fermion.py:330-333); then the energy identity S_pf = s0."""
    theta = _theta(6, batch=2)
    key = jax.random.PRNGKey(7)
    phi_j, s0_j = jf.pf_refresh(key, jnp.asarray(theta), MASS, eo=eo)
    kr, ki = jax.random.split(key)
    shape = (2, L, L, 2)
    chi = ((jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
           * math.sqrt(0.5)).astype(jnp.complex64)
    phi, s0 = tf.pf_refresh_from(_t(chi), _t(theta), MASS, eo)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_j), rtol=0,
                               atol=2e-6 * np.abs(np.asarray(phi_j)).max())
    np.testing.assert_allclose(s0.numpy(), np.asarray(s0_j), rtol=1e-6)
    s, res = tf.pf_action_exact(_t(theta), phi, MASS, tol=1e-12, eo=eo)
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-4)
    if eo:
        assert np.abs(phi.numpy() * (1 - _even(phi.shape))).max() < 1e-7


def test_pf_refresh_draws_from_the_generator():
    theta = _t(_theta(8, batch=2))
    a = tf.pf_refresh(torch.Generator().manual_seed(1), theta, MASS, eo=True)
    b = tf.pf_refresh(torch.Generator().manual_seed(1), theta, MASS, eo=True)
    assert torch.equal(a[0], b[0]) and a[0].shape == (2, L, L, 2)
    g = torch.Generator().manual_seed(1)
    re, im = (torch.randn((2, L, L, 2), generator=g) for _ in range(2))
    chi = torch.complex(re, im) * math.sqrt(0.5)
    assert torch.equal(a[1], tf.pf_refresh_from(chi, theta, MASS, True)[1])


@pytest.mark.parametrize("eo", [False, True])
def test_pf_action_lin_and_force_match_jax(eo):
    """Value of the variational action and its theta-gradient at the same
    fixed X: torch.autograd against jax.grad, 1e-4 relative."""
    theta = _theta(9, batch=2, l=8)
    phi, _ = jf.pf_refresh(jax.random.PRNGKey(10), jnp.asarray(theta), MASS,
                           eo=eo)
    x = jf.cg_solve(jnp.asarray(theta), phi, MASS, tol=1e-12, maxiter=500,
                    eo=eo).x
    want_s = np.asarray(jf.pf_action_lin(jnp.asarray(theta), phi, x, MASS,
                                         eo=eo))
    want_f = np.asarray(jax.grad(lambda th: jnp.sum(jf.pf_action_lin(
        th, phi, x, MASS, eo=eo)))(jnp.asarray(theta)))
    got_s = tf.pf_action_lin(_t(theta), _t(phi), _t(x), MASS, eo)
    got_f = tf.pf_force_at(_t(theta), _t(phi), _t(x), MASS, eo)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5)
    assert got_f.dtype == torch.float32
    assert _rel(got_f.numpy(), want_f) < 1e-4
    # pf_force solves first, then differentiates
    f, res = tf.pf_force(_t(theta), _t(phi), MASS, tol=1e-12, maxiter=500,
                         eo=eo)
    assert _rel(f.numpy(), want_f) < 1e-3
    # a float64 theta gets a float64 force (the fermion math stays fp32)
    assert tf.pf_force_at(_t(theta).double(), _t(phi), _t(x), MASS,
                          eo).dtype == torch.float64


# -------------------------------------------- mirrors of tests/test_fermion


def _dense(theta, mass, op=tf.dirac):
    """Dense matrix of an operator on (L, L, 2) complex fields."""
    n = L * L * 2
    eye = torch.eye(n, dtype=torch.complex64).reshape(n, L, L, 2)
    cols = op(_t(theta), eye, mass).reshape(n, n)
    return cols.numpy().T


def test_dirac_dag_is_adjoint():
    theta = _theta(20)
    np.testing.assert_allclose(_dense(theta, MASS, tf.dirac_dag),
                               _dense(theta, MASS).conj().T, atol=1e-5)


def test_gamma5_hermiticity_dense():
    theta = _theta(21)
    d = _dense(theta, MASS)
    g5 = np.kron(np.eye(L * L), np.diag([1.0, -1.0])).astype(np.complex64)
    np.testing.assert_allclose(g5 @ d @ g5, d.conj().T, atol=1e-5)


def test_mdagm_hermitian_positive_definite():
    m = _dense(_theta(22), MASS, tf.apply_mdagm)
    np.testing.assert_allclose(m, m.conj().T, atol=1e-5)
    assert np.linalg.eigvalsh(m).min() > 0


def test_free_field_spectrum():
    m = _dense(np.zeros((2, L, L), np.float32), MASS, tf.apply_mdagm)
    w = np.sort(np.linalg.eigvalsh(m))
    k0 = 2 * np.pi * (np.arange(L) + 0.5) / L     # antiperiodic
    k1 = 2 * np.pi * np.arange(L) / L             # periodic
    expect = [(MASS + 2 - np.cos(a) - np.cos(b)) ** 2 + np.sin(a) ** 2
              + np.sin(b) ** 2 for a in k0 for b in k1 for _ in range(2)]
    np.testing.assert_allclose(w, np.sort(expect), rtol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_cg_matches_direct_solve(backend):
    theta, b = _theta(23), _psi(24)
    res = tf.cg_solve(_t(theta), _t(b), MASS, tol=1e-12, maxiter=500,
                      backend=backend)
    x_direct = np.linalg.solve(_dense(theta, MASS, tf.apply_mdagm),
                               b.reshape(-1))
    np.testing.assert_allclose(res.x.numpy().reshape(-1), x_direct,
                               atol=2e-4)
    assert float(res.rsq.max()) < 1e-11


def test_cg_batched_converges_per_chain():
    theta, b = _theta(25, batch=3), _psi(26, (3,))
    res = tf.cg_solve(_t(theta), _t(b), MASS, tol=1e-10, maxiter=500)
    mb = tf.apply_mdagm(_t(theta), res.x, MASS)
    np.testing.assert_allclose(mb.numpy(), b, atol=2e-4)
    assert res.rsq.shape == (3,)


def test_pf_action_lin_value_matches_exact():
    theta = _t(_theta(27))
    phi, _ = tf.pf_refresh(torch.Generator().manual_seed(28), theta, MASS)
    s_exact, res = tf.pf_action_exact(theta, phi, MASS, tol=1e-12)
    s_lin = tf.pf_action_lin(theta, phi, res.x, MASS)
    np.testing.assert_allclose(float(s_lin), float(s_exact), rtol=1e-5)


@pytest.mark.parametrize("eo", [False, True])
def test_pf_force_matches_finite_difference(eo):
    """dS_pf/dtheta against central differences of the tightly solved
    action (fp32, so ~1e-2 relative, the JAX test's bound)."""
    theta = _t(_theta(29))
    phi, _ = tf.pf_refresh(torch.Generator().manual_seed(30), theta, MASS,
                           eo=eo)
    f, _ = tf.pf_force(theta, phi, MASS, tol=1e-12, maxiter=800, eo=eo)
    eps = 1e-3
    rng = np.random.default_rng(0)
    for _ in range(4):
        mu, i, j = rng.integers(0, 2), rng.integers(0, L), rng.integers(0, L)
        d = torch.zeros_like(theta)
        d[mu, i, j] = eps
        sp, _ = tf.pf_action_exact(theta + d, phi, MASS, tol=1e-12, eo=eo)
        sm, _ = tf.pf_action_exact(theta - d, phi, MASS, tol=1e-12, eo=eo)
        fd = (float(sp) - float(sm)) / (2 * eps)
        assert abs(fd - float(f[mu, i, j])) < 2e-2 * max(1.0, abs(fd))


def test_spectrum_gauge_invariant():
    theta = _theta(31)
    w = np.random.default_rng(32).uniform(-math.pi, math.pi, (L, L))
    th2 = tl.gauge_transform(_t(theta), _t(w.astype(np.float32))).numpy()
    m1 = np.linalg.eigvalsh(_dense(theta, MASS, tf.apply_mdagm))
    m2 = np.linalg.eigvalsh(_dense(th2, MASS, tf.apply_mdagm))
    np.testing.assert_allclose(m1, m2, rtol=2e-4)


def _even_sites():
    mask = (_even((L, L, 2)) * np.ones((L, L, 2))).reshape(-1) > 0
    return np.nonzero(mask)[0], np.nonzero(~mask)[0]


def test_dirac_hat_equals_schur_complement():
    theta = _theta(33)
    d = _dense(theta, MASS)
    e, o = _even_sites()
    schur = d[np.ix_(e, e)] - d[np.ix_(e, o)] @ np.linalg.solve(
        d[np.ix_(o, o)], d[np.ix_(o, e)])
    dhat = _dense(theta, MASS, tf.dirac_hat)[np.ix_(e, e)]
    np.testing.assert_allclose(dhat, schur, atol=1e-5)


def test_dirac_hat_determinant_identity():
    theta = _theta(34)
    d = _dense(theta, MASS)
    e, _ = _even_sites()
    dhat = _dense(theta, MASS, tf.dirac_hat)[np.ix_(e, e)]
    n_odd = d.shape[0] - dhat.shape[0]
    ld_full = np.linalg.slogdet(d)[1]
    ld_hat = np.linalg.slogdet(dhat)[1]
    np.testing.assert_allclose(ld_full, ld_hat + n_odd * np.log(MASS + 2.0),
                               rtol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_eo_cg_converges_and_preserves_even_subspace(backend):
    theta = _t(_theta(35, batch=2))
    phi, s0 = tf.pf_refresh(torch.Generator().manual_seed(36), theta, MASS,
                            eo=True)
    mo = 1.0 - _even(phi.shape)
    res = tf.cg_solve(theta, phi, MASS, tol=1e-12, maxiter=400, eo=True,
                      backend=backend)
    assert float(res.rsq.max()) < 1e-11
    assert np.abs(res.x.numpy() * mo).max() < 1e-7
    s, _ = tf.pf_action_exact(theta, phi, MASS, tol=1e-12, eo=True,
                              backend=backend)
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-4)


def test_eo_fewer_cg_iterations():
    theta = _t(_theta(37))
    g = torch.Generator().manual_seed(38)
    phi_f, _ = tf.pf_refresh(g, theta, MASS)
    phi_e, _ = tf.pf_refresh(torch.Generator().manual_seed(38), theta, MASS,
                             eo=True)
    it_f = tf.cg_solve(theta, phi_f, MASS, tol=1e-10, maxiter=2000).iters
    it_e = tf.cg_solve(theta, phi_e, MASS, tol=1e-10, maxiter=2000,
                       eo=True).iters
    assert it_e < it_f, (it_e, it_f)


def test_cg_log_records_solves():
    theta = _t(_theta(39, batch=2))
    phi, _ = tf.pf_refresh(torch.Generator().manual_seed(40), theta, MASS)
    log = tf.CGLog()
    res = tf.cg_solve(theta, phi, MASS, tol=1e-10, maxiter=300,
                      backend="fused")
    log.add("force", res)
    log.add("mh", res)
    assert log.count() == 2 and log.launched() == 2 * res.launched
    assert log.mean_iters("force") == res.iters
