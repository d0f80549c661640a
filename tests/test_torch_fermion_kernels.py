"""K9, K10 and K11 (ops/fermion_kernels.py) against the JAX package's Pallas
fermion kernels (fthmc_tpu/ops/pallas_fermion.py) in interpret mode, on the
CPU, where each wrapper runs its plain twin.

The JAX fermion code is fp32 whatever the dtype, so every comparison is in
fp32. Tolerances: the operator 2e-5 x max|M psi| (one application is ~200
flops a site, summed in another order than XLA's; measured 1.2e-7
relative); CG solutions 1e-4 relative in norm (both solves stop at
|r|^2/|b|^2 <= 1e-10, a relative residual of 1e-5, and the operator's
condition number here is ~10); ``iters`` within 1 of JAX's, since a chain
whose rsq lies within rounding of its stop may take one more or one fewer
iteration."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import fermion as jf
from fthmc_tpu.ops import pallas_fermion as pf
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops import fermion_kernels as fk

MASS = 0.3


def _fields(seed, B=4, L0=8, L1=8, eo=False):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-math.pi, math.pi, (B, 2, L0, L1)).astype(np.float32)
    psi = (rng.normal(size=(B, L0, L1, 2))
           + 1j * rng.normal(size=(B, L0, L1, 2))).astype(np.complex64)
    if eo:
        psi = psi * np.asarray(jf.parity_mask(psi.shape, 0))
    return theta, psi


def _rel(a, b):
    return float(np.linalg.norm((np.asarray(a) - np.asarray(b)).ravel())
                 / np.linalg.norm(np.asarray(b).ravel()))


def test_pack_roundtrip_and_link_planes_match_jax():
    theta, psi = _fields(0)
    p4 = fk.pack_spinor(torch.as_tensor(psi))
    np.testing.assert_array_equal(p4.numpy(),
                                  np.asarray(pf.pack_spinor(psi)))
    assert torch.equal(fk.unpack_spinor(p4), torch.as_tensor(psi))
    ur, ui = fk.link_planes(torch.as_tensor(theta))
    jur, jui = pf.link_planes(jnp.asarray(theta))
    np.testing.assert_allclose(ur.numpy(), np.asarray(jur), atol=1e-6)
    np.testing.assert_allclose(ui.numpy(), np.asarray(jui), atol=1e-6)
    assert float(ur[:, 0, -1].mean()) == pytest.approx(
        -float(torch.cos(torch.as_tensor(theta[:, 0, -1])).mean()), abs=1e-6)


@pytest.mark.parametrize("L0,L1", [(8, 8), (8, 12)])
@pytest.mark.parametrize("layout", ["cf", "cl"])
@pytest.mark.parametrize("eo", [False, True])
def test_twins_match_pallas_interpret(L0, L1, layout, eo):
    """K9's twin ('cf') and K10's ('cl') against pallas_mdagm(...,
    interpret=True) on the same fields, 2e-5 x max|ref|."""
    theta, psi = _fields(1, L0=L0, L1=L1, eo=eo)
    want = np.asarray(pf.pallas_mdagm(jnp.asarray(theta), jnp.asarray(psi),
                                      MASS, eo=eo, layout=layout,
                                      interpret=True))
    before = dict(_build.PLAIN_CALLS)
    got = fk.fused_mdagm(torch.as_tensor(theta), torch.as_tensor(psi), MASS,
                         eo=eo, layout=layout).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    kernel = "K10" if layout == "cl" else "K9"
    assert _build.PLAIN_CALLS[kernel] == before[kernel] + 1


def test_twin_layouts_agree_and_unbatched():
    theta, psi = _fields(2, eo=True)
    t, p = torch.as_tensor(theta), torch.as_tensor(psi)
    cf = fk.fused_mdagm(t, p, MASS, eo=True, layout="cf")
    cl = fk.fused_mdagm(t, p, MASS, eo=True, layout="cl")
    assert torch.equal(cf, cl)            # one math source, same op order
    one = fk.fused_mdagm(t[1], p[1], MASS, eo=True)
    assert one.shape == p[1].shape and torch.equal(one, cf[1])


def test_plane_operator_is_the_complex_operator():
    """The twins on complex fields against the JAX complex operators
    (apply_mdagm[_eo]) as well."""
    for eo in (False, True):
        theta, psi = _fields(3, eo=eo)
        op = jf.apply_mdagm_eo if eo else jf.apply_mdagm
        want = np.asarray(op(jnp.asarray(theta), jnp.asarray(psi), MASS))
        got = fk.fused_mdagm(torch.as_tensor(theta), torch.as_tensor(psi),
                             MASS, eo=eo).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def _phi(seed, eo=True, B=4, L0=8, L1=8):
    theta, _ = _fields(seed, B=B, L0=L0, L1=L1)
    phi, _ = jf.pf_refresh(jax.random.PRNGKey(seed), jnp.asarray(theta),
                           MASS, eo=eo)
    return theta, np.array(phi)


@pytest.mark.parametrize("layout", ["cf", "cl"])
@pytest.mark.parametrize("warm", [False, True])
def test_cg_solve_fused_matches_jax(layout, warm):
    """Port cg_solve_fused (twins) against JAX cg_solve_fused in interpret
    mode: solution to 1e-4 relative, iters within 1, both converged. The
    warm start is a 12-iteration cold solve's solution."""
    theta, phi = _phi(4)
    kw = dict(tol=1e-10, maxiter=300, eo=True, layout=layout)
    x0 = None
    if warm:
        x0 = np.asarray(pf.cg_solve_fused(jnp.asarray(theta),
                                          jnp.asarray(phi), MASS, tol=1e-10,
                                          maxiter=12, eo=True,
                                          interpret=True).x)
    want = pf.cg_solve_fused(jnp.asarray(theta), jnp.asarray(phi), MASS,
                             None if x0 is None else jnp.asarray(x0),
                             interpret=True, **kw)
    got = fk.cg_solve_fused(torch.as_tensor(theta), torch.as_tensor(phi),
                            MASS, None if x0 is None else torch.as_tensor(x0),
                            **kw)
    assert _rel(got.x.numpy(), want.x) < 1e-4
    assert abs(got.iters - int(want.iters)) <= 1
    assert got.iters > (0 if warm else 10)
    assert float(got.rsq.max()) <= 1e-10 and float(want.rsq.max()) <= 1e-10
    assert got.launched % fk.CHECK_EVERY == 0 and got.launched >= got.iters


def test_cg_update_matches_the_jax_loop_body():
    """One K11-twin update against the body of the JAX while_loop
    (pallas_fermion.py:396-409) from the same (x, r, p, rsq) and mp = M p,
    chains-first and chains-last; chain 1 starts converged and must not
    move."""
    rng = np.random.default_rng(5)
    shape = (3, 4, 8, 8)
    p, mp, x, r = (rng.normal(size=shape).astype(np.float32)
                   for _ in range(4))
    rsq = (r * r).sum(axis=(1, 2, 3))
    stop = np.array([1e-3, 2 * rsq[1], 1e-3], np.float32)

    def jax_body(x, r, p, rsq, mp):
        dot = lambda u, v: jnp.sum(u * v, axis=(1, 2, 3))  # noqa: E731
        bc = lambda a: a[:, None, None, None]              # noqa: E731
        active = rsq > stop
        denom = dot(p, mp)
        alpha = jnp.where(active, rsq / jnp.maximum(denom, 1e-30), 0.0)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * mp
        rsq_new = dot(r, r)
        beta = jnp.where(active, rsq_new / jnp.maximum(rsq, 1e-30), 0.0)
        p = r + bc(beta) * p
        rsq = jnp.where(active, rsq_new, rsq)
        return [np.asarray(a) for a in (x, r, p, rsq)]

    want = jax_body(*(jnp.asarray(a) for a in (x, r, p, rsq, mp)))
    for chains_last in (False, True):
        def lay(a):
            a = torch.as_tensor(a.copy())
            return a.permute(1, 2, 3, 0).contiguous() if chains_last else a

        def back(a):
            return (a.permute(3, 0, 1, 2) if chains_last else a).numpy()

        tp, tmp, tx, tr = lay(p), lay(mp), lay(x), lay(r)
        trsq = torch.as_tensor(rsq.copy())
        counters = torch.zeros(2, dtype=torch.int32)
        fk.cg_update(tp, tmp, tx, tr, trsq, torch.as_tensor(stop), counters,
                     6, chains_last)
        for got, ref in zip((back(tx), back(tr), back(tp), trsq.numpy()),
                            want):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        assert np.array_equal(back(tx)[1], x[1])      # frozen chain
        assert np.array_equal(back(tr)[1], r[1])
        assert np.array_equal(back(tp)[1], r[1])      # p = r + 0 p
        assert counters.tolist() == [7, 7]


def test_checking_every_n_iterations_is_exact(monkeypatch):
    """The fused CG reads its convergence flag every CHECK_EVERY
    iterations; the iterations after the last chain converged are exact
    no-ops, so x, rsq and iters equal those of checking every iteration."""
    theta, phi = _phi(6, B=5)
    args = (torch.as_tensor(theta), torch.as_tensor(phi), MASS)
    kw = dict(tol=1e-9, maxiter=200, eo=True)
    chunked = fk.cg_solve_fused(*args, **kw)
    monkeypatch.setattr(fk, "CHECK_EVERY", 1)
    each = fk.cg_solve_fused(*args, **kw)
    assert torch.equal(each.x, chunked.x) and torch.equal(each.rsq,
                                                          chunked.rsq)
    assert each.iters == chunked.iters == each.launched
    assert chunked.launched > chunked.iters
    monkeypatch.setattr(fk, "CHECK_EVERY", 8)
    capped = fk.cg_solve_fused(*args, tol=1e-9, maxiter=7, eo=True)
    assert capped.iters == capped.launched == 7      # never past maxiter


@pytest.mark.parametrize("L0,L1", [(7, 8), (8, 9), (2, 8)])
def test_envelope_raises_on_odd_or_tiny_sides(L0, L1):
    theta, psi = _fields(7, L0=L0, L1=L1)
    t, p = torch.as_tensor(theta), torch.as_tensor(psi)
    with pytest.raises(ValueError, match="even sides >= 4"):
        fk.fused_mdagm(t, p, MASS, eo=False)
    with pytest.raises(ValueError, match="even sides >= 4"):
        fk.cg_solve_fused(t, p, MASS, tol=1e-8, maxiter=10, eo=False)
    ur, ui = fk.link_planes(t)
    with pytest.raises(ValueError, match="even sides >= 4"):
        fk.mdagm(ur, ui, fk.pack_spinor(p), MASS, False)


def test_wrappers_run_twins_on_the_cpu_and_check_shapes():
    theta, psi = _fields(8)
    ur, ui = fk.link_planes(torch.as_tensor(theta))
    p4 = fk.pack_spinor(torch.as_tensor(psi))
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    out = torch.empty_like(p4)
    assert fk.mdagm(ur, ui, p4, MASS, True, out=out) is out
    t = (lambda a: a.permute(1, 2, 3, 0).contiguous())  # noqa: E731
    fk.mdagm_cl(t(ur), t(ui), t(p4), MASS, True)
    rsq = (p4 * p4).sum(dim=(1, 2, 3))
    fk.cg_update(p4.clone(), p4, p4.clone(), p4.clone(), rsq, rsq * 0,
                 torch.zeros(2, dtype=torch.int32), 0, False)
    plain = {k: _build.PLAIN_CALLS[k] - before[0][k] for k in before[0]}
    assert plain == dict.fromkeys(_build.KERNELS, 0) | {"K9": 1, "K10": 1,
                                                        "K11": 1}
    assert dict(_build.LAUNCHES) == before[1]
    with pytest.raises(ValueError):                    # links vs planes
        fk.mdagm(ur[:, :1], ui[:, :1], p4, MASS, True)
    with pytest.raises(ValueError):                    # chains-last shapes
        fk.mdagm_cl(ur, ui, p4, MASS, True)
    with pytest.raises(ValueError):
        fk.cg_update(p4, p4, p4, p4, rsq[:2], rsq, torch.zeros(2), 0, False)


def test_resolve_layout():
    assert fk.resolve_layout("auto", 16, 16) == "cf"
    assert fk.resolve_layout("auto", 64, 64) == "cf"
    assert fk.resolve_layout("cl", 64, 64) == "cl"
    with pytest.raises(ValueError):
        fk.resolve_layout("chains_last", 8, 8)


def test_bound_signatures_match_the_c_entries():
    """Every ctypes signature of ops/_build.py has as many arguments as its
    C entry in csrc (the card is the only place a mismatch would show)."""
    import re
    csrc = _build.CSRC
    text = "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu*")))
    for lib, entries in _build._SIGNATURES.items():
        for fn, argtypes in entries.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
            assert m, f"{lib}: no C entry {fn}"
            params = [a for a in m.group(1).split(",") if a.strip()]
            assert len(params) == len(argtypes), (fn, params, argtypes)
