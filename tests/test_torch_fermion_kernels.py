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
    """'auto' follows the H100 times at 128 chains: K10 at 8^2, K9 from
    16^2 (paths A and C) up."""
    assert fk.resolve_layout("auto", 8, 8) == "cl"
    assert fk.resolve_layout("auto", 4, 8) == "cl"
    assert fk.resolve_layout("auto", 8, 12) == "cf"
    assert fk.resolve_layout("auto", 16, 16) == "cf"
    assert fk.resolve_layout("auto", 64, 64) == "cf"
    assert fk.resolve_layout("cl", 64, 64) == "cl"
    assert fk.resolve_layout("cf", 8, 8) == "cf"
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


# ---------------------------------------------------------------------------
# The band geometry of K9 and K10 (csrc/fermion.cu, op_kernel), mirrored in
# float64: bands of rows a group, each with four halo rows a side loaded
# with it (global rows wrapping L0 - 1 <-> 0), passes over the sites of one
# parity by global row, each one row narrower a side, K10's chain tiles
# with a ragged last tile zero-filled. Rows a band never loads are NaN, so
# an own site that reads one shows.
# ---------------------------------------------------------------------------

N_SM = 132               # an H100's SMs


def _links64(theta):
    """link_planes in float64: (ur, ui), each (B, 2, L0, L1)."""
    th = torch.as_tensor(theta, dtype=torch.float64)
    sign = torch.ones((2, th.shape[-2], 1), dtype=torch.float64)
    sign[0, -1] = -1.0
    return torch.cos(th) * sign, torch.sin(th) * sign


def _hop_site(sf0, sb0, sf1, sb1, u, ub0, ub1):
    """hop_site: H at sites whose neighbours n + e0, n - e0, n + e1, n - e1
    hold sf0, sb0, sf1, sb1 (4 planes each), u the links at the sites, ub0
    and ub1 at n - e0 and n - e1 (ur0, ui0, ur1, ui1)."""
    dr, di = sf0[0] - sf0[2], sf0[1] - sf0[3]
    mr, mi = u[0] * dr - u[1] * di, u[0] * di + u[1] * dr
    h0r, h0i, h1r, h1i = mr, mi, -mr, -mi
    dr, di = sb0[0] + sb0[2], sb0[1] + sb0[3]
    mr, mi = ub0[0] * dr + ub0[1] * di, ub0[0] * di - ub0[1] * dr
    h0r, h0i, h1r, h1i = h0r + mr, h0i + mi, h1r + mr, h1i + mi
    dr, di = sf1[0] - sf1[3], sf1[1] + sf1[2]
    mr, mi = u[2] * dr - u[3] * di, u[2] * di + u[3] * dr
    h0r, h0i, h1r, h1i = h0r + mr, h0i + mi, h1r + mi, h1i - mr
    dr, di = sb1[0] + sb1[3], sb1[1] - sb1[2]
    mr, mi = ub1[2] * dr + ub1[3] * di, ub1[2] * di - ub1[3] * dr
    h0r, h0i, h1r, h1i = h0r + mr, h0i + mi, h1r - mi, h1i + mr
    return torch.stack((h0r, h0i, h1r, h1i))


def banded_op(urt, uit, p4t, mass, eo, C, row0, tile):
    """The normal operator of chains-last planes (4, L0, L1, B) with links
    (2, L0, L1, B) as op_kernel computes it, group by group (``tile``
    chains, the last ragged one zero-filled) and band by band: buffers (4
    planes, R + 8 band rows, L1, tile), band row b being global row
    r0 - 4 + b (wrapped on load); each pass over the sites of one parity by
    global row, one row fewer a side than the pass before it, the last
    over the own rows. Rows a band never loads are NaN, so an own site that
    reads one shows. K9 is tile 1 on the chains-last view."""
    _, L0, L1, B = p4t.shape
    w = L1 // 2
    a = mass + 2.0
    # b in fp32, as the twins form it (b * even, an fp32 mask) and the
    # kernels take it
    b = float(torch.tensor(0.25 / a, dtype=torch.float32))
    rows = [hi - lo for lo, hi in zip(row0, row0[1:])]
    R = max(rows)
    nan = float("nan")
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=p4t.dtype).view(4, 1, 1)
    jj = torch.arange(w)
    out = torch.full_like(p4t, nan)

    def load(buf, lo, planes, g_lo, n, c0, nc):
        g = [(g_lo + k) % L0 for k in range(n)]
        buf[:, lo:lo + n] = 0.0                           # masked chains
        buf[:, lo:lo + n, :, :nc] = planes[:, g, :, c0:c0 + nc]

    for c0 in range(0, B, tile):
        nc = min(tile, B - c0)
        for r in range(C):
            Rr, r0 = rows[r], row0[r]
            S = torch.full((4, R + 8, L1, tile), nan, dtype=p4t.dtype)
            T = torch.full_like(S, nan)
            U = torch.full((4, R + 7, L1, tile), nan, dtype=p4t.dtype)
            load(S, 0, p4t, r0 - 4, Rr + 8, c0, nc)
            load(U[0:2], 0, torch.stack((urt[0], uit[0])), r0 - 4, Rr + 7,
                 c0, nc)
            load(U[2:4], 1, torch.stack((urt[1], uit[1])), r0 - 3, Rr + 6,
                 c0, nc)
            bufs = {"S": S, "T": T}

            def run(kind, par, lo, n, src, self_, dst, c=0.0):
                for bb in range(lo, lo + n):
                    j = 2 * jj + (r0 - 4 + bb + par) % 2
                    jp, jm = (j + 1) % L1, (j - 1) % L1
                    if kind != "scale":
                        X = bufs[src]
                        h = _hop_site(X[:, bb + 1, j], X[:, bb - 1, j],
                                      X[:, bb, jp], X[:, bb, jm],
                                      U[:, bb, j], U[:, bb - 1, j],
                                      U[:, bb, jm])
                    if kind == "hop":
                        bufs[dst][:, bb, j] = h
                        continue
                    v = a * bufs[self_][:, bb, j]
                    if kind == "combine":
                        v = v - c * h
                    bufs[dst][:, bb, j] = g5 * v

            if eo:
                run("hop", 1, 1, Rr + 6, "S", None, "T")
                run("combine", 0, 2, Rr + 4, "T", "S", "S", b)
                run("scale", 1, 2, Rr + 4, None, "S", "S")
                run("hop", 1, 3, Rr + 2, "S", None, "T")
                run("combine", 0, 4, Rr, "T", "S", "S", b)
                run("scale", 1, 4, Rr, None, "S", "S")
            else:
                for par in (0, 1):
                    run("combine", par, 3, Rr + 2, "S", "S", "T", 0.5)
                for par in (0, 1):
                    run("combine", par, 4, Rr, "T", "T", "S", 0.5)
            out[:, r0:r0 + Rr, :, c0:c0 + nc] = S[:, 4:Rr + 4, :, :nc]
    return out


def _plans(L):
    return [(C, tuple(r * L // C for r in range(C + 1)))
            for C in (1, 2, 4, 8) if L // C >= 2]


@pytest.mark.parametrize("L", [8, 16, 20, 64])
@pytest.mark.parametrize("layout", ["cf", "cl"])
@pytest.mark.parametrize("eo", [False, True])
def test_banded_mirror_reproduces_the_twins(L, layout, eo):
    """The mirror of op_kernel reproduces mdagm_plain (K9: tile 1) and
    mdagm_cl_plain (K10: tiles of 2, 4 and 8 chains over 5, the last
    ragged) to 1e-12 under every plan of C = 1, 2, 4, 8 bands of >= 2
    rows, halo rows wrapping across row L0 - 1 <-> 0."""
    B = 2 if layout == "cf" else 5
    theta, psi = _fields(11 + L, B=B, L0=L, L1=L, eo=eo)
    ur, ui = _links64(theta)
    p4 = fk.pack_spinor(torch.as_tensor(psi).to(torch.complex128))
    cl = (lambda t: t.permute(1, 2, 3, 0).contiguous())  # noqa: E731
    if layout == "cf":
        want, tiles = cl(fk.mdagm_plain(ur, ui, p4, MASS, eo)), (1,)
    else:
        want = fk.mdagm_cl_plain(cl(ur), cl(ui), cl(p4), MASS, eo)
        tiles = (2, 4, 8)
    for C, row0 in _plans(L):
        for tile in tiles:
            got = banded_op(cl(ur), cl(ui), cl(p4), MASS, eo, C, row0, tile)
            assert float((got - want).abs().max()) < 1e-12, (C, tile)


@pytest.mark.parametrize("L,B,tile", [(4, 1, 1), (8, 3, 1), (16, 64, 1),
                                      (16, 128, 1), (16, 128, 8),
                                      (16, 3, 8), (20, 3, 1), (64, 64, 1),
                                      (64, 1024, 1), (96, 2, 1),
                                      (32, 128, 32)])
def test_fermion_band_plan_covers_every_row_once(L, B, tile):
    """Every row in exactly one band, bands of >= 4 rows (the halo's
    depth) differing by at most one, C a power of two up to 8: the least
    that puts a CTA on every SM, or the most the rows allow."""
    C, row0 = fk.fermion_band_plan(L, B, N_SM, tile)
    assert C in (1, 2, 4, 8) and len(row0) == C + 1
    rows = [hi - lo for lo, hi in zip(row0, row0[1:])]
    assert sorted(i for lo, hi in zip(row0, row0[1:])
                  for i in range(lo, hi)) == list(range(L))
    assert min(rows) >= 4 and max(rows) - min(rows) <= 1
    groups = -(-B // tile)
    assert groups * C >= N_SM or 2 * C > min(8, L // 4)
    assert C == 1 or groups * C // 2 < N_SM


def test_fermion_band_plans_of_the_paths():
    """Path A (K9, 64^2, 64 chains), B (K10, 16^2, 128 chains) and C (the
    'auto' layout's operator at 16^2, 128 chains) on an H100's 132 SMs."""
    assert fk.fermion_band_plan(64, 64, N_SM) == (4, (0, 16, 32, 48, 64))
    assert fk.fermion_band_plan(16, 128, N_SM, fk.K10_TILE) == \
        (4, (0, 4, 8, 12, 16))
    assert fk.fermion_band_plan(16, 128, N_SM) == (2, (0, 8, 16))


def _band_bytes(L0, L1, C, rows, tile):
    """fermion_smem_bytes (csrc/fermion.cu): S and T, 4 planes of rows + 8
    rows, the links 4 planes of rows + 7, of L1 x tile floats, and 4 floats
    for the load's mbarrier."""
    ok = (L0 >= 4 and L1 >= 4 and L0 % 2 == 0 and L1 % 2 == 0
          and 1 <= C <= 8 and 1 <= rows <= L0 and rows * C >= L0
          and 1 <= tile <= 256 and tile & (tile - 1) == 0)
    return 4 * ((8 * (rows + 8) + 4 * (rows + 7)) * L1 * tile + 4) if ok \
        else -1


def test_operator_plan_takes_scratch_only_past_the_limit(monkeypatch):
    """operator_plan under an H100's SM count and shared-memory limit (the
    card's queries stubbed): the bands of every path's plan in shared
    memory, a band over the limit in scratch (one band a CTA), and plans
    the kernels do not take refused."""
    monkeypatch.setattr(_build, "sm_count", lambda index: N_SM)
    monkeypatch.setattr(_build, "smem_limit", lambda index: 232448)
    monkeypatch.setattr(fk, "_band_bytes", _band_bytes)
    dev = torch.device("cuda", 0)
    assert fk.operator_plan(False, 64, 64, 64, dev) == \
        (4, (0, 16, 32, 48, 64), 1, 0)
    assert fk.operator_plan(True, 128, 16, 16, dev)[2:] == (fk.K10_TILE, 0)
    assert fk.operator_plan(False, 2, 96, 96, dev)[3] == 0
    one = (1, (0, 96))                              # a 96-row band: 478 KB
    assert fk.operator_plan(False, 2, 96, 96, dev, one)[3] == \
        2 * ((8 * 104 + 4 * 103) * 96 + 4)
    assert fk.operator_plan(True, 5, 96, 96, dev, one, tile=4)[3] == \
        2 * ((8 * 104 + 4 * 103) * 96 * 4 + 4)
    for plan, tile in (((2, (0, 3, 7)), 1), ((2, (0, 8, 8)), 1),
                       ((3, (0, 4, 8)), 1), ((9, tuple(range(9)) + (8,)), 1),
                       ((2, (0, 4, 8)), 3)):
        with pytest.raises(ValueError, match="band plan"):
            fk.operator_plan(True, 4, 8, 8, dev, plan, tile)
