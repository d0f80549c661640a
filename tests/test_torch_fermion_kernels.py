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
    assert got.launched == got.iters


def test_cg_update_matches_the_jax_loop_body():
    """One update of K11's twin against the body of the JAX while_loop
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
        fk.cg_update_plain(tp, tmp, tx, tr, trsq, torch.as_tensor(stop),
                           counters, 6, chains_last)
        for got, ref in zip((back(tx), back(tr), back(tp), trsq.numpy()),
                            want):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        assert np.array_equal(back(tx)[1], x[1])      # frozen chain
        assert np.array_equal(back(tr)[1], r[1])
        assert np.array_equal(back(tp)[1], r[1])      # p = r + 0 p
        assert counters.tolist() == [7, 7]


def test_twin_iterations_are_jax_k_and_never_past_maxiter():
    """K11's twin stops at the first iteration after which no chain is
    active: its iters equal the JAX cg_solve_fused's k (interpret mode) at
    every maxiter up to convergence, never more than maxiter, and its x
    equals the JAX x under the cap."""
    theta, phi = _phi(6, B=5)
    args = (torch.as_tensor(theta), torch.as_tensor(phi), MASS)
    free = fk.cg_solve_fused_plain(*args, tol=1e-9, maxiter=200, eo=True)
    assert 10 < free.iters < 200 and free.launched == free.iters
    for maxiter in (0, 1, 7, free.iters):
        got = fk.cg_solve_fused_plain(*args, tol=1e-9, maxiter=maxiter,
                                      eo=True)
        want = pf.cg_solve_fused(jnp.asarray(theta), jnp.asarray(phi), MASS,
                                 tol=1e-9, maxiter=maxiter, eo=True,
                                 interpret=True)
        assert got.iters == int(want.iters) == maxiter
        if maxiter:
            assert _rel(got.x.numpy(), want.x) < 1e-4


def test_twin_freezes_converged_chains_bit_for_bit():
    """A chain that converges first keeps its x and rsq bit for bit while
    the others run on: its solution is the one of a solve capped at its own
    iterations."""
    theta, phi = _phi(9, B=4)
    theta[0] *= 0.2                       # a smoother chain: more iterations
    args = (torch.as_tensor(theta), torch.as_tensor(phi), MASS)
    alone = [fk.cg_solve_fused_plain(args[0][c:c + 1], args[1][c:c + 1],
                                     MASS, tol=1e-6, maxiter=300, eo=True)
             for c in range(4)]
    both = fk.cg_solve_fused_plain(*args, tol=1e-6, maxiter=300, eo=True)
    n = [r.iters for r in alone]
    assert both.iters == max(n) and min(n) < max(n)
    first = n.index(min(n))
    capped = fk.cg_solve_fused_plain(*args, tol=1e-6, maxiter=min(n),
                                     eo=True)
    assert torch.equal(both.x[first], capped.x[first])
    assert torch.equal(both.rsq[first], capped.rsq[first])


def test_twin_nan_stops_a_chain():
    """A chain whose b holds a NaN is never active (NaN > stop is false, as
    in JAX): the others' iterations and solutions are those without it."""
    theta, phi = _phi(8, B=3)
    args = (torch.as_tensor(theta), MASS)
    bad = torch.as_tensor(phi).clone()
    bad[1, 0, 0, 0] = float("nan")
    got = fk.cg_solve_fused_plain(args[0], bad, MASS, tol=1e-9, maxiter=300,
                                  eo=True)
    keep = [0, 2]
    ref = fk.cg_solve_fused_plain(args[0][keep], bad[keep], MASS, tol=1e-9,
                                  maxiter=300, eo=True)
    assert got.iters == ref.iters > 0
    assert torch.equal(got.x[keep], ref.x) and torch.isnan(got.rsq[1])


def test_eo_solve_refuses_odd_sites():
    """The fused CG's eo solve keeps the even sites only (K11's compact
    storage): a b or x0 that is not zero on an odd site is refused, on the
    CPU as on the card."""
    theta, phi = _phi(9, B=2)
    t, p = torch.as_tensor(theta), torch.as_tensor(phi)
    odd = p.clone()
    odd[0, 0, 1, 0] = 1.0
    with pytest.raises(ValueError, match="odd sites"):
        fk.cg_solve_fused(t, odd, MASS, tol=1e-9, maxiter=10, eo=True)
    with pytest.raises(ValueError, match="odd sites"):
        fk.cg_solve_fused(t, p, MASS, odd, tol=1e-9, maxiter=10, eo=True)
    fk.cg_solve_fused(t, odd, MASS, tol=1e-9, maxiter=10, eo=False)


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
    res = fk.cg_solve_fused(torch.as_tensor(theta), torch.as_tensor(psi),
                            MASS, tol=1e-9, maxiter=2, eo=False, layout="cf")
    assert res.iters == res.launched == 2
    plain = {k: _build.PLAIN_CALLS[k] - before[0][k] for k in before[0]}
    # the CG's twin: the initial residual and two iterations of K9's twin,
    # two updates
    assert plain == dict.fromkeys(_build.KERNELS, 0) | {"K9": 4, "K10": 1,
                                                        "K11": 2}
    assert dict(_build.LAUNCHES) == before[1]
    with pytest.raises(ValueError):                    # links vs planes
        fk.mdagm(ur[:, :1], ui[:, :1], p4, MASS, True)
    with pytest.raises(ValueError):                    # chains-last shapes
        fk.mdagm_cl(ur, ui, p4, MASS, True)
    rel, counters = torch.zeros(2), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="rel must be"):
        fk.cg_launch(False, ur, ui, p4, None, MASS, True, 1e-9, 10,
                     p4.clone(), rel, counters)
    with pytest.raises(ValueError, match="x and x0"):
        fk.cg_launch(False, ur, ui, p4, p4[:2], MASS, True, 1e-9, 10,
                     p4.clone(), torch.zeros(4), counters)


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
    # every entry of fermion.cu is bound, K11's whole solve among them
    fermion = (csrc / "fermion.cu").read_text()
    names = set(re.findall(r'extern "C" int (\w+)\(', fermion))
    assert names == set(_build._SIGNATURES["fermion"])
    assert {"k11_cg_solve", "cg_smem_bytes"} <= names
    assert "k11_cg_update" not in names


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
    and ub1 at n - e0 and n - e1 (ur0, ui0, ur1, ui1): its four planes, of
    torch tensors or numpy arrays."""
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
    return h0r, h0i, h1r, h1i


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
                        h = torch.stack(_hop_site(
                            X[:, bb + 1, j], X[:, bb - 1, j], X[:, bb, jp],
                            X[:, bb, jm], U[:, bb, j], U[:, bb - 1, j],
                            U[:, bb, jm]))
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


# ---------------------------------------------------------------------------
# K11's geometry (csrc/fermion.cu, cg_kernel), mirrored in float64 numpy: a
# chain split into C bands of rows, a CTA each; every set
# checkerboard-compact (planes, parity halves, rows, half-columns), eo
# keeping only the even sites
# of p, x and r; one band wrapping its rows around the lattice, bands in a
# cluster holding four halo rows a side of p, copied each iteration from
# the bands that own them; the passes of K9 on the compact sets; each sum a
# thread's sites in the order of its walk, a butterfly in the warp, the
# warps in order, the ranks in order. Rows a band never writes are NaN, so
# a site that reads one shows.
# ---------------------------------------------------------------------------

def _cg_threads(R, W):
    """cg_plan's threads: the power of two covering a band's sites of one
    parity, 32 to 1024."""
    n = 32
    while n < min(R * W, 1024):
        n *= 2
    return n


def _np_group_sum(parts, NT):
    """cg_sum over the CTAs of a chain: parts[r] (NT,) the threads'
    partials of rank r."""
    lanes = np.arange(32)
    total = 0.0
    for part in parts:
        v = part.reshape(-1, 32)             # warp w, lane
        o = 16
        while o >= 1:                        # butterfly in the warp
            v = v + v[:, lanes ^ o]
            o //= 2
        s = np.zeros(32)
        s[:v.shape[0]] = v[:, 0]             # lane w: warp w's sum
        o = 16
        while o >= 1:
            s = s + s[lanes ^ o]
            o //= 2
        total = total + s[0]                 # the ranks in order
    return total


def mirror_k11(layout, ur, ui, b, x0, mass, eo, tol, maxiter, C, row0):
    """K11's solve of numpy float64 planes in ``layout`` (links (B, 2, L0,
    L1) or (2, L0, L1, B), b and x0 (B, 4, L0, L1) or (4, L0, L1, B)) as
    cg_kernel runs it, chain by chain: (x, iters, live, rel, odd)."""
    cl = layout == "cl"
    B = b.shape[-1] if cl else b.shape[0]
    L0, L1 = (b.shape[1], b.shape[2]) if cl else (b.shape[2], b.shape[3])
    W, H = L1 // 2, 4 if C > 1 else 0
    rows = [hi - lo for lo, hi in zip(row0, row0[1:])]
    Rm = max(rows)
    NR = Rm + 2 * H
    NT = _cg_threads(Rm, W)
    # b in fp32, as the twins form it (b * even, an fp32 mask) and the
    # kernels take it
    a = mass + 2.0
    bq = float(np.float32(0.25 / a))
    npar = 1 if eo else 2
    nan = float("nan")
    rel = np.full(B, nan)
    iters = live = 0
    odd = False

    # the global planes as (plane, row, column, chain): the layout orders
    # the kernel's loads, not what they read
    def canon(arr):
        return arr if cl else arr.transpose(1, 2, 3, 0)

    spinor = {"b": canon(b), "x0": None if x0 is None else canon(x0)}
    links = np.stack([canon(ur)[0], canon(ui)[0], canon(ur)[1],
                      canon(ui)[1]])
    xc = np.full((4, L0, L1, B), nan)

    for c in range(B):
        cta = []
        for r in range(C):
            R, r0 = rows[r], row0[r]
            d = {"R": R, "r0": r0}
            for name, halves, nrow in (("U", 2, NR), ("P", npar, NR),
                                       ("Q", 2, NR), ("X", npar, Rm),
                                       ("Rr", npar, Rm)):
                d[name] = np.full((4, halves, nrow, W), nan)
            d["M"] = d["Q"] if eo else np.full((4, 2, Rm, W), nan)
            cta.append(d)

        def load(d, name, src, s_lo, g_lo, nr):
            nonlocal odd
            i = (g_lo + np.arange(nr)) % L0
            vals = src[:, i][..., c]
            arr = d[name]
            for par in range(2):
                cols = 2 * np.arange(W)[None, :] + (i[:, None] + par) % 2
                got = vals[:, np.arange(nr)[:, None], cols]
                if par and arr.shape[1] == 1:
                    odd |= bool((got != 0).any())
                    continue
                arr[:, par, s_lo:s_lo + nr] = got

        for d in cta:
            load(d, "U", links, 0, d["r0"] - H, d["R"] + 2 * H)
            load(d, "Rr", spinor["b"], 0, d["r0"], d["R"])
            if x0 is not None:
                load(d, "P", spinor["x0"], 0, d["r0"] - H, d["R"] + 2 * H)

        def half(d, name, par):
            arr = d[name]
            return arr[:, par if arr.shape[1] == 2 else 0]

        def cpass(d, kind, tp, lo, n, src, self_, dst, c, row0_self=0,
                  row0_dst=0):
            """A pass on rows [lo, lo + n): returns nothing; writes dst."""
            bb = np.arange(lo, lo + n)
            q = (d["r0"] - H + bb + tp) % 2
            up, dn = bb + 1, bb - 1
            if H == 0:
                up, dn = up % NR, dn % NR
            jh = np.arange(W)
            hf = (jh[None, :] + q[:, None]) % W
            hb = (jh[None, :] + q[:, None] - 1) % W
            S = half(d, src, 1 - tp)
            Us, Un = d["U"][:, tp], d["U"][:, 1 - tp]
            B_ = bb[:, None]
            h = np.stack(_hop_site(S[:, up][:, :, jh], S[:, dn][:, :, jh],
                                   S[:, B_, hf], S[:, B_, hb],
                                   Us[:, bb][:, :, jh], Un[:, dn][:, :, jh],
                                   Un[:, B_, hb]))
            D = half(d, dst, tp)
            if kind == "hop":
                D[:, bb - row0_dst] = h
            else:
                v = a * half(d, self_, tp)[:, bb - row0_self] - c * h
                v[2:] = -v[2:]
                D[:, bb - row0_dst] = v

        def apply(d):
            R = d["R"]
            lo = [H and i for i in range(5)]
            n = [R + 2 * (H - i) if H else NR for i in range(5)]
            if eo:
                cpass(d, "hop", 1, lo[1], n[1], "P", None, "Q", 0.0)
                cpass(d, "combine", 0, lo[2], n[2], "Q", "P", "Q", bq)
                cpass(d, "hop", 1, lo[3], n[3], "Q", None, "Q", 0.0)
                cpass(d, "combine", 0, H, R, "Q", "Q", "Q", bq)
            else:
                for tp in (0, 1):
                    cpass(d, "combine", tp, lo[3], n[3], "P", "P", "Q", 0.5)
                for tp in (0, 1):
                    cpass(d, "combine", tp, H, R, "Q", "Q", "M", 0.5,
                          row0_dst=H)

        def own(d, name, par):
            """(4, R, W) view of a set's own rows."""
            arr = half(d, name, par)
            off = 0 if name in ("X", "Rr") or (name == "M" and not eo) \
                else H
            return arr[:, off:off + d["R"]]

        def thread_sums(d, prods):
            """Each thread's sum over its sites in its walk's order: the
            items (parity, row, half-column) of each parity, item e the
            thread e % NT's, its four planes in turn."""
            acc = np.zeros(NT)
            for prod in prods:                    # (4, R, W) a parity
                flat = prod.reshape(4, -1)
                for m in range(0, flat.shape[1], NT):
                    seg = flat[:, m:m + NT]
                    for k in range(4):
                        acc[:seg.shape[1]] += seg[k]
            return acc

        if x0 is not None:
            for d in cta:
                apply(d)
        bsq_p, rsq_p = [], []
        for d in cta:
            bs, rs = [], []
            for par in range(npar):
                bv = own(d, "Rr", par).copy()
                if x0 is not None:
                    xv = own(d, "P", par).copy()
                    rv = bv - own(d, "M", par)
                else:
                    xv, rv = np.zeros_like(bv), bv
                own(d, "X", par)[...] = xv
                own(d, "Rr", par)[...] = rv
                own(d, "P", par)[...] = rv
                bs.append(bv * bv)
                rs.append(rv * rv)
            bsq_p.append(thread_sums(d, bs))
            rsq_p.append(thread_sums(d, rs))
        bsq = _np_group_sum(bsq_p, NT)
        rsq = _np_group_sum(rsq_p, NT)
        stop = tol * bsq
        act = rsq > stop
        it = 0
        while act and it < maxiter:
            if H:
                for d in cta:
                    R, r0 = d["R"], d["r0"]
                    for hr in range(2 * H):
                        db = hr if hr < H else R + hr
                        g = (r0 - H + db) % L0
                        o = max(i for i in range(C) if row0[i] <= g)
                        d["P"][:, :, db] = cta[o]["P"][:, :, H + g - row0[o]]
            dots = []
            for d in cta:
                apply(d)
                dots.append(thread_sums(d, [own(d, "P", par) * own(d, "M", par)
                                            for par in range(npar)]))
            denom = _np_group_sum(dots, NT)
            alpha = rsq / max(denom, 1e-30)
            rn_p = []
            for d in cta:
                rs = []
                for par in range(npar):
                    X, Rr = own(d, "X", par), own(d, "Rr", par)
                    P, M = own(d, "P", par), own(d, "M", par)
                    X += alpha * P
                    Rr -= alpha * M
                    rs.append(Rr * Rr)
                rn_p.append(thread_sums(d, rs))
            rn = _np_group_sum(rn_p, NT)
            nxt = rn > stop
            beta = rn / max(rsq, 1e-30)
            for d in cta:
                for par in range(npar):
                    P, Rr = own(d, "P", par), own(d, "Rr", par)
                    P[...] = Rr + beta * P
            rsq = rn
            it += 1
            iters = max(iters, it)
            if nxt:
                live = max(live, it)
            act = nxt
        for d in cta:
            i = d["r0"] + np.arange(d["R"])
            for par in range(2):
                cols = 2 * np.arange(W)[None, :] + (i[:, None] + par) % 2
                v = (np.zeros((4, d["R"], W)) if par and npar == 1
                     else half(d, "X", par)[:, :d["R"]])
                xc[:, i[:, None], cols, c] = v
        rel[c] = rsq / max(bsq, 1e-30)
    x = xc if cl else xc.transpose(3, 0, 1, 2)
    return x, iters, live, rel, odd


@pytest.mark.parametrize("L", [4, 8, 16, 64])
@pytest.mark.parametrize("layout", ["cf", "cl"])
@pytest.mark.parametrize("eo", [False, True])
def test_k11_mirror_reproduces_the_twin(L, layout, eo):
    """The mirror of cg_kernel reproduces cg_planes_plain in float64 to
    1e-12 (relative to max|x|) with the same iterations, cold and warm,
    under every plan of C = 1, 2, 4, 8 bands of >= 2 rows (halo rows from
    up to three bands a side, wrapping), over 3 chains in both layouts; no
    odd site flagged. At 64^2 the plans are mirrored on cold starts, to
    keep the test short."""
    B = 3
    theta, psi = _fields(40 + L, B=B, L0=L, L1=L, eo=eo)
    _, guess = _fields(80 + L, B=B, L0=L, L1=L, eo=eo)
    ur, ui = _links64(theta)
    b4 = fk.pack_spinor(torch.as_tensor(psi).to(torch.complex128))
    x04 = fk.pack_spinor(torch.as_tensor(guess).to(torch.complex128)) * 0.1
    cl = (lambda t: t.permute(1, 2, 3, 0).contiguous())  # noqa: E731
    if layout == "cl":
        ur, ui, b4, x04 = cl(ur), cl(ui), cl(b4), cl(x04)
    tol, maxiter = 1e-14, 200
    starts = (None,) if L == 64 else (None, x04)
    for x0 in starts:
        want, k, rsq, bsq = fk.cg_planes_plain(ur, ui, b4, x0, MASS, tol,
                                               maxiter, eo, layout == "cl")
        want = want.numpy()
        assert 5 < k < maxiter
        for C, row0 in _plans(L):
            got, iters, live, rel, odd = mirror_k11(
                layout, ur.numpy(), ui.numpy(), b4.numpy(),
                None if x0 is None else x0.numpy(), MASS, eo, tol, maxiter,
                C, row0)
            err = float(np.abs(got - want).max() / np.abs(want).max())
            assert err < 1e-12 and iters == k, (C, err, iters, k)
            assert live == k - 1 and not odd
            np.testing.assert_allclose(rel, (rsq / bsq).numpy(), rtol=1e-6)


def test_k11_mirror_flags_odd_sites_and_caps():
    """The mirror flags an eo b that is not zero on an odd site, and stops
    at maxiter with live == iters (a chain still active)."""
    theta, psi = _fields(91, B=2, L0=8, L1=8, eo=False)
    ur, ui = _links64(theta)
    b4 = fk.pack_spinor(torch.as_tensor(psi).to(torch.complex128)).numpy()
    *_, odd = mirror_k11("cf", ur.numpy(), ui.numpy(), b4, None, MASS, True,
                         1e-14, 0, 1, (0, 8))
    assert odd
    even = fk.parity_masks(8, 8, 0, "cpu")[0].double().numpy()
    x, iters, live, _, odd = mirror_k11("cf", ur.numpy(), ui.numpy(),
                                        b4 * even, None, MASS, True, 1e-14,
                                        3, 2, (0, 4, 8))
    assert (iters, live, odd) == (3, 3, False)
    want = fk.cg_planes_plain(ur, ui, torch.as_tensor(b4 * even), None, MASS,
                              1e-14, 3, True, False)[0].numpy()
    assert float(np.abs(x - want).max()) < 1e-12 * float(np.abs(want).max())


def _np_cg_bytes(L0, L1, C, rows, eo, in_smem, bf16=False):
    """cg_smem_bytes (csrc/fermion.cu, CgLayout): eo 20 half planes of the
    band's rows and 8 of the own rows, not eo 24 and 24, of L1 / 2
    elements (4 bytes, or 2 for K11_bf16, rounded up to a float), and the
    reduction area (64 + 2 + 16 floats)."""
    ok = (L0 >= 4 and L1 >= 4 and L0 % 2 == 0 and L1 % 2 == 0
          and 1 <= C <= 8 and 1 <= rows <= L0 and rows * C >= L0)
    if not ok:
        return -1
    H = 4 if C > 1 else 0
    rs = L1 // 2
    hs, os_ = (rows + 2 * H) * rs, rows * rs
    band = 20 * hs + 8 * os_ if eo else 24 * hs + 24 * os_
    red = 64 + 2 + 16
    if bf16:
        band = -(-band // 2)
    return 4 * (band + red) if in_smem else 4 * red


@pytest.fixture
def h100(monkeypatch):
    """The card's queries of an H100 (132 SMs, 227 KB of shared memory a
    block), and cg_smem_bytes's count, stubbed."""
    monkeypatch.setattr(_build, "sm_count", lambda index: N_SM)
    monkeypatch.setattr(_build, "smem_limit", lambda index: 232448)
    monkeypatch.setattr(fk, "_cg_bytes", _np_cg_bytes)
    return torch.device("cuda", 0)


def test_cg_plan_covers_every_even_side(h100):
    """Every even L from 4 to 256 at B = 1, 16, 64, 128 gets a K11 plan, in
    shared memory or (from 256^2 eo, 192^2 not eo) in scratch: bands that
    partition the rows, threads a power of two covering a band's row
    sites; odd or tiny sides, and plans the kernel does not take, raise
    naming the envelope."""
    for L in range(4, 257, 2):
        for B in (1, 16, 64, 128):
            for eo in (False, True):
                pl = fk.cg_plan(eo, B, L, L, h100)
                rows = [hi - lo for lo, hi in zip(pl.row0, pl.row0[1:])]
                assert pl.row0[0] == 0 and pl.row0[-1] == L
                assert min(rows) >= 1 and len(rows) == pl.C <= 8
                assert 32 <= pl.threads <= 1024
                need = _np_cg_bytes(L, L, pl.C, max(rows), eo, True)
                if pl.scratch:
                    red = _np_cg_bytes(L, L, pl.C, max(rows), eo, False)
                    assert need > 232448
                    assert pl.scratch == B * pl.C * (need - red) // 4
                else:
                    assert need <= 232448
    for L0, L1 in ((7, 8), (8, 9), (2, 8), (257, 256)):
        with pytest.raises(ValueError, match="even sides >= 4"):
            fk.cg_plan(True, 4, L0, L1, h100)
    for plan in ((2, (0, 3, 7)), (3, (0, 4, 8)), (9, tuple(range(9)) + (8,))):
        with pytest.raises(ValueError, match="band plan"):
            fk.cg_plan(True, 4, 8, 8, h100, plan=plan)


def test_cg_plans_of_the_paths(h100):
    """Path A (64^2, 64 chains, eo): one CTA a chain in shared memory;
    paths B and C (16^2, 128 chains, either layout): one CTA a chain;
    128^2 in shared memory in a cluster, 256^2 in scratch."""
    A = fk.cg_plan(True, 64, 64, 64, h100)
    assert A == fk.CGPlan(1, (0, 64), 1024, 0)
    assert fk.cg_plan(True, 128, 16, 16, h100) == \
        fk.CGPlan(1, (0, 16), 128, 0)
    big = fk.cg_plan(True, 4, 128, 128, h100)
    assert big.C > 1 and big.scratch == 0
    assert fk.cg_plan(True, 4, 256, 256, h100).scratch > 0


@pytest.mark.parametrize("L,eo,fp32,bf16", [
    (64, True, (1, False), (1, False)), (64, False, (2, False), (1, False)),
    (128, True, (8, False), (4, False)), (128, False, (8, True), (4, False)),
    (256, True, (8, True), (8, True)), (256, False, (8, True), (8, True))])
def test_cg_plan_of_bf16_storage(h100, L, eo, fp32, bf16):
    """K11_bf16's region takes half the bytes, so its plan may need fewer
    bands, or none in scratch (the plans an H100 ran, PERF.md):
    (bands, in scratch) of fp32 K11 and of K11_bf16 at 4 chains; where
    both run from scratch, the bf16 scratch is half the floats."""
    p32 = fk.cg_plan(eo, 4, L, L, h100)
    p16 = fk.cg_plan(eo, 4, L, L, h100, bf16=True)
    assert (p32.C, bool(p32.scratch)) == fp32
    assert (p16.C, bool(p16.scratch)) == bf16
    if p32.scratch and p16.scratch:
        assert p16.scratch == p32.scratch // 2
