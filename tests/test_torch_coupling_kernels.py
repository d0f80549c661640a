"""Plain twins of K6, K7 and K8 against fthmc_tpu's XLA coupling layer,
and what surrounds the kernels: their band plan, weight packing and a
banded mirror of their halo and wrap indexing.

The JAX side is the plain reference (link_coupling_forward and jax.vjp of
it), never interpret-mode Pallas. Float64, bound 1e-10: the twins and the
reference do the same arithmetic in another order (roundoff ~1e-13); K8's
twin is a hand-derived chain rule held against JAX autodiff."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.models import coupling as jc
from fthmc_tpu.models import masks as jm
from fthmc_tpu.ops import conv as jconv
from fthmc_tpu_torch.config import FlowSpec as TSpec
from fthmc_tpu_torch.models.coupling import (_masks, plaq_of_links,
                                             stack_cos_sin)
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.conv import ACTIVATIONS
from fthmc_tpu_torch.ops.coupling_kernels import (MAX_BANDS, band_plan,
                                                  coupling_forward,
                                                  kernel_fits,
                                                  kernel_flow_forward,
                                                  pack_conv, stripe_items)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (ACT_GRADS,
                                                      coupling_bwd,
                                                      coupling_bwd_plain,
                                                      coupling_fwd_res,
                                                      coupling_fwd_res_plain,
                                                      transform_bwd_plain)
from fthmc_tpu_torch.weights import flow_params_from_numpy

TOL = 1e-10
PI = math.pi


def np_layer(kw, seed, s_bias=0.0):
    """One coupling layer's conv parameters (float64 numpy); ``s_bias`` is
    added to the log-scale channels' bias, +s_bias on the first half of
    the components and -s_bias on the rest."""
    rng = np.random.default_rng(seed)
    M = kw["n_mixture"]
    out = 2 * M + 1 if kw["coupling"] == "rncp" else M + 1
    sizes = (2, *kw["hidden_sizes"], out)
    net = []
    for ci, co in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / math.sqrt(9 * ci)
        net.append({"w": rng.uniform(-bound, bound, (co, ci, 3, 3)),
                    "b": rng.uniform(-bound, bound, (co,))})
    net[-1]["b"][:M] += np.where(np.arange(M) < M // 2 + 1, s_bias, -s_bias)
    return net


def case(kw, seed=0, s_bias=0.0, B=6, L=8):
    net = np_layer(kw, seed, s_bias)
    rng = np.random.default_rng(seed + 100)
    x = rng.uniform(-PI, PI, (B, 2, L, L))
    gy = rng.normal(size=x.shape)
    gl = rng.normal(size=(B,))
    tspec = TSpec(n_layers=1, **kw)
    tnet = flow_params_from_numpy([net], tspec, device="cpu",
                                  dtype=torch.float64)[0]
    return net, x, gy, gl, JSpec(n_layers=1, **kw), tspec, tnet


def wrapped_diff(a, b):
    return np.abs(np.remainder(np.asarray(a) - np.asarray(b) + PI, 2 * PI)
                  - PI).max()


SPECS = [
    dict(coupling="ncp", n_mixture=2, hidden_sizes=(8,), s_clip=None),
    dict(coupling="ncp", n_mixture=3, hidden_sizes=(8, 8), s_clip=3.0),
    dict(coupling="rncp", n_mixture=4, hidden_sizes=(4,), s_clip=3.0),
    dict(coupling="rncp", n_mixture=2, hidden_sizes=(8, 8), s_clip=None,
         activation="tanh"),
]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("mu,off", [(0, 1), (1, 2)])
def test_k6_plain_matches_link_coupling_forward(kw, mu, off):
    net, x, _, _, jspec, tspec, tnet = case(kw)
    with jax.enable_x64():
        out = jc.link_coupling_forward(jax.tree.map(jnp.asarray, net),
                                       jnp.asarray(x), mu, off, jspec)
        ref_x, ref_l = np.asarray(out.x), np.asarray(out.logJ)
    before = _build.PLAIN_CALLS["K6"]
    fx, lj = coupling_forward(tnet, torch.as_tensor(x), mu, off, tspec)
    assert _build.PLAIN_CALLS["K6"] == before + 1
    assert wrapped_diff(fx.numpy(), ref_x) < TOL
    np.testing.assert_allclose(lj.numpy(), ref_l, rtol=0, atol=TOL)


def _jax_preacts(net, x, mu, off, activation):
    L = x.shape[-1]
    frozen = jnp.asarray(jm.plaq_masks((L, L), mu, off)[0], x.dtype)
    h = jc.stack_cos_sin(frozen * jc._plaq_of_links(x))
    pre = []
    for p in net:
        h = jconv.circular_conv2d(
            h if not pre else jconv.ACTIVATIONS[activation](pre[-1]),
            p["w"], p["b"])
        pre.append(h)
    return pre


def _check_last_residual(last, ref, mu, off):
    """K7's residual of the last conv: JAX's pre-activation on the active
    stripe, exactly 0 elsewhere."""
    active = jm.plaq_masks(ref.shape[-2:], mu, off)[1].astype(bool)
    np.testing.assert_allclose(last[..., active], ref[..., active], rtol=0,
                               atol=TOL)
    assert np.all(last[..., ~active] == 0.0)


@pytest.mark.parametrize("kw", SPECS)
def test_k7_plain_matches_forward_and_conv_intermediates(kw):
    mu, off = 1, 3
    net, x, _, _, jspec, tspec, tnet = case(kw, seed=1)
    with jax.enable_x64():
        jnet = jax.tree.map(jnp.asarray, net)
        out = jc.link_coupling_forward(jnet, jnp.asarray(x), mu, off, jspec)
        ref_x, ref_l = np.asarray(out.x), np.asarray(out.logJ)
        ref_res = [np.asarray(r) for r in _jax_preacts(
            jnet, jnp.asarray(x), mu, off, tspec.activation)]
    fx, lj, res = coupling_fwd_res(tnet, torch.as_tensor(x), mu, off, tspec)
    assert wrapped_diff(fx.numpy(), ref_x) < TOL
    np.testing.assert_allclose(lj.numpy(), ref_l, rtol=0, atol=TOL)
    assert len(res) == len(ref_res)
    for r, rr in zip(res[:-1], ref_res[:-1]):
        np.testing.assert_allclose(r.numpy(), rr, rtol=0, atol=TOL)
    _check_last_residual(res[-1].numpy(), ref_res[-1], mu, off)


LAST_RES_SPECS = [
    dict(coupling="ncp", n_mixture=3, hidden_sizes=(8,), s_clip=None),
    dict(coupling="rncp", n_mixture=2, hidden_sizes=(4, 4), s_clip=3.0,
         activation="tanh"),
    dict(coupling="rncp", n_mixture=2, hidden_sizes=(), s_clip=3.0),
]


@pytest.mark.parametrize("kw", LAST_RES_SPECS,
                         ids=["ncp", "rncp", "one_conv"])
@pytest.mark.parametrize("mu,off", [(m, o) for o in range(4)
                                    for m in (0, 1)])
def test_last_residual_is_the_stripe_preactivation(kw, mu, off):
    """The twin and the banded mirror (ragged bands of 2 and 3 rows, some
    with no active row) keep the last conv's pre-activation on the active
    stripe and 0 elsewhere."""
    L, B = 20, 3
    net, x, gy, gl, _, tspec, tnet = case(kw, seed=11, B=B, L=L)
    with jax.enable_x64():
        ref = np.asarray(_jax_preacts(jax.tree.map(jnp.asarray, net),
                                      jnp.asarray(x), mu, off,
                                      tspec.activation)[-1])
    xt = torch.as_tensor(x)
    _, _, res = coupling_fwd_res_plain(tnet, xt, mu, off, tspec)
    _check_last_residual(res[-1].numpy(), ref, mu, off)
    C, row0 = band_plan(L, B, N_SM)
    res_b, _ = banded_layer(tnet, xt, torch.as_tensor(gy),
                            torch.as_tensor(gl), mu, off, tspec, C, row0)
    _check_last_residual(res_b[-1].numpy(), ref, mu, off)


def _vjp_case(kw, mu, off, seed=2, s_bias=0.0):
    net, x, gy, gl, jspec, tspec, tnet = case(kw, seed=seed, s_bias=s_bias)
    with jax.enable_x64():
        jnet = jax.tree.map(jnp.asarray, net)
        out, vjp = jax.vjp(lambda xx: jc.link_coupling_forward(
            jnet, xx, mu, off, jspec), jnp.asarray(x))
        (ref,) = vjp(jc.CouplingOut(x=jnp.asarray(gy), logJ=jnp.asarray(gl)))
        ref = np.asarray(ref)
        raw = np.asarray(_jax_preacts(jnet, jnp.asarray(x), mu, off,
                                      tspec.activation)[-1])
    xt = torch.as_tensor(x)
    _, _, res = coupling_fwd_res(tnet, xt, mu, off, tspec)
    gx = coupling_bwd(tnet, xt, res, torch.as_tensor(gy),
                      torch.as_tensor(gl), mu, off, tspec)
    return gx.numpy(), ref, raw


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("mu,off", [(0, 0), (1, 2)])
def test_k8_plain_matches_jax_vjp(kw, mu, off):
    gx, ref, _ = _vjp_case(kw, mu, off)
    np.testing.assert_allclose(gx, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("coupling", ["ncp", "rncp"])
def test_k8_plain_hard_clip_gradient(coupling):
    """|s| > 30 on active sites: the value path's hard clip has zero
    gradient there, while logJ keeps its (detached-|s|) slope."""
    kw = dict(coupling=coupling, n_mixture=2, hidden_sizes=(4,),
              s_clip=None)
    gx, ref, raw = _vjp_case(kw, 0, 1, seed=3, s_bias=40.0)
    assert (np.abs(raw[:, :2]) > 30).mean() > 0.9
    np.testing.assert_allclose(gx, ref, rtol=0, atol=TOL)


FLAGSHIP = TSpec(n_layers=24, coupling="rncp", n_mixture=8,
                 hidden_sizes=(32, 32), s_clip=3.0)


def test_kernel_envelope():
    # the flagship's shapes and the JAX package's envelope (L <= 8 or
    # B <= 128) at L a multiple of 4
    assert kernel_fits(FLAGSHIP, 16, 64)
    for B in (1, 32, 128):
        assert kernel_fits(FLAGSHIP, 64, B)
    assert kernel_fits(FLAGSHIP, 8, 4096)
    small = TSpec(n_layers=1, n_mixture=6, hidden_sizes=(8, 8))
    for L in (4, 8, 12, 16, 20, 32, 64):
        assert kernel_fits(small, L, 128)
    assert kernel_fits(small, 8, 1024)
    # loudly outside: spline, bf16, L not a multiple of 4, other kernel
    # sizes and activations
    assert not kernel_fits(TSpec(n_layers=1, coupling="spline"), 8, 64)
    assert not kernel_fits(TSpec(n_layers=1, conv_dtype="bfloat16"), 8, 64)
    assert not kernel_fits(small, 6, 64)
    assert not kernel_fits(TSpec(n_layers=1, kernel_size=5), 8, 64)
    assert not kernel_fits(TSpec(n_layers=1, activation="gelu"), 8, 64)
    # width and depth are the card's shared memory to judge, at launch
    # (tests/test_torch_cuda.py); the plain twins take any
    assert kernel_fits(TSpec(n_layers=1, hidden_sizes=(128, 128)), 16, 64)


def test_kernel_wrappers_refuse_other_devices():
    kw = dict(coupling="rncp", n_mixture=2, hidden_sizes=(4,), s_clip=3.0)
    _, _, _, _, _, tspec, tnet = case(kw)
    meta = torch.empty((2, 2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        coupling_forward(tnet, meta, 0, 0, tspec)
    with pytest.raises(ValueError):
        coupling_fwd_res(tnet, meta, 0, 0, tspec)
    with pytest.raises(ValueError):
        coupling_bwd(tnet, meta, (), meta, meta[:, 0, 0, 0], 0, 0, tspec)


def test_kernel_flow_forward_plain_chain():
    """kernel_flow_forward on the CPU is the stack of K6 twins: it equals
    the differentiable flow."""
    from fthmc_tpu_torch.models.flow import flow_forward
    spec = TSpec(n_layers=3, coupling="rncp", n_mixture=2,
                 hidden_sizes=(4,), s_clip=3.0)
    tree = [np_layer(dict(coupling="rncp", n_mixture=2, hidden_sizes=(4,)),
                     s) for s in range(3)]
    params = flow_params_from_numpy(tree, spec, device="cpu",
                                    dtype=torch.float64)
    z = torch.as_tensor(np.random.default_rng(9).uniform(-PI, PI,
                                                         (4, 2, 8, 8)))
    y, ld = kernel_flow_forward(params, z, spec)
    y_ref, ld_ref = flow_forward(params, z, spec)
    assert wrapped_diff(y.numpy(), y_ref.detach().numpy()) < TOL
    np.testing.assert_allclose(ld.numpy(), ld_ref.detach().numpy(),
                               atol=TOL)


# ---------------------------------------------------------------------------
# The band geometry of K6/K7/K8 (csrc/coupling_common.cuh): a cluster of C
# CTAs a chain, CTA r owning rows [row0[r], row0[r + 1]), the planes of a
# band holding its rows, a halo row above and below and the column images
# (column j at index j + 4, j = -1 and j = L at 3 and L + 4). The plan is
# chosen in Python; the mirror below repeats the kernels' halo and wrap
# indexing in float64 and must reproduce the twins to 1e-12 (the same sums
# in another order).
# ---------------------------------------------------------------------------

N_SM = 132                                   # H100 SXM


@pytest.mark.parametrize("L", [4, 8, 12, 16, 20, 24, 32, 36, 64, 128])
@pytest.mark.parametrize("B", [1, 3, 8, 64, 128, 1024])
def test_band_plan_covers_every_row_once(L, B):
    C, row0 = band_plan(L, B, N_SM)
    assert 1 <= C <= MAX_BANDS and C & (C - 1) == 0     # a power of two
    assert len(row0) == C + 1 and row0[0] == 0 and row0[-1] == L
    rows = [b - a for a, b in zip(row0, row0[1:])]
    assert sum(rows) == L and max(rows) - min(rows) <= 1
    covered = sorted(i for a, b in zip(row0, row0[1:]) for i in range(a, b))
    assert covered == list(range(L))
    assert min(rows) >= 2
    # 8-row bands, split further only while B x C is under half the SMs
    if C > 1 and 8 * C > L:
        assert B * (C // 2) < N_SM // 2


def test_band_plans_of_the_paths():
    # (B, L) -> (C, rows): the flagship, path C, 32 chains at 16^2, 64^2,
    # ragged 20^2, 8^2, 4^2
    assert band_plan(16, 64, N_SM) == (2, (0, 8, 16))
    assert band_plan(16, 128, N_SM) == (2, (0, 8, 16))
    assert band_plan(16, 32, N_SM) == (4, (0, 4, 8, 12, 16))
    assert band_plan(64, 8, N_SM) == (8, tuple(range(0, 65, 8)))
    assert band_plan(20, 3, N_SM) == (8, (0, 2, 5, 7, 10, 12, 15, 17, 20))
    assert band_plan(8, 4, N_SM) == (4, (0, 2, 4, 6, 8))
    assert band_plan(4, 4096, N_SM) == (1, (0, 4))


COL0 = 4


def _band_conv(w, b, band, R):
    """One band's conv, as conv_band indexes it: out[o](r, j) = b[o] +
    sum w[o][c][dy][dx] * in[c](plane row r + dy, index COL0 - 1 + j + dx)
    for the R own rows r (plane rows r + 1)."""
    L = band.shape[-1] - 8
    out = b[None, :, None, None].expand(band.shape[0], -1, R, L).clone()
    for dy in range(3):
        for dx in range(3):
            win = band[:, :, dy:dy + R, COL0 - 1 + dx:COL0 - 1 + dx + L]
            out = out + torch.einsum("oc,bcrj->borj", w[:, :, dy, dx], win)
    return out


def _planes(B, ch, R, L, dtype):
    return torch.full((B, ch, R + 2, L + 8), float("nan"), dtype=dtype)


def _land(plane, v):
    """Write v (B, ch, R, L) as a band's own rows with its column images."""
    R, L = v.shape[2], v.shape[3]
    plane[:, :v.shape[1], 1:R + 1, COL0:COL0 + L] = v
    plane[:, :v.shape[1], 1:R + 1, COL0 - 1] = v[..., L - 1]
    plane[:, :v.shape[1], 1:R + 1, COL0 + L] = v[..., 0]


def _exchange(planes, row0, ch):
    """exchange_halos: row 0 from the band above's last own row, row R + 1
    from the band below's first, whole padded rows, C - 1 <-> 0 wrapping."""
    C = len(planes)
    rows = [b - a for a, b in zip(row0, row0[1:])]
    for r in range(C):
        up, dn = (r - 1) % C, (r + 1) % C
        planes[r][:, :ch, 0] = planes[up][:, :ch, rows[up]]
        planes[r][:, :ch, rows[r] + 1] = planes[dn][:, :ch, 1]


def _stripe_plane(pre, r0, mu, off):
    """The last conv's output planes of a band as K6/K7 leave them: pre at
    the sites of its items (``stripe_items``; a site at or past L is the
    item's repeat, not stored), NaN elsewhere."""
    R, L = pre.shape[2], pre.shape[3]
    out = torch.full_like(pre, float("nan"))
    nrows, r_first, r_step, ngroups, j_first, step = stripe_items(
        r0, R, L, mu, off)
    for k in range(nrows):
        r = r_first + k * r_step
        for g in range(ngroups):
            for s in range(4):
                j = j_first + (4 * g + s) * step
                if j < L:
                    out[:, :, r, j] = pre[:, :, r, j]
    return out


def _band_conv_from_stripe(w, band, R, r0, mu, off):
    """K8's first transposed conv of a band: at each site only the taps
    whose input site is on the active stripe (mu = 1: tap row dy =
    off - i + 1 mod 4, none where that is 3; mu = 0: tap column dx =
    off + 1 - j mod 4), so what lies off the stripe is never read."""
    L = band.shape[-1] - 8
    i = torch.arange(r0, r0 + R)[:, None]
    j = torch.arange(L)[None, :]
    out = torch.zeros((band.shape[0], w.shape[0], R, L), dtype=band.dtype)
    for dy in range(3):
        for dx in range(3):
            take = ((off - i + 1) % 4 == dy) if mu == 1 else \
                ((off + 1 - j) % 4 == dx)
            win = band[:, :, dy:dy + R, COL0 - 1 + dx:COL0 - 1 + dx + L]
            term = torch.einsum("oc,bcrj->borj", w[:, :, dy, dx], win)
            out = out + torch.where(take.expand(R, L), term, 0.0)
    return out


def banded_layer(layer, x, gy, gl, mu, off, spec, C, row0):
    """The forward chain (K7's residuals) and the input cotangent (K8) of
    one coupling layer, band by band as the kernels compute them: the last
    conv on its items' sites, K7's residual of it the active stripe of
    those planes (0 elsewhere), K8's first transposed conv on the taps that
    reach the stripe, its input NaN off the stripe."""
    B, _, L, _ = x.shape
    act, act_grad = ACTIVATIONS[spec.activation], ACT_GRADS[spec.activation]
    frozen, active = _masks((L, L), mu, off, x.dtype, x.device)[:2]
    plaq = plaq_of_links(x)
    feat = stack_cos_sin(frozen * plaq)
    rows = [b - a for a, b in zip(row0, row0[1:])]
    R = max(rows)
    widths = [2] + [int(p["w"].shape[0]) for p in layer]
    cmax = max(widths)
    # conv 0's input: own rows, halo rows and images computed by the band
    planes = []
    for r in range(C):
        p = _planes(B, cmax, R, L, x.dtype)
        idx = [(row0[r] + k - 1) % L for k in range(rows[r] + 2)]
        cols = [(j - 1) % L for j in range(L + 2)]
        p[:, :2, :rows[r] + 2, COL0 - 1:COL0 + L + 1] = \
            feat[:, :, idx][:, :, :, cols]
        planes.append(p)
    res = [torch.empty((B, c, L, L), dtype=x.dtype) for c in widths[1:]]
    for li, prm in enumerate(layer):
        if li > 0:
            _exchange(planes, row0, widths[li])
        nxt = [_planes(B, cmax, R, L, x.dtype) for _ in range(C)]
        for r in range(C):
            band = slice(row0[r], row0[r + 1])
            pre = _band_conv(prm["w"], prm["b"], planes[r][:, :widths[li]],
                             rows[r])
            if li < len(layer) - 1:
                res[li][:, :, band] = pre
                _land(nxt[r], act(pre))
            else:
                raw = _stripe_plane(pre, row0[r], mu, off)
                res[li][:, :, band] = torch.where(active[band] > 0, raw, 0.0)
        planes = nxt
    # K8: stage A per site (its cotangents NaN off the active stripe: never
    # read), the transposed chain band by band, stage C
    g, g_p = transform_bwd_plain(x, res[-1], gy, gl, mu, off, spec)
    g = torch.where(active > 0, g, float("nan"))
    planes = [_planes(B, cmax, R, L, x.dtype) for _ in range(C)]
    for r in range(C):
        _land(planes[r], g[:, :, row0[r]:row0[r + 1]])
    for li in range(len(layer) - 1, -1, -1):
        _exchange(planes, row0, widths[li + 1])
        wt = layer[li]["w"].flip(2, 3).transpose(0, 1)
        zero = torch.zeros(widths[li], dtype=x.dtype)
        nxt = [_planes(B, cmax, R, L, x.dtype) for _ in range(C)]
        for r in range(C):
            band = slice(row0[r], row0[r + 1])
            gin = planes[r][:, :widths[li + 1]]
            gc = _band_conv_from_stripe(wt, gin, rows[r], row0[r], mu, off) \
                if li == len(layer) - 1 else \
                _band_conv(wt, zero, gin, rows[r])
            if li > 0:
                _land(nxt[r], gc * act_grad(res[li - 1][:, :, band]))
            else:
                x2 = (frozen * plaq)[:, band]
                g_p[:, band] += frozen[band] * (-torch.sin(x2) * gc[:, 0]
                                                + torch.cos(x2) * gc[:, 1])
        planes = nxt
    # stage C: a band's rows and, above them, the band above's last row
    gx = torch.empty_like(x)
    for r in range(C):
        up, band = (r - 1) % C, slice(row0[r], row0[r + 1])
        rows_gp = torch.cat([g_p[:, row0[up + 1] - 1:row0[up + 1]],
                             g_p[:, band]], dim=1)
        own = rows_gp[:, 1:]
        gx[:, 0, band] = gy[:, 0, band] + own - torch.roll(own, 1, dims=2)
        gx[:, 1, band] = gy[:, 1, band] + rows_gp[:, :-1] - own
    return res, gx


@pytest.mark.parametrize("L,B", [(8, 2), (16, 2), (16, 64), (20, 3),
                                 (64, 2)])
def test_banded_mirror_reproduces_the_twins(L, B):
    kw = dict(coupling="rncp", n_mixture=2, hidden_sizes=(4, 4), s_clip=3.0,
              activation="tanh")
    _, x, gy, gl, _, tspec, tnet = case(kw, seed=5, B=B, L=L)
    xt, gyt, glt = (torch.as_tensor(a) for a in (x, gy, gl))
    C, row0 = band_plan(L, B, N_SM)
    for mu, off in [(m, o) for o in range(4) for m in (0, 1)]:
        res, gx = banded_layer(tnet, xt, gyt, glt, mu, off, tspec, C, row0)
        _, _, res_p = coupling_fwd_res_plain(tnet, xt, mu, off, tspec)
        gx_p = coupling_bwd_plain(tnet, xt, res_p, gyt, glt, mu, off, tspec)
        for r, r_p in zip(res, res_p):
            assert float((r - r_p).abs().max()) < 1e-12
        assert float((gx - gx_p).abs().max()) < 1e-12


@pytest.mark.parametrize("co,ci", [(32, 32), (17, 32), (32, 2), (3, 5)])
def test_pack_conv_is_the_staging_order(co, ci):
    """pack_conv lays a conv out as the kernels stage it: element
    (c * 9 + t) * cpad + o, then cpad biases; transposed w[c][o][8 - t]."""
    g = torch.Generator().manual_seed(co * 100 + ci)
    w = torch.randn((co, ci, 3, 3), generator=g, dtype=torch.float64)
    b = torch.randn((co,), generator=g, dtype=torch.float64)
    for transposed in (False, True):
        p = pack_conv(w, None if transposed else b)
        rin, rout = (co, ci) if transposed else (ci, co)
        cpad = -(-rout // 4) * 4
        assert p.shape == ((rin * 9 + 1) * cpad,)
        for c in range(rin):
            for t in range(9):
                for o in range(cpad):
                    got = float(p[(c * 9 + t) * cpad + o])
                    if o >= rout:
                        want = 0.0
                    elif transposed:
                        want = float(w[c, o].reshape(9)[8 - t])
                    else:
                        want = float(w[o, c].reshape(9)[t])
                    assert got == want
        bias = p[rin * 9 * cpad:]
        want_b = torch.zeros(cpad, dtype=torch.float64)
        if not transposed:
            want_b[:co] = b
        assert torch.equal(bias, want_b)


# ---------------------------------------------------------------------------
# launch_args, the cache of a layer's packed weights and ctypes arguments.
# The card's queries (SM count, shared-memory limit, the kernels' layout)
# are stubbed, so the cache's own rules run on the CPU: an entry is found
# again only for the same live tensors in the same state, and goes when one
# of them is freed, so the next flow of the same spec is packed anew even
# where its tensors take the freed addresses.
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_launch_args(monkeypatch):
    from fthmc_tpu_torch.ops import coupling_kernels as ck
    monkeypatch.setattr(ck, "_device_index", lambda x: 0)
    monkeypatch.setattr(ck, "sm_count", lambda index: N_SM)
    monkeypatch.setattr(ck, "band_layout", lambda *a: (4096, 0))
    monkeypatch.setattr(_build, "smem_limit", lambda index: 232448)
    monkeypatch.setattr(ck, "_LAUNCH_ARGS", {})
    return ck


def _flow(seed):
    from fthmc_tpu_torch.models.flow import init_flow_params
    spec = TSpec(n_layers=2, coupling="rncp", n_mixture=2, hidden_sizes=(4,),
                 s_clip=3.0)
    return spec, init_flow_params(spec, torch.Generator().manual_seed(seed),
                                  device="cpu")


def _packed_is(args, layer):
    want = [pack_conv(p["w"], p["b"]) for p in layer] + \
        [pack_conv(p["w"], None) for p in layer]
    return all(torch.equal(a, b) for a, b in zip(args.packed, want))


@pytest.mark.parametrize("change", ["none", "in_place", "freed", "shape",
                                    "plan"])
def test_launch_args_cache(cpu_launch_args, change):
    import gc
    ck = cpu_launch_args
    spec, params = _flow(1)
    x = torch.zeros((4, 2, 8, 8))
    live = params[0]
    first = ck.launch_args("K6", live, x, spec)
    assert (first.C, tuple(first.row0)) == band_plan(8, 4, N_SM)
    assert _packed_is(first, live) and len(ck._LAUNCH_ARGS) == 1
    if change == "none":
        assert ck.launch_args("K7", live, x, spec) is first
    elif change == "in_place":
        with torch.no_grad():
            live[1]["w"].mul_(2.0)
        again = ck.launch_args("K6", live, x, spec)
        assert again is not first and _packed_is(again, live)
        assert len(ck._LAUNCH_ARGS) == 1          # replaced, not added
    elif change == "freed":
        del params, live
        gc.collect()
        assert not ck._LAUNCH_ARGS                # dropped with its tensors
        live = _flow(2)[1][0]
        again = ck.launch_args("K6", live, x, spec)
        assert again is not first and _packed_is(again, live)
    elif change == "shape":
        again = ck.launch_args("K6", live, torch.zeros((4, 2, 16, 16)), spec)
        assert again is not first and again.L == 16
        assert len(ck._LAUNCH_ARGS) == 2
    else:
        plan = (2, (0, 4, 8))
        again = ck.launch_args("K6", live, x, spec, plan)
        assert (again.C, tuple(again.row0)) == plan
        assert ck.launch_args("K6", live, x, spec) is first
    with pytest.raises(ValueError, match="contiguous"):
        ck.launch_args("K6", live, x.transpose(2, 3), spec)


# ---------------------------------------------------------------------------
# _build.CONV_MACS: the conv multiply-adds each K6/K7/K8 launch runs,
# reckoned on the host. The library is stubbed (no card here), so every
# launch path's count runs, against a count from the stripe masks.
# ---------------------------------------------------------------------------


class _NoCard:
    """The kernels' libraries where there is no card: every entry returns
    0 (success) and launches nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


def _run_from_masks(widths, L, mu, off):
    """(K6 or K7, K8) multiply-adds a chain, from the stripe masks, each
    conv's outputs padded to 4: every conv dense but K6/K7's last (the
    active sites, a row's rounded up to whole items of 4) and K8's first
    transposed conv (the (site, tap) pairs whose input site is active)."""
    pad = lambda c: -(-c // 4) * 4
    active = jm.plaq_masks((L, L), mu, off)[1].astype(bool)
    n = len(widths) - 1
    fwd = sum(L * L * widths[li] * 9 * pad(widths[li + 1])
              for li in range(n - 1))
    bwd = sum(L * L * widths[li + 1] * 9 * pad(widths[li])
              for li in range(n - 1))
    sites = int((-(-active.sum(axis=1) // 4) * 4).sum())
    fwd += sites * widths[n - 1] * 9 * pad(widths[n])
    pairs = sum(int(np.roll(active, (1 - dy, 1 - dx), axis=(0, 1)).sum())
                for dy in range(3) for dx in range(3))
    bwd += pairs * widths[n] * pad(widths[n - 1])
    return fwd, bwd


@pytest.mark.parametrize("L,B", [(16, 64), (8, 4), (20, 3), (64, 2)])
def test_conv_macs_count_what_the_launches_run(cpu_launch_args,
                                                 monkeypatch, L, B):
    from benchmark.counts.work import coupling_macs
    from fthmc_tpu_torch.models.flow import init_flow_params
    from fthmc_tpu_torch.models.masks import layer_mask_params
    from fthmc_tpu_torch.ops.coupling_vjp_kernels import bwd_call
    ck = cpu_launch_args
    monkeypatch.setattr(_build, "library", lambda name: _NoCard())
    params = init_flow_params(FLAGSHIP, torch.Generator().manual_seed(0),
                              device="cpu")
    x = torch.zeros((B, 2, L, L))
    widths = (2, 32, 32, 17)
    ran = {"K6": 0, "K7": 0, "K8": 0}
    needed = dict(ran)
    for i, layer in enumerate(params):
        mu, off = layer_mask_params(i)
        a = ck.launch_args("K6-K8", layer, x, FLAGSHIP)
        before = dict(_build.CONV_MACS)
        ck.forward_call(a, 0, 0, 0, None, None, mu, off, 0)
        ck.forward_call(a, 0, 0, 0, "residuals", None, mu, off, 0)
        bwd_call(a, 0, 0, 0, 0, None, None, mu, off, 0)
        got = {k: _build.CONV_MACS[k] - before[k] for k in ran}
        fwd, bwd = _run_from_masks(widths, L, mu, off)
        assert got == {"K6": B * fwd, "K7": B * fwd, "K8": B * bwd}
        for k in ran:
            ran[k] += got[k]
            needed[k] += B * coupling_macs(widths, mu, off, L)[k]
    if L == 16:
        # the dead work left, against 1.79 (K7) and 1.81 (K8) when every
        # conv was dense
        assert ran["K7"] * 8712 == needed["K7"] * 11232
        assert ran["K8"] * 8424 == needed["K8"] * 11592
    _build.reset_counts()
    assert set(_build.CONV_MACS.values()) == {0}
