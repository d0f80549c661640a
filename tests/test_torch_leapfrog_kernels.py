"""The plain twins of K2-K5 (fthmc_tpu_torch/ops/lattice_kernels.py) against
the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them, and the port's Philox generator
(ops/rng.py) against the published Philox4x32-10 answers; a float64
mirror of the band body of K2, K4 and K5 against the twins, and its plans.

Tolerances: fp32 through nstep <= 8 steps, 1e-4 on x and v and 1e-5 on
wrapped x after an accept (tests/test_pallas.py's own bounds); dH to 1e-4,
a sum of 64 sites' O(1) terms in fp32 in two orders."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu.ops.pallas_lattice import (pallas_hmc_traj_hostrng,
                                          pallas_leapfrog, pallas_leapfrog_cl)
from fthmc_tpu_torch.ops import _build, rng
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.ops.lattice_kernels import (K3_TILE, K3_TILES,
                                                 TrajPlan, _plaq_of,
                                                 epilogue_dh_tolerance,
                                                 hmc_epilogue,
                                                 hmc_epilogue_plain,
                                                 hmc_traj, hmc_traj_hostrng,
                                                 hmc_traj_hostrng_plain,
                                                 hmc_traj_plain, leapfrog,
                                                 leapfrog_cl,
                                                 leapfrog_cl_plain,
                                                 leapfrog_plain, max_threads,
                                                 traj_plan, traj_plan_of,
                                                 traj_plans, traj_reach,
                                                 traj_smem_bytes_of)

BETA, DT = 2.0, 0.1


def _inputs(seed, B, L=8):
    g = np.random.default_rng(seed)
    x = g.uniform(-3.0, 3.0, (B, 2, L, L)).astype(np.float32)
    v = g.normal(size=x.shape).astype(np.float32)
    u = g.uniform(size=B).astype(np.float32)
    return x, v, u


def _wrapped(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.remainder(d + math.pi, 2 * math.pi) - math.pi).max()


# Random123's kat_vectors for philox4x32 with 10 rounds:
# (counter words, key words) -> output words.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expect", PHILOX_KAT)
def test_philox_known_answers(counter, key, expect):
    assert philox_words(counter, key, as_tensor=False) == expect
    assert philox_words(counter, key, as_tensor=True) == expect


def philox_words(counter, key, as_tensor):
    if as_tensor:   # the int64-tensor path the twin runs
        counter = tuple(torch.tensor([c]) for c in counter)
        key = tuple(torch.tensor([k]) for k in key)
        return tuple(int(w) for w in rng.philox4x32_10(counter, key))
    return tuple(rng.philox4x32_10(counter, key))


def test_philox_draws_moments_and_independence():
    """64 x 2 x 16^2 momenta and 4096 accept draws of one seed: moments
    within 5 standard errors, uniforms in (0, 1], streams of two seeds and
    of two chains uncorrelated."""
    seed = torch.tensor([2026], dtype=torch.int32)
    v = rng.momenta(seed, 64, 16).double().flatten()
    n = v.numel()
    assert abs(float(v.mean())) < 5 / math.sqrt(n)
    assert abs(float(v.var()) - 1.0) < 5 * math.sqrt(2.0 / n)
    assert abs(float((v ** 4).mean()) - 3.0) < 5 * math.sqrt(96.0 / n)
    u = rng.accept_uniforms(seed, 4096).double()
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert abs(float(u.mean()) - 0.5) < 5 * math.sqrt(1 / 12 / 4096)
    w = rng.momenta(torch.tensor([-7], dtype=torch.int32), 64, 16).flatten()
    assert abs(float(torch.corrcoef(torch.stack((v.float(), w)))[0, 1])) \
        < 5 / math.sqrt(n)
    per_chain = rng.momenta(seed, 2, 64).flatten(1)
    assert abs(float(torch.corrcoef(per_chain)[0, 1])) \
        < 5 / math.sqrt(per_chain.shape[1])
    # the uniform map is exact: the largest word is 1, the smallest 2^-24
    assert float(rng.uniform24(torch.tensor([0x7FFFFFFF]))) == 1.0
    assert float(rng.uniform24(torch.tensor([0]))) == 2.0 ** -24


@pytest.mark.parametrize("kernel,B,nstep", [("K2", 4, 6), ("K3", 128, 6),
                                            ("K2", 3, 0)])
def test_leapfrog_twins_match_pallas(kernel, B, nstep):
    x, v, _ = _inputs(B + nstep, B)
    if kernel == "K2":
        ref = pallas_leapfrog(jnp.asarray(x), jnp.asarray(v), beta=BETA,
                              dt=DT, nstep=nstep, block=B, interpret=True)
        got = leapfrog(torch.as_tensor(x), torch.as_tensor(v), BETA, DT,
                       nstep)
    else:
        ref = pallas_leapfrog_cl(jnp.asarray(x), jnp.asarray(v), beta=BETA,
                                 dt=DT, nstep=nstep, block=128,
                                 interpret=True)
        got = leapfrog_cl(torch.as_tensor(x), torch.as_tensor(v), BETA, DT,
                          nstep)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_k3_twin_is_k2_twin_in_the_other_layout():
    x, v, _ = _inputs(9, 12, L=6)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    a = leapfrog_plain(xt, vt, 3.0, 0.05, 7)
    b = leapfrog_cl_plain(xt, vt, 3.0, 0.05, 7)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_k5_twin_matches_pallas_hostrng():
    B, nstep = 16, 8
    x, v, u = _inputs(11, B)
    xr, dhr, accr = pallas_hmc_traj_hostrng(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(u), beta=BETA, dt=DT,
        nstep=nstep, block=B, interpret=True)
    xn, dh, acc = hmc_traj_hostrng(torch.as_tensor(x), torch.as_tensor(v),
                                   torch.as_tensor(u), BETA, DT, nstep)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dhr), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(accr))
    assert 0 < acc.sum() < B   # both branches of the select are taken
    assert _wrapped(xn.numpy(), xr) < 1e-5


def test_k4_twin_is_k5_twin_on_the_philox_draws():
    B, L, nstep = 6, 8, 5
    x = torch.as_tensor(_inputs(12, B, L)[0])
    seed = torch.tensor([987654321], dtype=torch.int32)
    got = hmc_traj(x, seed, BETA, DT, nstep)
    ref = hmc_traj_hostrng_plain(x, rng.momenta(seed, B, L),
                                 rng.accept_uniforms(seed, B), BETA, DT,
                                 nstep)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # a fixed seed gives a fixed trajectory; another seed another one
    assert all(torch.equal(a, b)
               for a, b in zip(got, hmc_traj_plain(x, seed, BETA, DT,
                                                   nstep)))
    other = hmc_traj(x, torch.tensor([5], dtype=torch.int32), BETA, DT,
                     nstep)
    assert not torch.equal(got[1], other[1])


def test_wrappers_run_the_twins_on_the_cpu():
    x, v, u = (torch.as_tensor(a) for a in _inputs(13, 4))
    seed = torch.tensor([1], dtype=torch.int32)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    leapfrog(x, v, BETA, DT, 2)
    leapfrog_cl(x, v, BETA, DT, 2)
    hmc_traj(x, seed, BETA, DT, 2)
    hmc_traj_hostrng(x, v, u, BETA, DT, 2)
    plain = {k: _build.PLAIN_CALLS[k] - before[0][k] for k in before[0]}
    assert plain == {"K1": 0, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 0,
                     "K7": 0, "K8": 0, "K9": 0, "K10": 0, "K11": 0,
                     "K11_bf16": 0, "K12": 0}
    assert dict(_build.LAUNCHES) == before[1]


@pytest.mark.parametrize("call", [
    lambda x, v, u, s: leapfrog(x[:, :1], v[:, :1], BETA, DT, 1),
    lambda x, v, u, s: leapfrog(x, v[:2], BETA, DT, 1),
    lambda x, v, u, s: leapfrog_cl(x[..., :4], v[..., :4], BETA, DT, 1),
    lambda x, v, u, s: hmc_traj_hostrng(x, v, u[:2], BETA, DT, 1),
    lambda x, v, u, s: hmc_traj(x, s.long(), BETA, DT, 1),
    lambda x, v, u, s: leapfrog(x.to("meta"), v.to("meta"), BETA, DT, 1),
])
def test_wrappers_refuse_bad_shapes_and_devices(call):
    x, v, u = (torch.as_tensor(a) for a in _inputs(14, 4))
    with pytest.raises(ValueError):
        call(x, v, u, torch.tensor([1], dtype=torch.int32))


# ---------------------------------------------------------------------------
# K12's twin: the plain step's torch sequence after the trajectory
# ---------------------------------------------------------------------------

def _epilogue_inputs(seed, B, L, dtype):
    """A start x, a trajectory's unwrapped end x1 (some links past +-pi, so
    the wrap works), momenta v0, v1, uniforms u and last charges q_old."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((B, 2, L, L), generator=g, dtype=dtype) * 2 - 1) * 3.0
    x1 = x + 0.05 * torch.randn(x.shape, generator=g, dtype=dtype) \
        + 2 * math.pi * torch.randint(-1, 2, x.shape, generator=g).to(dtype)
    v0 = torch.randn(x.shape, generator=g, dtype=dtype)
    v1 = v0 + 0.05 * torch.randn(x.shape, generator=g, dtype=dtype)
    u = torch.rand((B,), generator=g, dtype=dtype)
    q_old = torch.randint(-3, 4, (B,), generator=g).to(dtype)
    return x, x1, v1, v0, u, q_old


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,L", [(6, 8), (3, 5)])
def test_k12_twin_is_the_steps_torch_sequence(dtype, B, L):
    """The twin is, bit for bit, the composition of lattice.wrap,
    delta_action + hmc._kinetic_delta, hmc._metropolis drawing u from the
    generator and hmc._metrics."""
    x, x1, v1, v0, _, q_old = _epilogue_inputs(B + L, B, L, dtype)
    g = torch.Generator().manual_seed(7)
    u = torch.rand((B,), generator=torch.Generator().manual_seed(7),
                   dtype=dtype)
    x1w = tl.wrap(x1)
    dh = tl.delta_action(x1w, x, BETA) + th._kinetic_delta(v1, v0)
    exp_mdh, acc, (want_x,) = th._metropolis(g, dh, (x1w,), (x,))
    want = th._metrics(dh, exp_mdh, acc, want_x, q_old)
    before = dict(_build.PLAIN_CALLS)
    got_x, rows = hmc_epilogue(x, x1, v1, v0, u, q_old, BETA)
    assert _build.PLAIN_CALLS["K12"] == before["K12"] + 1
    assert 0 < int(acc.sum()) < B or B < 4   # both branches where B allows
    assert torch.equal(got_x, want_x)
    assert rows.shape == (6, B) and rows.dtype == dtype
    for a, b in zip(th.TrajMetrics(*rows), want):
        assert torch.equal(a, b)


def test_epilogue_dh_tolerance_holds_fp32_and_not_a_bf16_cos():
    """At 64^2 the twin in fp32 lies within epilogue_dh_tolerance of the
    twin in float64 on every chain, and the twin in float64 with each cos P
    rounded to bfloat16 (the control a kernel that is not fp32 throughout
    would read) lies outside it on most chains."""
    x, x1, v1, v0, u, q_old = _epilogue_inputs(64, 16, 64, torch.float32)
    tol = epilogue_dh_tolerance(x, x1, v1, v0, BETA)
    d = [t.double() for t in (x, x1, v1, v0, u, q_old)]
    ref = hmc_epilogue_plain(*d, BETA)[1][0]
    got = hmc_epilogue_plain(x, x1, v1, v0, u, q_old, BETA)[1][0].double()
    assert bool(((got - ref).abs() <= tol).all())
    c0, c1 = (_plaq_of(f).cos().bfloat16().double()
              for f in (d[0], tl.wrap(d[1])))
    ctrl = (-BETA * (c1 - c0).sum((1, 2))
            + 0.5 * ((d[2] - d[3]) * (d[2] + d[3])).sum((1, 2, 3)))
    assert float(((ctrl - ref).abs() > tol).double().mean()) > 0.5


@pytest.mark.parametrize("call", [
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x, x1[:, :, :4, :4], v1, v0,
                                             u, q, BETA),
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x, x1, v1[:2], v0, u, q, BETA),
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x, x1, v1, v0, u[:2], q, BETA),
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x, x1, v1, v0, u, q[None],
                                             BETA),
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x, x1, v1, v0, u.double(), q,
                                             BETA),
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x, x1, v1.double(), v0, u, q,
                                             BETA),
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x, x1, v1, v0, u,
                                             q.to("meta"), BETA),
    lambda x, x1, v1, v0, u, q: hmc_epilogue(x.to("meta"), x1, v1, v0, u, q,
                                             BETA),
])
def test_k12_wrapper_refuses_mismatched_inputs(call):
    """Other shapes, dtypes or devices are refused before the twin (or the
    kernel) runs."""
    args = _epilogue_inputs(1, 4, 8, torch.float32)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    with pytest.raises((ValueError, TypeError)):
        call(*args)
    assert (dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)) == before


# ---------------------------------------------------------------------------
# The band body of K2-K5 (csrc/traj_common.cuh), mirrored in float64: a
# group (one chain, or K3's tile of TC chains, a tile's chains past B
# computing on zeros and storing nothing) is C bands of rows, CTA r's
# thread t owning chain t % TC of the group, column (t // TC) % L and the
# run of S rows from local row (t // (TC L)) S (rows past the band idle),
# fields kept per thread, shared cells (row L + column) TC + chain; a step
# publishes x0 of each run and x1 of its first row, reads x1(i+1) from the
# run, the next run's first row or the band below's first row, publishes
# sin P and reads sin P(i-1) from the run, the run above's last row or the
# band above's last row (ranks wrapping C - 1 <-> 0); dH over a thread's
# sites in order, a tree over the CTA's threads (padded to a power of two),
# then the CTAs in rank order. Shared buffers start NaN, so a site that
# reads what was never published shows.
# ---------------------------------------------------------------------------

N_SM = 132               # an H100's SMs


class _BandMirror:
    def __init__(self, L, plan):
        C, row0, T, S, TC = plan
        self.L, self.C, self.T, self.S, self.TC = L, C, T, S, TC
        R = np.diff(np.asarray(row0))
        self.R, self.RL = R, int(R.max()) * L * TC
        t = np.arange(T)
        self.c, q = t % TC, t // TC
        self.j, self.g0 = q % L, (q // L) * S
        self.jp, self.jm = (self.j + 1) % L, (self.j - 1) % L
        lr = self.g0[None, :, None] + np.arange(S)[None, None, :]   # (1,T,S)
        self.lr = np.broadcast_to(lr, (C, T, S))
        self.valid = self.lr < R[:, None, None]
        self.nv = self.valid.sum(axis=2)                            # (C, T)
        last = R[:, None] - 1 - self.g0[None, :]                    # (C, T)
        self.klast = np.where((last >= 0) & (last < S), last, -1)
        self.up, self.dn = (np.arange(C) - 1) % C, (np.arange(C) + 1) % C
        self.i = np.asarray(row0)[:-1, None, None] + self.lr        # global
        self.cj = self.j * TC + self.c        # a cell's column and chain
        self.cell = self.lr * L * TC + self.cj[None, :, None]       # smem
        self.site = self.i * L + self.j[None, :, None]              # global
        self.chain = np.broadcast_to(self.c[None, :, None], (C, T, S))

    def _cells(self, cols):
        """Cells of each thread's sites in its band at columns ``cols``."""
        return self.lr * self.L * self.TC + (cols * self.TC
                                             + self.c)[None, :, None]

    def load(self, f):
        """(B, 2, L, L) -> two (groups, C, T, S) fields, 0 off the band and
        past B."""
        B, TC = f.shape[0], self.TC
        groups = -(-B // TC)
        pad = np.zeros((groups * TC, 2, self.L * self.L))
        pad[:B] = f.reshape(B, 2, -1)
        pad = pad.reshape(groups, TC, 2, -1)
        idx = np.where(self.valid, self.site, 0)
        return tuple(np.where(self.valid, pad[:, self.chain, d, idx], 0.0)
                     for d in (0, 1))

    def store(self, f0, f1, out):
        flat = out.reshape(out.shape[0], 2, -1)
        b = (np.arange(f0.shape[0])[:, None, None, None] * self.TC
             + self.chain[None])
        live = self.valid[None] & (b < out.shape[0])
        site = np.broadcast_to(self.site[None], b.shape)
        for d, f in enumerate((f0, f1)):
            flat[b[live], d, site[live]] = f[live]
        return out

    def _gather(self, buf, rank, cell, mask):
        """buf (B, C, n)[:, rank, cell] where mask, 0 elsewhere."""
        rank = np.broadcast_to(rank, mask.shape)
        cell = np.broadcast_to(cell, mask.shape)
        got = buf[:, np.where(mask, rank, 0), np.where(mask, cell, 0)]
        return np.where(mask, got, 0.0)

    def plaq(self, x0, x1):
        B, C, T, S, L = x0.shape[0], self.C, self.T, self.S, self.L
        xs0 = np.full((B, C, self.RL), np.nan)
        x1f = np.full((B, C, T), np.nan)
        ranks = np.arange(C)[:, None, None]
        for r in range(C):
            v = self.valid[r]
            xs0[:, r, self.cell[r][v]] = x0[:, r][:, v]
            own = self.nv[r] > 0
            x1f[:, r, np.arange(T)[own]] = x1[:, r, own, 0]
        # x1(i+1) of a run's last site: band below's first row, next run's
        has_last = self.klast >= 0
        nxt = (~has_last) & (self.nv == S)
        below = (self._gather(x1f, self.dn[:, None], self.cj[None, :],
                              has_last)
                 + self._gather(x1f, np.arange(C)[:, None],
                                np.arange(T)[None, :] + L * self.TC, nxt))
        k = np.arange(S)[None, None, :]
        from_below = (k == self.klast[:, :, None]) | (k == S - 1)
        shifted = np.concatenate([x1[..., 1:], x1[..., -1:]], axis=-1)
        xn = np.where(from_below, below[..., None], shifted)
        right = self._gather(xs0, ranks, self._cells(self.jp), self.valid)
        return np.where(self.valid, x0 + xn - right - x1, 0.0)

    def leapfrog(self, x0, x1, p0, p1, beta, dt, nstep):
        B, C, T, S, L = x0.shape[0], self.C, self.T, self.S, self.L
        row = L * self.TC
        hdt = 0.5 * dt
        x0, x1 = x0 + hdt * p0, x1 + hdt * p1
        ranks = np.arange(C)[:, None, None]
        for _ in range(nstep):
            sp = np.where(self.valid, np.sin(self.plaq(x0, x1)), 0.0)
            sps = np.full((B, C, self.RL), np.nan)
            for r in range(C):
                v = self.valid[r]
                sps[:, r, self.cell[r][v]] = sp[:, r][:, v]
            run = self.nv > 0
            first = run & (self.g0[None, :] == 0)
            R_up = self.R[self.up]
            above = (self._gather(sps, self.up[:, None],
                                  (R_up[:, None] - 1) * row
                                  + self.cj[None, :], first)
                     + self._gather(sps, np.arange(C)[:, None],
                                    (self.g0[None, :] - 1) * row
                                    + self.cj[None, :], run & ~first))
            sa = np.concatenate([above[..., None], sp[..., :-1]], axis=-1)
            left = self._gather(sps, ranks, self._cells(self.jm), self.valid)
            f0, f1 = beta * (sp - left), beta * (sa - sp)
            p0 = np.where(self.valid, p0 - dt * f0, 0.0)
            p1 = np.where(self.valid, p1 - dt * f1, 0.0)
            x0, x1 = x0 + dt * p0, x1 + dt * p1
        return x0 - hdt * p0, x1 - hdt * p1, p0, p1

    def chain_sum(self, per_site):
        """A (B, C, T, S) term summed as the kernels sum dH."""
        B, C, T = per_site.shape[:3]
        acc = np.zeros((B, C, T))
        for k in range(self.S):                     # a thread's sites
            acc = acc + np.where(self.valid[..., k], per_site[..., k], 0.0)
        p2 = 1 << (T - 1).bit_length()
        red = np.concatenate([acc, np.zeros((B, C, p2 - T))], axis=-1)
        h = p2 // 2
        while h:                                     # the CTA's tree
            red = red[..., :h] + red[..., h:2 * h]
            h //= 2
        total = np.zeros(B)
        for r in range(C):                           # ranks in order
            total = total + red[:, r, 0]
        return total


def band_leapfrog(x, v, beta, dt, nstep, L, plan):
    m = _BandMirror(L, plan)
    x0, x1, p0, p1 = m.leapfrog(*m.load(x), *m.load(v), beta, dt, nstep)
    return (m.store(x0, x1, np.full_like(x, np.nan)),
            m.store(p0, p1, np.full_like(v, np.nan)))


def band_hmc_traj(x, v, u, beta, dt, nstep, L, plan):
    m = _BandMirror(L, plan)
    x0, x1 = m.load(x)
    p0, p1 = m.load(v)
    c0 = np.cos(m.plaq(x0, x1))
    y0, y1, q0, q1 = m.leapfrog(x0, x1, p0, p1, beta, dt, nstep)
    dsw = m.chain_sum(np.cos(m.plaq(y0, y1)) - c0)
    dk = m.chain_sum((q0 - p0) * (q0 + p0) + (q1 - p1) * (q1 + p1))
    dh = -beta * dsw + 0.5 * dk
    acc = u < np.exp(-dh)
    y = m.store(y0, y1, np.full_like(x, np.nan))
    yw = np.remainder(y + math.pi, 2 * math.pi) - math.pi
    return np.where(acc[:, None, None, None], yw, x), dh, acc


MIRROR_CASES = [(L, plan) for L in (2, 3, 8, 20, 64, 128)
                for plan in traj_plans(L)]


@pytest.mark.parametrize("L,plan", MIRROR_CASES,
                         ids=[f"L{L}-C{p.C}-S{p.sites}"
                              for L, p in MIRROR_CASES])
def test_band_mirror_reproduces_the_twins(L, plan):
    """The band body's indexing, in float64, against the twins (float64),
    to 1e-12, under every plan of L."""
    B, nstep, beta, dt = 2, 3, 2.0, 0.1
    g = np.random.default_rng(L * 100 + plan.C * 10 + plan.sites)
    x = g.uniform(-1.0, 1.0, (B, 2, L, L))
    v = g.normal(size=x.shape)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    xr, vr = leapfrog_plain(xt, vt, beta, dt, nstep)
    xm, vm = band_leapfrog(x, v, beta, dt, nstep, L, plan)
    np.testing.assert_allclose(xm, xr.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(vm, vr.numpy(), rtol=0, atol=1e-12)
    # one chain accepted, one rejected
    xn, dh, acc = hmc_traj_hostrng_plain(
        xt, vt, torch.zeros(B, dtype=torch.float64), beta, dt, nstep)
    u = np.exp(-dh.numpy()) * np.array([0.5, 2.0])
    xn, dh, acc = hmc_traj_hostrng_plain(xt, vt, torch.as_tensor(u), beta,
                                         dt, nstep)
    xm, dhm, accm = band_hmc_traj(x, v, u, beta, dt, nstep, L, plan)
    np.testing.assert_allclose(dhm, dh.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(accm, acc.numpy().astype(bool))
    assert accm.tolist() == [True, False]
    np.testing.assert_allclose(xm, xn.numpy(), rtol=0, atol=1e-12)


K3_MIRROR_CASES = [(L, plan) for L in (2, 3, 8, 20, 32, 48, 64)
                   for plan in traj_plans(L, K3_TILES)]


@pytest.mark.parametrize("L,plan", K3_MIRROR_CASES,
                         ids=[f"L{L}-C{p.C}-S{p.sites}-TC{p.tile}"
                              for L, p in K3_MIRROR_CASES])
def test_k3_mirror_reproduces_the_twin(L, plan):
    """K3's indexing (tiles of TC chains, the chain fastest, the last tile
    ragged; runs; bands), in float64, against its twin (float64) to 1e-12,
    under every plan of K3's sweep at L, for B = 1, 3, 8 and 130 chains."""
    nstep, beta, dt = 2, 2.0, 0.1
    g = np.random.default_rng(L * 1000 + plan.C * 100 + plan.sites * 10
                              + plan.tile)
    for B in (1, 3, 8, 130):
        x = g.uniform(-1.0, 1.0, (B, 2, L, L))
        v = g.normal(size=x.shape)
        xr, vr = leapfrog_cl_plain(torch.as_tensor(x), torch.as_tensor(v),
                                   beta, dt, nstep)
        xm, vm = band_leapfrog(x, v, beta, dt, nstep, L, plan)
        np.testing.assert_allclose(xm, xr.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(vm, vr.numpy(), rtol=0, atol=1e-12)


H100_SMEM = 232448       # bytes a block may opt in to
H100_REGS = 65536        # 32-bit registers an SM


@pytest.mark.parametrize("B", [1, 1024])
def test_traj_plan_covers_every_L_within_the_h100s_limits(B):
    """Every L from 2 to 256 has a plan, which owns every site once and
    stays within an H100's shared memory, registers, threads and the
    portable cluster; the plans' reach is 256."""
    assert traj_reach() == 256
    for L in range(2, 257):
        for plan in {*(traj_plan(L, B, N_SM, k)
                       for k in ("K2", "K4", "K5", "K12")),
                     *traj_plans(L)}:
            assert plan == traj_plan_of(L, plan.C, plan.sites)
            assert 1 <= plan.C <= min(8, L)
            assert plan.threads % L == 0 and plan.threads <= 1024
            assert plan.threads * (H100_REGS // max_threads(plan.sites)) \
                <= H100_REGS
            assert plan.threads <= max_threads(plan.sites)
            for k in ("K2", "K4", "K5", "K12"):
                assert traj_smem_bytes_of(L, plan, k) <= H100_SMEM
            m = _BandMirror(L, plan)
            owned = np.sort(m.site[m.valid])
            np.testing.assert_array_equal(owned, np.arange(L * L))


def test_traj_plans_of_the_cells():
    """The headline's plan is the one PERF.md records; 128^2 and 256^2 take
    bands in a cluster; K3's plans at 8^2-32^2."""
    assert traj_plan(64, 1024, N_SM, "K2") == TrajPlan(1, (0, 64), 512, 8)
    assert traj_plan(64, 1024, N_SM, "K12") == TrajPlan(1, (0, 64), 256, 16)
    for k in ("K4", "K5"):
        assert traj_plan(64, 1024, N_SM, k) == TrajPlan(1, (0, 64), 1024, 4)
        assert traj_plan(128, 16, N_SM, k) == TrajPlan(
            8, tuple(range(0, 129, 16)), 512, 4)
    assert traj_plan(128, 16, N_SM, "K2") == TrajPlan(
        8, tuple(range(0, 129, 16)), 256, 8)
    for k in ("K2", "K4", "K5"):
        assert traj_plan(256, 16, N_SM, k) == TrajPlan(
            8, tuple(range(0, 257, 32)), 512, 16)
        assert traj_plan(200, 1, N_SM, k).row0[1] == 25
    # K3: one CTA a tile of 2 chains, the most sites up to 4 that keep 128
    # threads (PERF.md section 6)
    assert traj_plan(8, 1024, N_SM, "K3") == TrajPlan(1, (0, 8), 128, 1, 2)
    assert traj_plan(16, 1024, N_SM, "K3") == TrajPlan(1, (0, 16), 128, 4,
                                                        2)
    assert traj_plan(32, 1024, N_SM, "K3") == TrajPlan(1, (0, 32), 512, 4,
                                                        2)


@pytest.mark.parametrize("B", [1, 3, 1024])
def test_k3_plan_covers_every_L_within_the_h100s_limits(B):
    """Every L from 2 to 256 has a K3 plan, of tiles no wider than B needs
    (every plan of K3's sweep up to 64^2 is one the kernel takes too),
    within an H100's shared memory, threads and the portable cluster; at
    B = 1 and 3 the plan stores every site of every chain (the ragged
    tile's chains past B none); tiles of K3_TILE chains from 2 chains up to
    128^2, one CTA a tile up to 44^2."""
    picked = [(L, traj_plan(L, B, N_SM, "K3")) for L in range(2, 257)]
    swept = [(L, p) for L in (2, 3, 8, 20, 32, 48, 64)
             for p in traj_plans(L, K3_TILES)]
    for L, plan in picked:
        assert plan.tile == (1 if B == 1 or L > 128 else K3_TILE)
        # one chain: K2's plan, bands filling the SMs from 16^2
        assert (plan.C == 1) == (L <= 44 if B > 1 else L < 16)
    for L, plan in picked + swept:
        assert plan == traj_plan_of(L, plan.C, plan.sites, plan.tile)
        assert 1 <= plan.C <= min(8, L)
        assert plan.threads % (L * plan.tile) == 0
        assert plan.threads <= max_threads(plan.sites)
        assert traj_smem_bytes_of(L, plan, "K3") <= H100_SMEM
        if B > 3:
            continue
        ids = np.arange(B * 2 * L * L, dtype=float).reshape(B, 2, L, L)
        np.testing.assert_array_equal(
            band_leapfrog(ids, np.zeros_like(ids), 0.0, 0.0, 0, L, plan)[0],
            ids)


@pytest.mark.parametrize("L", [1, 257, 1024])
@pytest.mark.parametrize("kernel", ["K2", "K3", "K4", "K5", "K12"])
def test_traj_plan_raises_above_the_reach(L, kernel):
    with pytest.raises(ValueError, match="L <= 256"):
        traj_plan(L, 4, N_SM, kernel)
