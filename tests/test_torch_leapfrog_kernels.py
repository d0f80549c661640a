"""The plain twins of K2-K5 (fthmc_tpu_torch/ops/lattice_kernels.py) against
the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them, and the port's Philox generator
(ops/rng.py) against the published Philox4x32-10 answers.

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
from fthmc_tpu_torch.ops.lattice_kernels import (hmc_traj, hmc_traj_hostrng,
                                                 hmc_traj_hostrng_plain,
                                                 hmc_traj_plain, leapfrog,
                                                 leapfrog_cl,
                                                 leapfrog_cl_plain,
                                                 leapfrog_plain)

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
                     "K7": 0, "K8": 0, "K9": 0, "K10": 0, "K11": 0}
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
