"""The dynamical FT-HMC sampler (fthmc_tpu_torch.schwinger, path C) against
the benchmark's plain reference of the two-flavour Schwinger model
(benchmark/reference/schwinger.py, float64, written from the published
operator), on the CPU: 8^2, 4 chains, a 2-layer rncp flow of seeded random
weights, the flow and the gauge field in float64.

The port's fermion arithmetic is complex64 whatever the field's dtype (as
in the JAX package, and K11's on the card), so each tolerance below sits
between what that fp32 arithmetic gives (measured ~1e-7 to 1e-6) and what
the precision under it gives: the same quantity with the links, the
fields and the solution rounded to bf16 differs by ~2e-3, and the bf16
control test holds the force's tolerance to that. The draws: the
reference's equal ``schwinger._draws``' for one generator state."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.reference import lattice as rlat
from benchmark.reference import schwinger as rs
from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import schwinger as ts
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.weights import flow_params_from_numpy

B, L, MASS, BETA = 4, 8, 0.1, 2.0
FLOW = dict(n_layers=2, n_mixture=2, hidden_sizes=[8], kernel_size=3,
            coupling="rncp", activation="silu", s_clip=3.0,
            conv_dtype="float32")
# fp32 links and sums of <= 10 terms a site (measured 1e-7)
OP_TOL = 1e-6
# fp32 CG at 1e-12 against float64 at 1e-20, relative to the largest
# component (measured 5e-7); S_pf the same solve's inner product (3e-7)
SOLVE_TOL = 1e-5
# the force, relative in norm: the fp32 fermion force pulled back through
# the float64 flow (measured 8e-7); its bf16 control reads 1.6e-3
FORCE_TOL = 1e-5
# one trajectory's dH, relative to max(1, |dH|): the fp32 energies (S_pf
# ~ 10^2, summed in another order) and fp32 forces over 2-4 forces
# (measured 5e-6 to 1e-5 with the CG at 1e-12)
DH_TOL = 1e-4
CFG = ts.SchwingerConfig(L=L, beta=BETA, mass=MASS, tau=0.3, nstep=2,
                         n_chains=B, eo_precond=True, cg_tol_force=1e-12,
                         cg_tol_mh=1e-12, cg_maxiter=2000)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """(port params, port spec, reference flow) of one random flow, written
    as an exported .npz and read by both."""
    rng = np.random.default_rng(3)
    widths = [2, *FLOW["hidden_sizes"], 2 * FLOW["n_mixture"] + 1]
    tree = [[{"w": (rng.normal(size=(co, ci, 3, 3)) * 0.3).astype(np.float32),
              "b": (rng.normal(size=(co,)) * 0.3).astype(np.float32)}
             for ci, co in zip(widths[:-1], widths[1:])]
            for _ in range(FLOW["n_layers"])]
    path = tmp_path_factory.mktemp("flow") / "flow.npz"
    np.savez(path, **{f"l{i:02d}_c{j}_{k}": conv[k]
                      for i, net in enumerate(tree)
                      for j, conv in enumerate(net) for k in ("w", "b")})
    spec = FlowSpec(n_layers=FLOW["n_layers"], n_mixture=FLOW["n_mixture"],
                    hidden_sizes=tuple(FLOW["hidden_sizes"]),
                    coupling="rncp", activation="silu", s_clip=3.0)
    params = flow_params_from_numpy(tree, spec, device="cpu",
                                    dtype=torch.float64)
    return params, spec, rs.BatchedFlow(FLOW, path, torch.float64, "cpu")


def _ref(flow, cfg=CFG):
    return rs.SchwingerFT(flow, cfg.beta, cfg.mass, cfg.tau, cfg.nstep,
                          eo=cfg.eo_precond)


def _field(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((B, 2, L, L), generator=g, dtype=torch.float64)
            * 2 - 1) * scale


def _spinor(seed, even=True):
    g = torch.Generator().manual_seed(seed)
    psi = torch.complex(*(torch.randn((B, L, L, 2), generator=g,
                                      dtype=torch.float64)
                          for _ in range(2)))
    return psi * rs.even_mask(psi) if even else psi


def _rel(got, want):
    """Largest component gap over the largest component."""
    d = got.to(torch.complex128) - want.to(torch.complex128)
    return float(d.abs().max() / want.abs().max())


def _bf16(t):
    """t rounded to bf16, real and imaginary parts apart."""
    if t.is_complex():
        return torch.complex(_bf16(t.real), _bf16(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)


@pytest.mark.parametrize("eo", [True, False])
def test_the_dirac_operator_matches(eo):
    th, psi = _field(5), _spinor(6, even=eo)
    port = tf.dirac_hat if eo else tf.dirac
    ref = rs.dirac_hat if eo else rs.dirac
    want = ref(rs.links(th), psi, MASS)
    assert _rel(port(th, psi.to(torch.complex64), MASS), want) < OP_TOL
    want_dag = rs.dagger(ref)(rs.links(th), psi, MASS)
    port_dag = tf.dirac_hat_dag if eo else tf.dirac_dag
    assert _rel(port_dag(th, psi.to(torch.complex64), MASS),
                want_dag) < OP_TOL
    # the precision below the port's
    assert _rel(ref(rs.links(_bf16(th)), _bf16(psi), MASS), want) > OP_TOL


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_the_cg_solution_and_the_pseudofermion_action_match(flows, backend):
    th, phi = _field(7), _spinor(8)
    x_ref = _ref(flows[2]).solve(th, phi, torch.zeros_like(phi))
    res = tf.cg_solve(th, phi.to(torch.complex64), MASS, tol=1e-12,
                      maxiter=2000, eo=True, backend=backend)
    assert _rel(res.x, x_ref) < SOLVE_TOL
    s_ref = rs.cdot(phi, x_ref).real
    s, _ = tf.pf_action_exact(th, phi.to(torch.complex64), MASS, tol=1e-12,
                              eo=True, backend=backend)
    assert float(((s.double() - s_ref).abs() / s_ref.abs()).max()) \
        < SOLVE_TOL


def _forces(flows):
    """(the reference's force, its X, z, phi) at a random latent field."""
    ref = _ref(flows[2])
    z = _field(9)
    y, _ = ref.field(z)
    phi, _ = ref.refresh(y, _spinor(10) * math.sqrt(0.5))
    f, x = ref.force(z, phi, torch.zeros_like(phi))
    return f, x, z, phi


@pytest.mark.parametrize("backend", ["kernel", "autograd"])
def test_the_flowed_force_matches(flows, backend):
    """dS_eff/dz: the gauge force and the log det in float64 on both sides,
    so the gap is the fermion force's."""
    params, spec, _ = flows
    f_ref, _, z, phi = _forces(flows)
    f, _ = ts.ft_dyn_force(params, spec, z, CFG, phi.to(torch.complex64),
                           torch.zeros_like(phi, dtype=torch.complex64),
                           False, backend)
    assert float((f - f_ref).norm() / f_ref.norm()) < FORCE_TOL


def test_a_bf16_fermion_force_fails_the_force_tolerance(flows):
    """The reference's force with the fermion part's links, solution and
    field rounded to bf16 (the precision below the port's fp32)."""
    flow = flows[2]
    f_ref, x, z, phi = _forces(flows)
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        y, logdet = flow.forward(zz)
        yb = y + (_bf16(y.detach()) - y.detach())
        dx = rs.dirac_hat(rs.links(yb), _bf16(x), MASS)
        s_pf = (2.0 * rs.cdot(_bf16(x), _bf16(phi)).real
                - rs.cdot(dx, dx).real)
        s = rlat.action(y, BETA) + s_pf - logdet
        (f,) = torch.autograd.grad(s.sum(), zz)
    assert float((f - f_ref).norm() / f_ref.norm()) > FORCE_TOL


def test_the_reference_draws_the_samplers_draws():
    """For one generator state, the sampler's fp32 field: v0 and u equal,
    chi to fp32's rounding of the 1/sqrt 2 scale."""
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    z = _field(12).float()
    v0, chi, u = ts._draws(g, z)
    g.set_state(state)
    v0_r, chi_r, u_r = _ref(None).draws(g, z)
    assert torch.equal(v0, v0_r) and torch.equal(u, u_r)
    assert float((chi.to(torch.complex128) - chi_r).abs().max()) < 1e-6


@pytest.mark.parametrize("nstep", [1, 2])
def test_one_trajectory_dh_matches(flows, nstep):
    """One trajectory from the same start on the same draws (the port's,
    in float64 for v0): dH, the accept and the plaquette of the kept
    field."""
    params, spec, flow = flows
    cfg = dataclasses.replace(CFG, nstep=nstep)
    z = _field(13, scale=0.5)
    g = torch.Generator().manual_seed(14)
    v0, chi, u = ts._draws(g, z.float())
    draws = (v0.double(), chi, u.double())
    z0, remat, backend, flow_fn = ts._ft_setup(params, spec, cfg, z, False,
                                               "kernel", torch.device("cpu"))
    _, y_new, _, m = ts._fthmc_step_dyn(params, spec, z0, torch.zeros(B),
                                        cfg, draws, remat, backend, flow_fn)
    dh_ref, y1, y0 = _ref(flow, cfg).trajectory(z, draws[0],
                                                chi.to(torch.complex128))
    gap = (m.dh.double() - dh_ref).abs() / dh_ref.abs().clamp(min=1.0)
    assert float(gap.max()) < DH_TOL
    acc = draws[2] < torch.exp(-dh_ref)
    sure = (torch.log(draws[2]) + dh_ref).abs() > 1e-2
    assert torch.equal(m.acc.bool()[sure], acc[sure])
    y = torch.where(acc[:, None, None, None], y1, y0)
    assert float((rlat.plaq_mean(y) - m.plaq)[sure].abs().max()) < 1e-6
