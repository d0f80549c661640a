"""Wilson fermions on the 2D U(1) lattice: the Dirac operator, batched CG
and the pseudofermion action and force. Counterpart of
``fthmc_tpu/fermion.py``, with its conventions:

- gauge field theta (..., 2, L0, L1), U_mu(x) = exp(i theta_mu(x)); fermion
  field psi (..., L0, L1, 2) complex64, last axis the spinor;
- gamma_0 = sigma_x, gamma_1 = sigma_y, gamma_5 = sigma_z;
- periodic in space (axis 1), antiperiodic in time (axis 0), folded into
  the time-direction links of the last time slice;
- D psi = (m + 2) psi - 1/2 sum_mu [(1 - g_mu) U_mu(x) psi(x + mu)
  + (1 + g_mu) U_mu(x - mu)^* psi(x - mu)], M = D^dag D (two flavours);
- even-odd: fields stay full size with odd sites zero, Dhat = (m + 2) -
  D_eo D_oe / (m + 2) on the even subspace.

Everything is fp32 (complex64), as in the JAX package, whatever theta's
dtype. The fermion force is torch.autograd through ``pf_action_lin`` with
the CG solution held fixed, the counterpart of jax.grad through XLA code.

CG backends (``cg_solve``): 'xla' is a torch complex CG on ``apply_mdagm``
(the counterpart of ``_cg_solve_xla``); 'fused' is
``ops/fermion_kernels.cg_solve_fused`` (K11, the whole solve in one
launch, on the card, its twin on the CPU); 'mixed' is
``ops/fermion_kernels.cg_solve_mixed`` (the counterpart of
``_cg_solve_mixed``: fp32 refinement cycles, each a K9 / K10 residual and
a K11_bf16 inner solve on the card, the twins on the CPU); 'auto', the
default, is 'fused' on the card and 'xla' on the CPU. On the card 'fused'
outside the kernels' envelope raises, where the JAX package falls back to
XLA unasked.

Spans (``utils.profiling.span``, open only under a profiler):
``fthmc.fermion.solve`` around ``cg_solve``, ``fthmc.fermion.force``
around ``pf_force_at`` and ``ratio_force_at``, ``fthmc.fermion.refresh``
around the heatbaths.

Also here: Hasenbusch mass preconditioning (``hasenbusch_refresh``,
``ratio_action_lin``, ``ratio_action_exact``), the dense operator and the
exact two-flavour log-determinant (``dirac_dense``, ``logdet_mdagm``), and
the observables ``chiral_condensate`` and ``pion_correlator``, whose
solves go through ``cg_solve``.
"""
from __future__ import annotations

import math

import torch

from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.ops.fermion_kernels import (CGResult, cg_solve_fused,
                                                  cg_solve_mixed)
from fthmc_tpu_torch.utils.profiling import span

__all__ = ["dirac", "dirac_dag", "apply_mdagm", "cg_solve", "set_cg_backend",
           "pf_refresh", "pf_refresh_from", "pf_action_exact",
           "pf_action_lin", "pf_force", "pf_force_at", "CGResult",
           "parity_mask", "dirac_hat", "dirac_hat_dag", "apply_mdagm_eo",
           "CG_BACKENDS", "CGLog", "dirac_dense", "logdet_mdagm",
           "chiral_condensate", "chiral_condensate_from", "pion_correlator",
           "hasenbusch_refresh", "hasenbusch_refresh_from",
           "ratio_action_lin", "ratio_action_exact", "ratio_force_at"]

CG_BACKENDS = ("auto", "xla", "fused", "mixed")


def _links(theta: torch.Tensor):
    """Effective complex links (u0, u1), each (..., L0, L1) complex64, with
    the antiperiodic time boundary folded into u0's last time slice."""
    u = torch.exp(1j * theta.to(torch.float32))
    u0, u1 = u[..., 0, :, :], u[..., 1, :, :]
    L0 = theta.shape[-2]
    sign = torch.ones((L0, 1), dtype=torch.float32, device=theta.device)
    sign[L0 - 1] = -1.0
    return u0 * sign, u1


def _hop(theta: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """The Wilson hop sum H psi (D = (m + 2) psi - H psi / 2), in the
    half-spinor form: each (1 -+ gamma_mu) is rank one, so each direction
    moves one complex plane (p0m = (d, -d), p0p = (e, e), p1m = (w, -i w),
    p1p = (v, i v))."""
    u0, u1 = _links(theta)
    s0, s1 = psi[..., 0], psi[..., 1]
    d = u0 * torch.roll(s0 - s1, -1, dims=-2)
    e = torch.roll(u0.conj() * (s0 + s1), 1, dims=-2)
    w = u1 * torch.roll(s0 + 1j * s1, -1, dims=-1)
    v = torch.roll(u1.conj() * (s0 - 1j * s1), 1, dims=-1)
    h0 = d + e + w + v
    h1 = -d + e - 1j * w + 1j * v
    return torch.stack((h0, h1), dim=-1)


def dirac(theta: torch.Tensor, psi: torch.Tensor, mass: float):
    """D(theta) psi; theta (..., 2, L0, L1), psi (..., L0, L1, 2)."""
    return (mass + 2.0) * psi - 0.5 * _hop(theta, psi)


def _g5(psi: torch.Tensor) -> torch.Tensor:
    """gamma_5 psi (gamma_5 = sigma_z)."""
    return torch.stack((psi[..., 0], -psi[..., 1]), dim=-1)


def dirac_dag(theta, psi, mass: float):
    """D^dag psi = gamma_5 D gamma_5 psi."""
    return _g5(dirac(theta, _g5(psi), mass))


def apply_mdagm(theta, psi, mass: float):
    """M psi, M = D^dag D (hermitian positive definite)."""
    return dirac_dag(theta, dirac(theta, psi, mass), mass)


def _cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-chain <a, b> over the last three axes: (..., L0, L1, 2) -> (...)."""
    return (a.conj() * b).sum(dim=(-3, -2, -1))


def parity_mask(shape, parity: int = 0, device=None) -> torch.Tensor:
    """(L0, L1, 1) fp32 mask of the sites with (x0 + x1) % 2 == parity, for
    a field of shape (..., L0, L1, 2), on ``device`` (the card by
    default)."""
    L0, L1 = shape[-3], shape[-2]
    dev = resolve_device(device)
    p = (torch.arange(L0, device=dev)[:, None]
         + torch.arange(L1, device=dev)[None, :]) % 2
    return (p == parity).to(torch.float32)[..., None]


def dirac_hat(theta, psi_e, mass: float):
    """Schur complement Dhat psi_e = (m + 2) psi_e - D_eo D_oe psi_e /
    (m + 2) on even-masked fields (hop to odd, hop back, / 4)."""
    me = parity_mask(psi_e.shape, 0, psi_e.device)
    mo = 1.0 - me
    h = me * _hop(theta, mo * _hop(theta, psi_e))
    return (mass + 2.0) * psi_e - 0.25 / (mass + 2.0) * h


def dirac_hat_dag(theta, psi_e, mass: float):
    """Dhat^dag = gamma_5 Dhat gamma_5."""
    return _g5(dirac_hat(theta, _g5(psi_e), mass))


def apply_mdagm_eo(theta, psi_e, mass: float):
    """Mhat psi = Dhat^dag Dhat psi on the even subspace."""
    return dirac_hat_dag(theta, dirac_hat(theta, psi_e, mass), mass)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

_CG_BACKEND = "auto"


def set_cg_backend(name: str) -> None:
    """Process-wide default of ``cg_solve``'s backend (see the module
    docstring); a call's ``cg_solve(backend=)`` overrides it."""
    global _CG_BACKEND
    if name not in CG_BACKENDS:
        raise ValueError(f"unknown cg backend {name!r}; one of "
                         f"{CG_BACKENDS}")
    _CG_BACKEND = name


def resolve_cg_backend(backend: str | None, device) -> str:
    """'xla', 'fused' or 'mixed' for a solve on ``device``."""
    backend = backend or _CG_BACKEND
    if backend not in CG_BACKENDS:
        raise ValueError(f"unknown cg backend {backend!r}; one of "
                         f"{CG_BACKENDS}")
    if backend == "auto":
        return "fused" if torch.device(device).type == "cuda" else "xla"
    return backend


class CGLog:
    """Iterations of the solves a run makes, by kind ('force' and 'mh'; the
    Hasenbusch sampler's 'refresh', 'heavy' and 'ratio' too), for a caller
    that passes one: each entry (iters, launched, reads)."""

    def __init__(self):
        self.solves: dict[str, list[tuple[int, int, int]]] = {"force": [],
                                                              "mh": []}

    def add(self, kind: str, res: CGResult) -> None:
        self.solves.setdefault(kind, []).append((res.iters, res.launched,
                                                 res.reads))

    def mean_iters(self, kind: str) -> float:
        s = self.solves.get(kind, [])
        return sum(e[0] for e in s) / max(len(s), 1)

    def launched(self) -> int:
        return sum(e[1] for s in self.solves.values() for e in s)

    def reads(self) -> int:
        """The solves' host reads of the device's state, in all."""
        return sum(e[2] for s in self.solves.values() for e in s)

    def count(self) -> int:
        return sum(len(s) for s in self.solves.values())


def _cg_loop(op, b, x0, tol: float, maxiter: int, dot) -> CGResult:
    """The batched CG on ``op`` (the operator) and ``dot`` (the per-chain
    inner product): converged chains freeze (alpha = beta = 0); the host
    reads the stop test every iteration."""
    bsq = dot(b, b).real
    stop = tol * bsq
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - op(x)
    p = r
    rsq = dot(r, r).real
    k = 0
    while k < maxiter and bool((rsq > stop).any()):
        active = rsq > stop
        mp = op(p)
        denom = dot(p, mp).real
        alpha = torch.where(active, rsq / torch.clamp_min(denom, 1e-30), 0.0)
        al = alpha[..., None, None, None].to(b.dtype)
        x = x + al * p
        r = r - al * mp
        rsq_new = dot(r, r).real
        beta = torch.where(active, rsq_new / torch.clamp_min(rsq, 1e-30),
                           0.0)
        p = r + beta[..., None, None, None].to(b.dtype) * p
        rsq = torch.where(active, rsq_new, rsq)
        k += 1
    return CGResult(x, k, rsq / torch.clamp_min(bsq, 1e-30), k, k + 1)


@torch.no_grad()
def _cg_solve_xla(theta, b, mass: float, x0=None, *, tol: float = 1e-8,
                  maxiter: int = 1000, eo: bool = False) -> CGResult:
    """The torch complex CG, the counterpart of ``_cg_solve_xla``."""
    apply = apply_mdagm_eo if eo else apply_mdagm
    return _cg_loop(lambda p: apply(theta, p, mass), b, x0, tol, maxiter,
                    _cdot)


def cg_solve(theta, b, mass: float, x0=None, *, tol: float = 1e-8,
             maxiter: int = 1000, eo: bool = False,
             backend: str | None = None, layout: str = "auto") -> CGResult:
    """Batched CG for (D^dag D) x = b, or with eo the Schur system on
    even-masked b. tol is on |r|^2 / |b|^2. ``backend`` overrides the
    process default (``set_cg_backend``); ``layout`` ('auto', 'cf', 'cl')
    is the packed planes' layout for 'fused' and 'mixed'. The span
    ``fthmc.fermion.solve``."""
    backend = resolve_cg_backend(backend, b.device)
    theta = theta.detach()
    with span("fthmc.fermion.solve"):
        if backend in ("fused", "mixed"):
            solve = cg_solve_fused if backend == "fused" else cg_solve_mixed
            return solve(theta, b, mass, x0, tol=tol, maxiter=maxiter,
                         eo=eo, layout=layout)
        return _cg_solve_xla(theta, b, mass, x0, tol=tol, maxiter=maxiter,
                             eo=eo)


# ---------------------------------------------------------------------------
# pseudofermions
# ---------------------------------------------------------------------------

def pf_refresh_from(chi: torch.Tensor, theta, mass: float, eo: bool = False):
    """phi = D^dag chi (eo: chi even-masked, phi = Dhat^dag chi) and its
    exact start action s0 = chi^dag chi, per chain. chi: (..., L0, L1, 2)
    complex, drawn CN(0, 1) by the caller. The span
    ``fthmc.fermion.refresh``."""
    theta = theta.detach()
    chi = chi.to(torch.complex64)
    with torch.no_grad(), span("fthmc.fermion.refresh"):
        if eo:
            chi = chi * parity_mask(chi.shape, 0, chi.device)
            phi = dirac_hat_dag(theta, chi, mass)
        else:
            phi = dirac_dag(theta, chi, mass)
        return phi, _cdot(chi, chi).real


def pf_refresh(generator: torch.Generator, theta, mass: float,
               eo: bool = False):
    """Pseudofermion heatbath at fixed theta: chi ~ CN(0, 1) per component
    (its real parts, then its imaginary parts, from ``generator``), then
    ``pf_refresh_from``. Returns (phi, s0)."""
    shape = theta.shape[:-3] + theta.shape[-2:] + (2,)
    re = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
    im = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
    chi = (torch.complex(re, im) * math.sqrt(0.5)).to(theta.device)
    return pf_refresh_from(chi, theta, mass, eo)


def pf_action_exact(theta, phi, mass: float, *, tol: float = 1e-10,
                    maxiter: int = 2000, x0=None, eo: bool = False,
                    backend: str | None = None, layout: str = "auto"):
    """S_pf = phi^dag M^{-1} phi from a tight CG solve (the Metropolis
    accept rests on it). Returns (s, CGResult)."""
    res = cg_solve(theta, phi, mass, x0, tol=tol, maxiter=maxiter, eo=eo,
                   backend=backend, layout=layout)
    return _cdot(phi, res.x).real, res


def pf_action_lin(theta, phi, x_sol, mass: float, eo: bool = False):
    """The variational form 2 Re<X, phi> - <X, M(theta) X> with X =
    x_sol held fixed: equal to S_pf at the exact solution, and its gradient
    in theta is the exact fermion force."""
    op = apply_mdagm_eo if eo else apply_mdagm
    xs = x_sol.detach()
    return 2.0 * _cdot(xs, phi).real - _cdot(xs, op(theta, xs, mass)).real


def pf_force_at(theta, phi, x_sol, mass: float, eo: bool = False):
    """d/dtheta of sum(pf_action_lin) at fixed X by torch.autograd (per
    chain, since chains do not couple), in theta's dtype. The span
    ``fthmc.fermion.force``."""
    with torch.enable_grad(), span("fthmc.fermion.force"):
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            pf_action_lin(th, phi, x_sol, mass, eo).sum(), th)
    return g


def pf_force(theta, phi, mass: float, *, tol: float = 1e-8,
             maxiter: int = 1000, x0=None, eo: bool = False,
             backend: str | None = None, layout: str = "auto"):
    """Fermion force dS_pf/dtheta and the CG result (for warm starts)."""
    res = cg_solve(theta, phi, mass, x0, tol=tol, maxiter=maxiter, eo=eo,
                   backend=backend, layout=layout)
    return pf_force_at(theta, phi, res.x, mass, eo), res


# ---------------------------------------------------------------------------
# the dense operator and the exact log-determinant
# ---------------------------------------------------------------------------

def dirac_dense(theta: torch.Tensor, mass: float) -> torch.Tensor:
    """The Wilson operator of one configuration theta (2, L0, L1) as a real
    (2n, 2n) matrix, the real representation [[Re D, -Im D], [Im D, Re
    D]] of the complex (n, n) D, n = 2 L0 L1: det of it is |det D|^2 =
    det(D^dag D). Batched theta (..., 2, L0, L1) gives (..., 2n, 2n).
    O(n^2) storage: the training volume (n = 128 at 8^2) only."""
    L0, L1 = theta.shape[-2:]
    n = 2 * L0 * L1
    basis = torch.eye(n, dtype=torch.complex64, device=theta.device)
    cols = dirac(theta[..., None, :, :, :], basis.reshape(n, L0, L1, 2),
                 mass)                                 # row j = D e_j
    d = cols.reshape(cols.shape[:-3] + (n,)).transpose(-1, -2)
    return torch.cat((torch.cat((d.real, -d.imag), dim=-1),
                      torch.cat((d.imag, d.real), dim=-1)), dim=-2)


def logdet_mdagm(theta: torch.Tensor, mass: float) -> torch.Tensor:
    """ln det(D^dag D) per configuration, theta (..., 2, L0, L1) -> (...):
    the exact two-flavour fermion log-determinant through the dense real
    representation and ``torch.linalg.slogdet`` (differentiable, twice
    too). Dense: the training volume only, never in samplers."""
    return torch.linalg.slogdet(dirac_dense(theta, mass)).logabsdet


# ---------------------------------------------------------------------------
# observables
# ---------------------------------------------------------------------------

def _noise(generator: torch.Generator, shape) -> torch.Tensor:
    """CN(0, 1) complex64 noise of ``shape`` (real parts, then imaginary)."""
    re = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
    im = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
    return torch.complex(re, im) * math.sqrt(0.5)


def chiral_condensate_from(eta: torch.Tensor, theta: torch.Tensor,
                           mass: float, *, tol: float = 1e-8,
                           maxiter: int = 2000) -> torch.Tensor:
    """<psibar psi> = (1/V) Tr D^{-1} per chain, estimated on the noise eta
    (n_noise, ..., L0, L1, 2): mean over the noises of Re<eta, D^{-1} eta>
    / (2 L0 L1), with D^{-1} eta = M^{-1} D^dag eta from ``cg_solve`` (all
    noises in one batched solve, each chain frozen at its own
    convergence)."""
    theta = theta.detach()
    n, lead = eta.shape[0], theta.shape[:-3]
    th = theta.expand((n,) + tuple(theta.shape)).reshape((-1,)
                                                         + theta.shape[-3:])
    e = eta.to(torch.complex64).reshape((-1,) + eta.shape[-3:])
    res = cg_solve(th, dirac_dag(th, e, mass), mass, tol=tol,
                   maxiter=maxiter)
    vals = _cdot(e, res.x).real.reshape((n,) + tuple(lead))
    return vals.mean(dim=0) / (2 * theta.shape[-2] * theta.shape[-1])


def chiral_condensate(generator: torch.Generator, theta: torch.Tensor,
                      mass: float, *, n_noise: int = 8, tol: float = 1e-8,
                      maxiter: int = 2000) -> torch.Tensor:
    """Stochastic <psibar psi> per chain on n_noise Gaussian noise vectors
    drawn from ``generator`` (each noise's real parts, then its imaginary
    parts), through ``chiral_condensate_from``."""
    shape = theta.shape[:-3] + theta.shape[-2:] + (2,)
    eta = torch.stack([_noise(generator, shape) for _ in range(n_noise)])
    return chiral_condensate_from(eta.to(theta.device), theta, mass, tol=tol,
                                  maxiter=maxiter)


def pion_correlator(theta: torch.Tensor, mass: float, *, tol: float = 1e-10,
                    maxiter: int = 2000) -> torch.Tensor:
    """Zero-momentum pion correlator C(t) = sum_{x1, spins} |S(x; 0)|^2
    from a point source at the origin, S = D^{-1} e_s = M^{-1} D^dag e_s
    (both spin columns in one batched ``cg_solve``); time is axis 0.
    theta (B, 2, L0, L1) -> (B, L0); (2, L0, L1) -> (L0,)."""
    theta = theta.detach()
    lead = theta.shape[:-3]
    L0, L1 = theta.shape[-2:]
    th = theta.reshape((-1,) + theta.shape[-3:])
    nb = th.shape[0]
    src = torch.zeros((2, nb, L0, L1, 2), dtype=torch.complex64,
                      device=theta.device)
    src[0, :, 0, 0, 0] = 1.0
    src[1, :, 0, 0, 1] = 1.0
    th2 = th.expand((2,) + tuple(th.shape)).reshape((-1,) + th.shape[1:])
    src = src.reshape((-1, L0, L1, 2))
    res = cg_solve(th2, dirac_dag(th2, src, mass), mass, tol=tol,
                   maxiter=maxiter)
    dens = (res.x.abs() ** 2).reshape((2, nb, L0, L1, 2)).sum(dim=(0, -1))
    return dens.sum(dim=-1).reshape(tuple(lead) + (L0,))


# ---------------------------------------------------------------------------
# Hasenbusch mass preconditioning (hep-lat/0107019): det(D^dag D) =
# det(W^dag W) det(R^-1), W = D(m1), m1 = m + dm, R = W M^-1 W^dag, as a
# heavy term S1 = phi1^dag (W^dag W)^-1 phi1 (pf_action_* at m1) and a
# ratio term S2 = phi2^dag W M^-1 W^dag phi2 (light solves, an O(dm) force)
# ---------------------------------------------------------------------------

def _dagger_apply(theta, psi, mass: float, eo: bool):
    return (dirac_hat_dag if eo else dirac_dag)(theta, psi, mass)


def _apply(theta, psi, mass: float, eo: bool):
    return (dirac_hat if eo else dirac)(theta, psi, mass)


def hasenbusch_refresh_from(chi1: torch.Tensor, chi2: torch.Tensor, theta,
                            m_light: float, m_heavy: float, *,
                            tol: float = 1e-12, maxiter: int = 1000,
                            eo: bool = False, layout: str = "auto"):
    """The heatbath of both Hasenbusch terms on the caller's chi1, chi2
    (CN(0, 1), (..., L0, L1, 2); eo: masked to the even sites here): phi1
    = W^dag chi1, phi2 = W (W^dag W)^-1 D^dag chi2 (one heavy solve), so
    that S1 + S2 at the start is s0 = |chi1|^2 + |chi2|^2 exactly. Returns
    (phi1, phi2, s0, the heavy solve's CGResult). The span
    ``fthmc.fermion.refresh``."""
    theta = theta.detach()
    chi1, chi2 = chi1.to(torch.complex64), chi2.to(torch.complex64)
    with torch.no_grad(), span("fthmc.fermion.refresh"):
        if eo:
            mask = parity_mask(chi1.shape, 0, chi1.device)
            chi1, chi2 = chi1 * mask, chi2 * mask
        phi1 = _dagger_apply(theta, chi1, m_heavy, eo)
        rhs = _dagger_apply(theta, chi2, m_light, eo)
        res = cg_solve(theta, rhs, m_heavy, tol=tol, maxiter=maxiter, eo=eo,
                       layout=layout)
        phi2 = _apply(theta, res.x, m_heavy, eo)
        s0 = _cdot(chi1, chi1).real + _cdot(chi2, chi2).real
    return phi1, phi2, s0, res


def hasenbusch_refresh(generator: torch.Generator, theta, m_light: float,
                       m_heavy: float, *, tol: float = 1e-12,
                       maxiter: int = 1000, eo: bool = False,
                       layout: str = "auto"):
    """``hasenbusch_refresh_from`` on chi1 and chi2 drawn from
    ``generator`` in JAX's order: chi1's real parts, its imaginary parts,
    then chi2's."""
    shape = theta.shape[:-3] + theta.shape[-2:] + (2,)
    chi1 = _noise(generator, shape).to(theta.device)
    chi2 = _noise(generator, shape).to(theta.device)
    return hasenbusch_refresh_from(chi1, chi2, theta, m_light, m_heavy,
                                   tol=tol, maxiter=maxiter, eo=eo,
                                   layout=layout)


def ratio_action_lin(theta, phi2, y_sol, m_light: float, m_heavy: float,
                     eo: bool = False):
    """The variational form of the ratio action, 2 Re<Y, b(theta)> - <Y,
    M(theta) Y> with b = W^dag(theta) phi2 and Y = y_sol held fixed: S2 at
    the exact solve, and its gradient the exact ratio force (both the W^dag
    and the M dependence)."""
    op = apply_mdagm_eo if eo else apply_mdagm
    y = y_sol.detach()
    b = _dagger_apply(theta, phi2, m_heavy, eo)
    return 2.0 * _cdot(y, b).real - _cdot(y, op(theta, y, m_light)).real


def ratio_action_exact(theta, phi2, m_light: float, m_heavy: float, *,
                       tol: float = 1e-12, maxiter: int = 2000, x0=None,
                       eo: bool = False, layout: str = "auto"):
    """S2 = (W^dag phi2)^dag M^-1 (W^dag phi2) from a tight light solve.
    Returns (s2, CGResult)."""
    with torch.no_grad():
        b = _dagger_apply(theta.detach(), phi2, m_heavy, eo)
    res = cg_solve(theta, b, m_light, x0, tol=tol, maxiter=maxiter, eo=eo,
                   layout=layout)
    return _cdot(b, res.x).real, res


def ratio_force_at(theta, phi2, y_sol, m_light: float, m_heavy: float,
                   eo: bool = False):
    """d/dtheta of sum(ratio_action_lin) at fixed Y by torch.autograd, in
    theta's dtype. The span ``fthmc.fermion.force``."""
    with torch.enable_grad(), span("fthmc.fermion.force"):
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            ratio_action_lin(th, phi2, y_sol, m_light, m_heavy, eo).sum(),
            th)
    return g
