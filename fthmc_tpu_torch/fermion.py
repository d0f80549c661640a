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
launch, on the card, its twin on the CPU); 'auto', the default, is
'fused' on the card and 'xla' on the CPU. On the card 'fused' outside the kernels' envelope
raises, where the JAX package falls back to XLA unasked. 'mixed' is not
ported yet.
"""
from __future__ import annotations

import math

import torch

from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.ops.fermion_kernels import CGResult, cg_solve_fused

__all__ = ["dirac", "dirac_dag", "apply_mdagm", "cg_solve", "set_cg_backend",
           "pf_refresh", "pf_refresh_from", "pf_action_exact",
           "pf_action_lin", "pf_force", "pf_force_at", "CGResult",
           "parity_mask", "dirac_hat", "dirac_hat_dag", "apply_mdagm_eo",
           "CG_BACKENDS", "CGLog"]

CG_BACKENDS = ("auto", "xla", "fused", "mixed")
_MIXED_TODO = ("cg backend 'mixed' (bf16 inner CG with fp32 refinement) is "
               "not ported yet: ROADMAP queue 1, 'dynamical fermions, the "
               "rest'")


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
    """'xla' or 'fused' for a solve on ``device``."""
    backend = backend or _CG_BACKEND
    if backend not in CG_BACKENDS:
        raise ValueError(f"unknown cg backend {backend!r}; one of "
                         f"{CG_BACKENDS}")
    if backend == "mixed":
        raise NotImplementedError(_MIXED_TODO)
    if backend == "auto":
        return "fused" if torch.device(device).type == "cuda" else "xla"
    return backend


class CGLog:
    """Iterations of the solves a run makes, by kind ('force' or 'mh'), for
    a caller that passes one: each entry (iters, launched)."""

    def __init__(self):
        self.solves: dict[str, list[tuple[int, int]]] = {"force": [],
                                                         "mh": []}

    def add(self, kind: str, res: CGResult) -> None:
        self.solves[kind].append((res.iters, res.launched))

    def mean_iters(self, kind: str) -> float:
        s = self.solves[kind]
        return sum(i for i, _ in s) / max(len(s), 1)

    def launched(self) -> int:
        return sum(n for s in self.solves.values() for _, n in s)

    def count(self) -> int:
        return sum(len(s) for s in self.solves.values())


@torch.no_grad()
def _cg_solve_xla(theta, b, mass: float, x0=None, *, tol: float = 1e-8,
                  maxiter: int = 1000, eo: bool = False) -> CGResult:
    """The torch complex CG, the counterpart of ``_cg_solve_xla``: converged
    chains freeze (alpha = beta = 0); the host checks every iteration."""
    op = apply_mdagm_eo if eo else apply_mdagm
    bsq = _cdot(b, b).real
    stop = tol * bsq
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - op(theta, x, mass)
    p = r
    rsq = _cdot(r, r).real
    k = 0
    while k < maxiter and bool((rsq > stop).any()):
        active = rsq > stop
        mp = op(theta, p, mass)
        denom = _cdot(p, mp).real
        alpha = torch.where(active, rsq / torch.clamp_min(denom, 1e-30), 0.0)
        al = alpha[..., None, None, None].to(b.dtype)
        x = x + al * p
        r = r - al * mp
        rsq_new = _cdot(r, r).real
        beta = torch.where(active, rsq_new / torch.clamp_min(rsq, 1e-30),
                           0.0)
        p = r + beta[..., None, None, None].to(b.dtype) * p
        rsq = torch.where(active, rsq_new, rsq)
        k += 1
    return CGResult(x, k, rsq / torch.clamp_min(bsq, 1e-30), k)


def cg_solve(theta, b, mass: float, x0=None, *, tol: float = 1e-8,
             maxiter: int = 1000, eo: bool = False,
             backend: str | None = None, layout: str = "auto") -> CGResult:
    """Batched CG for (D^dag D) x = b, or with eo the Schur system on
    even-masked b. tol is on |r|^2 / |b|^2. ``backend`` overrides the
    process default (``set_cg_backend``); ``layout`` ('auto', 'cf', 'cl')
    is the packed planes' layout for 'fused'."""
    backend = resolve_cg_backend(backend, b.device)
    theta = theta.detach()
    if backend == "fused":
        return cg_solve_fused(theta, b, mass, x0, tol=tol, maxiter=maxiter,
                              eo=eo, layout=layout)
    return _cg_solve_xla(theta, b, mass, x0, tol=tol, maxiter=maxiter, eo=eo)


# ---------------------------------------------------------------------------
# pseudofermions
# ---------------------------------------------------------------------------

def pf_refresh_from(chi: torch.Tensor, theta, mass: float, eo: bool = False):
    """phi = D^dag chi (eo: chi even-masked, phi = Dhat^dag chi) and its
    exact start action s0 = chi^dag chi, per chain. chi: (..., L0, L1, 2)
    complex, drawn CN(0, 1) by the caller."""
    theta = theta.detach()
    chi = chi.to(torch.complex64)
    with torch.no_grad():
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
    chain, since chains do not couple), in theta's dtype."""
    with torch.enable_grad():
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
