"""Quality metrics and physics observables.

Counterpart of ``fthmc_tpu/observables.py``. The training metrics (the
reverse KL estimate and the effective sample size) are torch and stay on
the tensors' device; the ensemble statistics (bootstrap, tau_int, blocked
dQ^2) are host-side numpy over finished runs, the JAX package's code with
the same numpy RNG seeding, so a bootstrap with the same seed gives the same
numbers in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from fthmc_tpu_torch.lattice import PLAQ_EXACT

__all__ = ["calc_dkl", "calc_ess", "bootstrap", "topo_susceptibility",
           "tau_int", "tau_int_err", "chain_stats", "blocked_dq_sq_vs_dt",
           "acceptance_rate", "creutz_ratio", "string_tension_exact"]


# ---------------------------------------------------------------------------
# on the tensors' device
# ---------------------------------------------------------------------------

def calc_dkl(logp: torch.Tensor, logq: torch.Tensor) -> torch.Tensor:
    """Reverse KL estimate E_q[log q - log p] over the batch."""
    return torch.mean(logq - logp)


def calc_ess(logp: torch.Tensor, logq: torch.Tensor) -> torch.Tensor:
    """Normalized effective sample size of importance weights w = p/q,
    ESS = (sum w)^2 / (N sum w^2), computed in log space."""
    logw = logp - logq
    log_ess = (2.0 * torch.logsumexp(logw, dim=0)
               - torch.logsumexp(2.0 * logw, dim=0))
    return torch.exp(log_ess) / logw.shape[0]


# ---------------------------------------------------------------------------
# host-side ensemble statistics
# ---------------------------------------------------------------------------

def bootstrap(x: np.ndarray, *, nboot: int, binsize: int,
              rng: np.random.Generator | None = None):
    """Binned bootstrap mean/err: bins ``x`` along axis 0 into blocks of
    ``binsize`` (dropping the remainder at the front) and resamples blocks
    with replacement ``nboot`` times."""
    if rng is None:
        rng = np.random.default_rng(0)
    x = np.asarray(x)
    nbin = len(x) // binsize
    x = x[len(x) - nbin * binsize:].reshape(nbin, binsize, *x.shape[1:])
    boots = [
        np.mean(x[rng.integers(nbin, size=nbin)], axis=(0, 1))
        for _ in range(nboot)
    ]
    return float(np.mean(boots)), float(np.std(boots))


def topo_susceptibility(q: np.ndarray, *, nboot: int = 100, binsize: int = 16,
                        rng=None):
    """chi_Q = <Q^2> with its binned-bootstrap error."""
    return bootstrap(np.asarray(q) ** 2, nboot=nboot, binsize=binsize, rng=rng)


def acceptance_rate(acc: np.ndarray) -> float:
    return float(np.mean(np.asarray(acc, dtype=np.float64)))


def _tau_int_window(x: np.ndarray, c: float = 4.0,
                    max_lag: int | None = None) -> tuple[float, int]:
    """(tau_int, window W) with the Madras-Sokal automatic window
    (W = first lag where W >= c * tau_int(W)). x: 1D series."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = len(x)
    if n < 2 or np.allclose(x, 0.0):
        return 0.5, 0
    if max_lag is None:
        max_lag = n // 2
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n].real / np.arange(n, 0, -1)
    if acov[0] <= 0:
        return 0.5, 0
    rho = acov / acov[0]
    t = 0.5
    w_used = max_lag
    for w in range(1, max_lag):
        t += rho[w]
        if w >= c * t:
            w_used = w
            break
    return float(max(t, 0.5)), int(w_used)


def tau_int(x: np.ndarray, c: float = 4.0, max_lag: int | None = None) -> float:
    """Integrated autocorrelation time of a 1D series with the Madras-Sokal
    automatic window."""
    return _tau_int_window(x, c, max_lag)[0]


def tau_int_err(x: np.ndarray, c: float = 4.0,
                max_lag: int | None = None) -> tuple[float, float, int]:
    """(tau_int, stderr, window) of a 1D series; the error is the
    Madras-Sokal estimate var(tau) ~= (2 (2W + 1) / N) tau^2, valid for
    N >> tau."""
    x = np.asarray(x, dtype=np.float64)
    t, w = _tau_int_window(x, c, max_lag)
    n = len(x)
    err = t * np.sqrt(2.0 * (2.0 * w + 1.0) / max(n, 1))
    return t, float(err), w


def chain_stats(q: np.ndarray, *, n_boot: int = 400, seed: int = 0,
                therm_frac: float = 0.0, c: float = 4.0) -> dict:
    """Chain statistics of a (ntraj, n_chains) series (typically the
    topological charge) with errors from a bootstrap over the independent
    chains (one chain: the Madras-Sokal and binned-bootstrap errors).

    Returns {tau_int_q, tau_int_q_err, chi_q, chi_q_err, q_mobility_dt1,
    tau_window_mean, n_chains, ntraj_used, therm}.
    """
    q = np.asarray(q, dtype=np.float64)
    if q.ndim == 1:
        q = q[:, None]
    therm = int(q.shape[0] * therm_frac)
    q = q[therm:]
    nchain = q.shape[1]
    tw = [_tau_int_window(q[:, ch], c=c) for ch in range(nchain)]
    ti = np.array([t for t, _ in tw])
    chi = (q ** 2).mean(axis=0)
    rng = np.random.default_rng(seed)
    if nchain > 1:
        idx = rng.integers(0, nchain, size=(n_boot, nchain))
        ti_err = float(ti[idx].mean(axis=1).std(ddof=1))
        chi_err = float(chi[idx].mean(axis=1).std(ddof=1))
    else:
        ti_err = tau_int_err(q[:, 0], c=c)[1]
        chi_err = topo_susceptibility(q[:, 0])[1]
    dq2 = float(np.mean((q[1:] - q[:-1]) ** 2)) if q.shape[0] > 1 else 0.0
    return {
        "tau_int_q": float(ti.mean()),
        "tau_int_q_err": ti_err,
        "chi_q": float(chi.mean()),
        "chi_q_err": chi_err,
        "q_mobility_dt1": dq2,
        "tau_window_mean": float(np.mean([w for _, w in tw])),
        "n_chains": int(nchain),
        "ntraj_used": int(q.shape[0]),
        "therm": therm,
    }


def blocked_dq_sq_vs_dt(q: np.ndarray, dt_range: int = 10,
                        n_block: int = 16) -> list[tuple[int, float, float]]:
    """Blocked <(Q(t) - Q(t+dt))^2> against dt, the topological-mobility
    proxy: [(dt, mean, err), ...] for dt = 1..dt_range."""
    q = np.asarray(q, dtype=np.float64)
    out = []
    for dt in range(1, dt_range + 1):
        if len(q) <= dt:
            break
        d2 = (q[:-dt] - q[dt:]) ** 2
        nb = min(n_block, len(d2))
        size = max(len(d2) // nb, 1)
        nb = len(d2) // size
        blocks = d2[len(d2) - nb * size:].reshape(nb, size).mean(axis=1)
        mean = float(blocks.mean())
        err = (float(blocks.std(ddof=0) / np.sqrt(max(nb - 1, 1)))
               if nb > 1 else 0.0)
        out.append((dt, mean, err))
    return out


def creutz_ratio(W: np.ndarray, R: int, T: int) -> float:
    """Creutz ratio chi(R,T) = -log[W(R,T) W(R-1,T-1) / (W(R,T-1) W(R-1,T))]
    from a table of Wilson-loop expectations W[R][T]; in 2D U(1) it is
    -log(I1(beta)/I0(beta)) for all R, T."""
    W = np.asarray(W, dtype=np.float64)
    return float(-np.log(W[R, T] * W[R - 1, T - 1]
                         / (W[R, T - 1] * W[R - 1, T])))


def string_tension_exact(beta: float) -> float:
    """Exact 2D U(1) string tension sigma = -log(I1(beta)/I0(beta))."""
    if beta not in PLAQ_EXACT:
        raise KeyError(f"no exact plaquette tabulated for beta={beta}")
    return float(-np.log(PLAQ_EXACT[beta]))
