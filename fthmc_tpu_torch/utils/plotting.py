"""History plots and training diagnostics (matplotlib, imported only
where a plot is drawn).

The port's copy of ``fthmc_tpu/utils/plotting.py``: metric histories with
a thermalization cut, thinning and a multi-chain overlay; the S against
-log q regression of a trained flow; ``therm_arr`` and ``moving_average``;
``LiveJointPlot``, the twin-axis loss/ESS monitor (IPython display-handle
updates in a notebook, a throttled PNG headless). Histories may hold torch
tensors on any device.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["therm_arr", "plot_metric", "plot_history",
           "plot_action_logq_regression", "moving_average", "LiveJointPlot"]


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def therm_arr(x: np.ndarray, therm_frac: float = 0.2, thin: int = 0):
    """Drop the first therm_frac of a series and optionally thin it; returns
    (steps, values). (reference plot_helpers.py:59-71)"""
    x = _host(x)
    n0 = int(len(x) * therm_frac)
    x = x[n0:]
    steps = np.arange(n0, n0 + len(x))
    if thin and thin > 1:
        x, steps = x[::thin], steps[::thin]
    return steps, x


def plot_metric(y, *, key: str = "", therm_frac: float = 0.2, thin: int = 0,
                num_chains: int = 4, outdir: str | None = None,
                xlabel: str = "step", title: str = ""):
    """Plot one metric history (optionally (N, chains) -> overlay first
    `num_chains` chains + mean). (reference plot_helpers.py:122-198)"""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps, y = therm_arr(y, therm_frac, thin)
    fig, ax = plt.subplots(figsize=(6, 3), constrained_layout=True)
    if y.ndim == 2:
        for c in range(min(num_chains, y.shape[1])):
            ax.plot(steps, y[:, c], alpha=0.4, lw=0.8)
        ax.plot(steps, y.mean(axis=1), color="k", lw=1.2, label="mean")
        ax.legend(loc="best", fontsize=8)
    else:
        ax.plot(steps, y, lw=0.9)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(key)
    if title:
        ax.set_title(title, fontsize=9)
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        fname = os.path.join(outdir, f"{key or 'metric'}.png")
        fig.savefig(fname, dpi=120)
        plt.close(fig)
        return fname
    return fig


def plot_history(history: dict, *, therm_frac: float = 0.2, thin: int = 0,
                 num_chains: int = 4, outdir: str | None = None,
                 xlabel: str = "step", skip: tuple[str, ...] = (),
                 title: str = ""):
    """Plot every metric in a history dict to outdir.
    (reference plot_helpers.py:201-258)"""
    out = {}
    for key, val in history.items():
        if key in skip:
            continue
        try:
            arr = np.asarray(_host(val), dtype=np.float64)
        except (TypeError, ValueError):
            continue
        if arr.ndim == 0 or len(arr) < 2:
            continue
        out[key] = plot_metric(arr, key=key, therm_frac=therm_frac,
                               thin=thin, num_chains=num_chains,
                               outdir=outdir, xlabel=xlabel, title=title)
    return out


def moving_average(x: np.ndarray, window: int = 15) -> np.ndarray:
    """Trailing moving average; shorter-than-window series pass through.
    (reference plot_helpers.py moving_average + use in :444-481)"""
    x = np.asarray(_host(x), np.float64)
    if window <= 1 or len(x) < window:
        return x
    c = np.cumsum(np.concatenate(([0.0], x)))
    return (c[window:] - c[:-window]) / window


def _in_notebook() -> bool:
    try:
        from IPython import get_ipython
        ip = get_ipython()
        return ip is not None and "IPKernelApp" in getattr(ip, "config", {})
    except ImportError:
        return False


class LiveJointPlot:
    """Live twin-axis training monitor (loss left, ESS right).

    Behavior parity with the reference's init_live_joint_plots /
    update_joint_plots (plot_helpers.py:287-343,:444-481): two moving-average
    curves on one figure updated in place each call. Re-designed for this
    framework: in a notebook the figure updates through an IPython display
    handle; headless it re-saves a PNG at most every `save_every` updates -
    so the SAME call sites work in both environments (the reference's is
    notebook-only).

    >>> lp = LiveJointPlot(outdir="runs/x")   # or outdir=None in a notebook
    >>> for era in ...:
    ...     lp.update(loss=hist["loss_dkl"], ess=hist["ess"])
    """

    def __init__(self, ylabels=("loss_dkl", "ESS"), *, window: int = 15,
                 xlabel: str = "epoch", outdir: str | None = None,
                 fname: str = "live_training.png", save_every: int = 1,
                 title: str = ""):
        import matplotlib
        if not _in_notebook():
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.window = window
        self.outdir = outdir
        self.fname = fname
        self.save_every = max(1, save_every)
        self._n_updates = 0
        self.fig, self.ax0 = plt.subplots(figsize=(6, 3),
                                          constrained_layout=True)
        self.ax1 = self.ax0.twinx()
        (self.line0,) = self.ax0.plot([], [], c="C0", alpha=0.9)
        (self.line1,) = self.ax1.plot([], [], c="C1", alpha=0.9)
        self.ax0.set_ylabel(ylabels[0], color="C0")
        self.ax1.set_ylabel(ylabels[1], color="C1")
        self.ax0.tick_params(axis="y", labelcolor="C0")
        self.ax1.tick_params(axis="y", labelcolor="C1")
        self.ax0.set_xlabel(xlabel)
        if title:
            self.fig.suptitle(title, fontsize=9)
        self._display = None
        if _in_notebook():
            from IPython.display import display
            self._display = display(self.fig, display_id=True)

    def update(self, loss, ess) -> None:
        """Redraw both curves from the FULL histories (chain axes are
        averaged away; moving-average smoothing as in the reference)."""
        for line, ax, data in ((self.line0, self.ax0, loss),
                               (self.line1, self.ax1, ess)):
            y = np.asarray(_host(data), np.float64).squeeze()
            if y.ndim == 2:
                y = y.mean(-1)
            y = moving_average(np.atleast_1d(y), self.window)
            line.set_data(np.arange(len(y)), y)
            ax.relim()
            ax.autoscale_view()
        self._n_updates += 1
        if self._display is not None:
            self.fig.canvas.draw()
            self._display.update(self.fig)
        elif (self.outdir is not None
              and self._n_updates % self.save_every == 0):
            os.makedirs(self.outdir, exist_ok=True)
            self.fig.savefig(os.path.join(self.outdir, self.fname), dpi=120)

    def close(self):
        import matplotlib.pyplot as plt
        plt.close(self.fig)


def plot_action_logq_regression(S: np.ndarray, logq: np.ndarray,
                                outdir: str | None = None):
    """S vs -logq scatter with a least-squares fit; a well-trained flow has
    slope ~1 (self-consistency diagnostic, reference plot_helpers.py:484-514).
    Returns (slope, intercept[, figure path])."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    S = np.asarray(_host(S), np.float64).ravel()
    nlq = -np.asarray(_host(logq), np.float64).ravel()
    slope, intercept = np.polyfit(nlq, S, 1)
    fig, ax = plt.subplots(figsize=(4, 4), constrained_layout=True)
    ax.plot(nlq, S, ".", ms=2, alpha=0.5)
    xs = np.linspace(nlq.min(), nlq.max(), 10)
    ax.plot(xs, slope * xs + intercept, "r-", lw=1,
            label=f"fit: slope={slope:.3f}")
    ax.set_xlabel(r"$-\log q$")
    ax.set_ylabel(r"$S$")
    ax.legend(fontsize=8)
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        fname = os.path.join(outdir, "action_vs_logq.png")
        fig.savefig(fname, dpi=120)
        plt.close(fig)
        return slope, intercept, fname
    return slope, intercept, fig
