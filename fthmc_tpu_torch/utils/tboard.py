"""Optional TensorBoard summaries: scalars and histograms under the
'training/', 'inference/' and 'ftHMC/' prefixes, rows with NaNs dropped
before a histogram.

The port's copy of ``fthmc_tpu/utils/tboard.py``. TensorBoard is a side
output: where ``torch.utils.tensorboard`` cannot be imported, ``TBWriter``
writes nothing, and the JSONL stream of ``utils/logger.MetricsWriter``
stays the primary record. Values may be torch tensors on any device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TBWriter", "drop_nans"]


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def drop_nans(x) -> np.ndarray:
    """``x`` without the rows that hold a NaN or an inf (the elements, for
    a 1-D ``x``)."""
    x = _host(x)
    if x.ndim == 1:
        return x[np.isfinite(x)]
    mask = np.isfinite(x).all(axis=tuple(range(1, x.ndim)))
    return x[mask]


class TBWriter:
    """A SummaryWriter at ``logdir``, or nothing when tensorboard is not
    installed."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(log_dir=logdir)

    def write(self, metrics: dict, step: int, prefix: str = "training"):
        """A scalar (the mean) for each 0- or 1-dim value, a histogram of
        the finite rows for each value of 2 or more dims; 'traj' is
        skipped."""
        if self._w is None:
            return
        for key, val in metrics.items():
            if key == "traj":
                continue
            arr = _host(val)
            tag = f"{prefix}/{key}"
            if arr.ndim > 1:
                arr = drop_nans(arr)
                if arr.size:
                    self._w.add_histogram(tag, arr, global_step=step)
            else:
                v = float(np.mean(arr))
                if np.isfinite(v):
                    self._w.add_scalar(tag, v, global_step=step)

    def close(self):
        if self._w is not None:
            self._w.close()
