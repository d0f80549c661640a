"""Console and JSONL metric logging.

The port's own copy of ``fthmc_tpu/utils/logger.py`` (numpy only): metric
lines of key=value with 4-significant-figure floats and optional trailing
window means, a box-table renderer, ANSI styling only on a TTY without
NO_COLOR, and a JSONL metrics writer (one {"step": n, ...} object a line;
TensorBoard is the optional side output of ``utils/tboard.py``). A value
may be a number, a numpy array or a torch tensor on any device: arrays are
reduced to their mean.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any

import numpy as np

__all__ = ["Logger", "MetricsWriter", "format_metrics", "supports_color",
           "colorize", "format_table"]


# ---------------------------------------------------------------------------
# Console presentation (reference fthmc/utils/logger.py:162-283: rich-console
# tables/colored metric lines with a plain-Console fallback). Dependency-free
# equivalent: ANSI styling gated on TTY detection (the same degrade-to-plain
# behavior as the reference's `Console` fallback), and a box-drawing table
# renderer for the information rich.table carried.
# ---------------------------------------------------------------------------

_ANSI = {"dim": "\033[2m", "bold": "\033[1m", "red": "\033[31m",
         "green": "\033[32m", "yellow": "\033[33m", "blue": "\033[34m",
         "magenta": "\033[35m", "cyan": "\033[36m", "reset": "\033[0m"}


def supports_color(stream: IO | None = None) -> bool:
    """ANSI only on a TTY and when NO_COLOR is unset (the fallback rule the
    reference implements by swapping in its plain Console, logger.py:162-171).
    """
    if os.environ.get("NO_COLOR"):
        return False
    s = stream if stream is not None else sys.stdout
    return bool(getattr(s, "isatty", lambda: False)())


def colorize(text: str, style: str, enabled: bool = True) -> str:
    if not enabled:
        return text
    codes = "".join(_ANSI[t] for t in style.split() if t in _ANSI)
    return f"{codes}{text}{_ANSI['reset']}" if codes else text


def format_table(rows: list[dict[str, Any]] | list[list[Any]],
                 headers: list[str] | None = None, title: str = "",
                 color: bool = False) -> str:
    """Render rows as an aligned box table (the rich.table equivalent).

    rows: list of dicts (headers inferred, union-ordered) or lists (headers
    required). Floats render at 4 sig figs like format_metrics."""
    if rows and isinstance(rows[0], dict):
        if headers is None:
            headers = list(dict.fromkeys(k for r in rows for k in r))
        body = [[r.get(h, "") for h in headers] for r in rows]
    else:
        body = [list(r) for r in rows]
        if headers is None:
            raise ValueError("headers required for list rows")

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        return str(v)

    body = [[fmt(v) for v in r] for r in body]
    widths = [max(len(h), *(len(r[i]) for r in body)) if body else len(h)
              for i, h in enumerate(headers)]
    sep = "+".join("-" * (w + 2) for w in widths)
    sep = f"+{sep}+"

    def line(cells, style=None):
        out = " | ".join(c.ljust(w) for c, w in zip(cells, widths))
        out = f"| {out} |"
        return colorize(out, style, color) if style else out

    parts = []
    if title:
        parts.append(colorize(title, "bold", color))
    parts += [sep, line(headers, "bold"), sep]
    parts += [line(r) for r in body]
    parts.append(sep)
    return "\n".join(parts)


def _to_scalar(v: Any):
    if hasattr(v, "detach"):                  # a torch tensor, on any device
        v = v.detach().cpu().numpy()
    a = np.asarray(v)
    if a.size == 1:
        return a.reshape(()).item()
    return float(np.mean(a))


def format_metrics(metrics: dict[str, Any], window: int = 0,
                   history: dict[str, list] | None = None,
                   skip: tuple[str, ...] = ()) -> str:
    """One metric line: key=value with 4-sig-fig floats; if `window` and a
    history are given, values are trailing-window means (reference
    logger.strformat/moving averages, logger.py:97-156)."""
    parts = []
    for k, v in metrics.items():
        if k in skip:
            continue
        if window and history is not None and k in history:
            vals = history[k][-window:]
            v = np.mean([_to_scalar(x) for x in vals])
        v = _to_scalar(v)
        if isinstance(v, float):
            parts.append(f"{k}={v:.4g}")
        else:
            parts.append(f"{k}={v}")
    return " ".join(parts)


class Logger:
    """Minimal structured console logger (ANSI-styled on TTYs, plain
    otherwise — the reference's rich Console + fallback pair,
    logger.py:162-283)."""

    def __init__(self, stream: IO | None = None, color: bool | None = None):
        self._stream = stream  # None -> current sys.stdout at call time
        self._color = color    # None -> auto-detect per write
        self.t0 = time.time()

    @property
    def color(self) -> bool:
        return (supports_color(self.stream) if self._color is None
                else self._color)

    def table(self, rows, headers=None, title: str = ""):
        self.stream.write(
            format_table(rows, headers, title, color=self.color) + "\n")
        self.stream.flush()

    @property
    def stream(self) -> IO:
        return self._stream if self._stream is not None else sys.stdout

    def log(self, msg: str):
        dt = time.time() - self.t0
        stamp = colorize(f"[{dt:9.2f}s]", "dim", self.color)
        self.stream.write(f"{stamp} {msg}\n")
        self.stream.flush()

    def rule(self, title: str = "", width: int = 72):
        pad = max(width - len(title) - 2, 4)
        left = pad // 2
        self.log("-" * left + f" {title} " + "-" * (pad - left))

    def print_metrics(self, metrics: dict, pre: list[str] | None = None,
                      skip: tuple[str, ...] = (), window: int = 0,
                      history: dict | None = None) -> str:
        s = format_metrics(metrics, window=window, history=history, skip=skip)
        if pre:
            s = " ".join(pre) + " " + s
        self.log(s)
        return s


class MetricsWriter:
    """Append-only JSONL metrics file: one {'step': n, ...} object per line.

    Plays the role of the reference's TensorBoard scalar streams
    (train.py:149-155, ft_hmc.py:72-100) in a greppable format.
    """

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, metrics: dict[str, Any], prefix: str = ""):
        rec = {"step": int(step)}
        for k, v in metrics.items():
            kk = f"{prefix}/{k}" if prefix else k
            try:
                rec[kk] = _to_scalar(v)
            except Exception:
                continue
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
