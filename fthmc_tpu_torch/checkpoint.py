"""Checkpoint and resume of flow training.

Counterpart of ``fthmc_tpu/checkpoint.py``, without orbax: a checkpoint is
the directory ``ckpt_era{era}_epoch{epoch}`` holding ``state.npz``, one
``.npz`` of the whole TrainState: the parameters under the names
``weights.save_flow_npz`` gives them (``l00_c0_w``, ...; so
``weights.flow_params_from_numpy`` reads them), Adam's moments under
``mu/`` and ``nu/`` with its count, the step, the scheduler's scalars and
the generator's state. The sidecars beside the directory are the JAX
package's: ``<dir>.meta.json`` with {era, epoch, flow_spec, train_config}
and ``<dir>.history.npz``. A checkpoint saved with its TrainConfig is
self-describing: ``load_checkpoint_auto`` rebuilds the flow and the
optimizer from the meta alone. The newest checkpoint (by mtime, ties by
(era, epoch)) wins discovery, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import torch

from fthmc_tpu_torch.config import FlowSpec, TrainConfig, filter_kwargs
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.train import (AdamState, TrainState, init_train_state,
                                   param_leaves, params_from_leaves)
from fthmc_tpu_torch.weights import leaf_names

__all__ = ["save_checkpoint", "load_checkpoint", "load_checkpoint_auto",
           "latest_checkpoint", "find_and_load_checkpoint", "read_meta",
           "resolve_checkpoint_dir", "spec_from_meta",
           "train_config_from_meta", "save_history", "load_history",
           "STATE_FILE"]

_CKPT_RE = re.compile(r"ckpt_era(\d+)_epoch(\d+)$")
STATE_FILE = "state.npz"
# markers of a directory that is a checkpoint: the port's state, or the
# JAX package's orbax layout (which the port cannot read, and says so)
_MARKERS = (STATE_FILE, "_METADATA", "_CHECKPOINT_METADATA")
_SCALARS = ("step", "lr_scale", "best_loss", "plateau_count")


def _state_arrays(state: TrainState) -> dict:
    """The state as named numpy arrays (one device read for all of it)."""
    names = leaf_names(state.params)
    tensors = {**dict(zip(names, param_leaves(state.params))),
               **{f"mu/{n}": t for n, t in zip(names, state.opt_state.mu)},
               **{f"nu/{n}": t for n, t in zip(names, state.opt_state.nu)},
               "adam_count": state.opt_state.count,
               **{k: getattr(state, k) for k in _SCALARS}}
    out = {k: t.detach().cpu().numpy() for k, t in tensors.items()}
    out["generator_state"] = state.generator.get_state().numpy()
    out["generator_device"] = np.array(state.generator.device.type)
    return out


def save_checkpoint(outdir: str, state: TrainState, *, era: int, epoch: int,
                    history: dict | None = None, train_cfg=None,
                    spec=None) -> str:
    """Save ``state`` as outdir/ckpt_era{era}_epoch{epoch}; returns the
    path. ``train_cfg`` (or ``spec``) make the checkpoint self-describing;
    train_cfg implies its .flow as the spec."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.abspath(os.path.join(outdir, f"ckpt_era{era}_epoch{epoch}"))
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, STATE_FILE), **_state_arrays(state))
    meta: dict = {"era": era, "epoch": epoch}
    if train_cfg is not None and spec is None:
        spec = train_cfg.flow
    if spec is not None:
        meta["flow_spec"] = dataclasses.asdict(spec)
    if train_cfg is not None:
        meta["train_config"] = dataclasses.asdict(train_cfg)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    if history is not None:
        save_history(history, path + ".history.npz")
    return path


def _restore(target: torch.Tensor, value: np.ndarray, name: str):
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint {name}: shape {value.shape}, the "
                         f"template has {tuple(target.shape)}")
    return torch.as_tensor(value).to(dtype=target.dtype, device=target.device)


def load_checkpoint(path: str, target: TrainState):
    """Restore a checkpoint into the structure, dtypes and device of
    ``target`` (a template TrainState of the same flow); the generator's
    state is loaded into target's generator, which must be on the device
    type it was saved from. Returns (state, meta). Raises for a directory
    that is not a readable checkpoint of this layout."""
    path = os.path.abspath(path)
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.exists(state_file):
        raise FileNotFoundError(
            f"{path} has no {STATE_FILE}: not a checkpoint of "
            f"fthmc_tpu_torch (an orbax checkpoint of the JAX package is "
            f"read with JAX and exported with weights.save_flow_npz)")
    with np.load(state_file, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    names = leaf_names(target.params)
    leaves = [_restore(t, arrays[n], n)
              for n, t in zip(names, param_leaves(target.params))]
    mu = [_restore(t, arrays[f"mu/{n}"], f"mu/{n}")
          for n, t in zip(names, target.opt_state.mu)]
    nu = [_restore(t, arrays[f"nu/{n}"], f"nu/{n}")
          for n, t in zip(names, target.opt_state.nu)]
    gen = target.generator
    saved_dev = str(arrays["generator_device"])
    if saved_dev != gen.device.type:
        raise ValueError(f"the checkpoint's generator was a {saved_dev} "
                         f"generator; restore it into a {saved_dev} state")
    gen.set_state(torch.as_tensor(arrays["generator_state"]))
    state = TrainState(
        params=params_from_leaves(target.params, leaves),
        opt_state=AdamState(
            count=_restore(target.opt_state.count, arrays["adam_count"],
                           "adam_count"), mu=mu, nu=nu),
        generator=gen,
        **{k: _restore(getattr(target, k), arrays[k], k) for k in _SCALARS})
    return state, read_meta(path)


def read_meta(path: str) -> dict:
    """Checkpoint metadata: the sidecar first, then a meta.json inside."""
    for meta_path in (path + ".meta.json", os.path.join(path, "meta.json")):
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
    return {}


def spec_from_meta(meta: dict) -> FlowSpec | None:
    """The FlowSpec recorded in checkpoint metadata, or None."""
    fs = meta.get("flow_spec")
    if not fs:
        return None
    return FlowSpec(**filter_kwargs(FlowSpec, fs))


def train_config_from_meta(meta: dict, spec=None) -> TrainConfig | None:
    """The TrainConfig recorded in checkpoint metadata (its flow replaced
    by ``spec`` when given), or None."""
    tc = meta.get("train_config")
    if tc is None and spec is None:
        return None
    kw = {k: v for k, v in filter_kwargs(TrainConfig, tc or {}).items()
          if k != "flow"}
    if spec is None:
        spec = FlowSpec(**filter_kwargs(FlowSpec, (tc or {}).get("flow", {})))
    return TrainConfig(flow=spec, **kw)


def _looks_like_checkpoint(path: str) -> bool:
    return any(os.path.exists(os.path.join(path, m)) for m in _MARKERS)


def latest_checkpoint(outdir: str) -> str | None:
    """The newest ckpt_era*_epoch* directory of ``outdir`` by mtime (ties by
    (era, epoch)), or None."""
    if not os.path.isdir(outdir):
        return None
    cands = []
    for name in os.listdir(outdir):
        m = _CKPT_RE.match(name)
        full = os.path.join(outdir, name)
        if m and os.path.isdir(full):
            cands.append((os.path.getmtime(full), int(m.group(1)),
                          int(m.group(2)), full))
    if not cands:
        return None
    return max(cands)[-1]


def resolve_checkpoint_dir(path: str) -> str | None:
    """``path`` may be a parent of ckpt_era* directories (the newest wins)
    or a checkpoint directory itself. Returns the checkpoint or None."""
    latest = latest_checkpoint(path)
    if latest is not None:
        return latest
    if os.path.isdir(path) and _looks_like_checkpoint(path):
        return os.path.abspath(path)
    return None


def load_checkpoint_auto(path: str, spec_overrides: dict | None = None,
                         device=None):
    """Restore a self-describing checkpoint on ``device`` (the card by
    default) with no template: the flow and the optimizer (grad_clip) come
    from the FlowSpec and TrainConfig in its meta; ``spec_overrides``
    replace fields of the stored spec. Returns (state, meta, spec,
    train_cfg), or None when no checkpoint is found or its meta has no
    flow_spec."""
    ckpt = resolve_checkpoint_dir(path)
    if ckpt is None:
        return None
    meta = read_meta(ckpt)
    spec = spec_from_meta(meta)
    if spec is None:
        return None
    if spec_overrides:
        spec = dataclasses.replace(spec, **spec_overrides)
    cfg = train_config_from_meta(meta, spec)
    device = resolve_device(device)
    template = init_train_state(torch.Generator(device).manual_seed(0), cfg,
                                device=device)
    state, _ = load_checkpoint(ckpt, template)
    return state, meta, spec, cfg


def find_and_load_checkpoint(outdir: str, target: TrainState):
    """Discover and restore the newest checkpoint, or None. ``outdir`` may
    be a parent of ckpt_era* directories or a checkpoint itself; a
    directory that looks like a checkpoint and fails to load raises."""
    path = resolve_checkpoint_dir(outdir)
    if path is None:
        return None
    return load_checkpoint(path, target)


def save_history(history: dict, path: str):
    """A metrics history dict as compressed npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, **{k: np.asarray(v) for k, v in history.items()})


def load_history(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
