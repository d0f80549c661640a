"""Trained flows for the port: the JAX package's parameter tree as plain
numpy, stored as an ``.npz`` of fp32 arrays beside a FlowSpec ``.json``.

The tree is what ``fthmc_tpu`` keeps: a list of coupling layers, each a list
of {"w": (Cout, Cin, 3, 3), "b": (Cout,)} conv parameters. Conv weights
keep that (OIHW) layout in the port. No JAX or orbax is needed to read a
flow back.
"""
from __future__ import annotations

import json
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import torch

from fthmc_tpu_torch.config import FlowSpec, filter_kwargs
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.models.flow import flow_out_channels

__all__ = ["DATA_DIR", "FLAGSHIP_NPZ", "FLOWS", "flow_params_from_numpy",
           "save_flow_npz", "load_flow_npz", "leaf_names"]

DATA_DIR = Path(__file__).resolve().parent / "data"
# The trained flows of the JAX package (artifacts/<name>), exported here:
# 16-layer ncp, hidden (8, 8), 2 components at 8^2, beta=2 (b2_16l; _long
# trained 50 eras); 32 layers with leaky_relu (b2_32l_lrelu); rncp, hidden
# (32, 32), 8 components, s_clip 3, trained at 8^2 with beta annealed 2 -> 3
# (b3_rncp24, 24 layers; b3_rncp12_fw10, 12 layers with force_weight 1);
# and the flagship, b3_rncp24 fine-tuned at beta=6 (b3_rncp24_ftb6).
FLOWS = ("flow8x8_b2_16l", "flow8x8_b2_16l_long", "flow8x8_b2_32l_lrelu",
         "flow8x8_b3_rncp12_fw10", "flow8x8_b3_rncp24",
         "flow8x8_b3_rncp24_ftb6")
FLAGSHIP_NPZ = DATA_DIR / "flow8x8_b3_rncp24_ftb6.npz"


def _conv_shapes(spec: FlowSpec):
    sizes = (2, *spec.hidden_sizes, flow_out_channels(spec))
    k = spec.kernel_size
    return [((co, ci, k, k), (co,)) for ci, co in zip(sizes[:-1], sizes[1:])]


def flow_params_from_numpy(tree, spec: FlowSpec, device=None,
                           dtype=torch.float32):
    """The port's flow parameters from the JAX tree of numpy arrays, checked
    against ``spec`` and placed on ``device`` (the card by default)."""
    device = resolve_device(device)
    shapes = _conv_shapes(spec)
    if len(tree) != spec.n_layers:
        raise ValueError(f"{len(tree)} layers, spec has {spec.n_layers}")
    params = []
    for i, net in enumerate(tree):
        if len(net) != len(shapes):
            raise ValueError(f"layer {i}: {len(net)} convs, spec has "
                             f"{len(shapes)}")
        layer = []
        for j, (conv, (ws, bs)) in enumerate(zip(net, shapes)):
            w, b = np.asarray(conv["w"]), np.asarray(conv["b"])
            if w.shape != ws or b.shape != bs:
                raise ValueError(f"layer {i} conv {j}: shapes {w.shape}, "
                                 f"{b.shape}, spec wants {ws}, {bs}")
            layer.append({"w": torch.tensor(w, dtype=dtype, device=device),
                          "b": torch.tensor(b, dtype=dtype, device=device)})
        params.append(layer)
    return params


def _key(i: int, j: int, leaf: str) -> str:
    return f"l{i:02d}_c{j}_{leaf}"


def leaf_names(params) -> list[str]:
    """The ``.npz`` names of a flow's tensors, in ``train.param_leaves``
    order (layer, conv, then w and b)."""
    return [_key(i, j, leaf) for i, net in enumerate(params)
            for j in range(len(net)) for leaf in ("w", "b")]


def save_flow_npz(path, tree, spec: FlowSpec) -> None:
    """Write the numpy tree as ``path`` (.npz, fp32) and the FlowSpec as the
    ``.json`` beside it."""
    path = Path(path)
    arrays = {_key(i, j, leaf): np.asarray(conv[leaf], np.float32)
              for i, net in enumerate(tree) for j, conv in enumerate(net)
              for leaf in ("w", "b")}
    np.savez(path, **arrays)
    path.with_suffix(".json").write_text(
        json.dumps(asdict(spec), indent=1) + "\n")


def load_flow_npz(path=FLAGSHIP_NPZ, device=None, name: str | None = None,
                  spec_overrides: dict | None = None):
    """(params, spec) of a flow written by ``save_flow_npz``, on ``device``
    (the card by default): the file ``path``, or the exported flow ``name``
    (one of ``FLOWS``) from ``DATA_DIR``. ``spec_overrides`` replace fields
    of the stored FlowSpec; the arrays must still fit the result."""
    if name is not None:
        if name not in FLOWS:
            raise ValueError(f"unknown flow {name!r}; one of {FLOWS}")
        path = DATA_DIR / f"{name}.npz"
    path = Path(path)
    spec = FlowSpec(**filter_kwargs(
        FlowSpec, json.loads(path.with_suffix(".json").read_text())))
    if spec_overrides:
        spec = replace(spec, **spec_overrides)
    with np.load(path) as data:
        n_convs = len(spec.hidden_sizes) + 1
        tree = [[{leaf: data[_key(i, j, leaf)] for leaf in ("w", "b")}
                 for j in range(n_convs)] for i in range(spec.n_layers)]
    return flow_params_from_numpy(tree, spec, device=device), spec
