"""The coupling kernels' share of their roofline: the least time of the
work of every K6, K7 and K8 launch in the traced slice (the counts'
per-layer bounds, each launch one layer; the launches from the program's
own counters) over the device time of the two kernels that run them."""
from benchmark.counts import work

UNIT = "%"
KERNELS = ("coupling_fwd_kernel", "coupling_bwd_kernel")


def read(ctx):
    cfg, s = ctx["config"], ctx["slice"]
    if cfg["sampler"] != "fthmc" or not ctx["on_card"]:
        return None
    dev_s = sum(v[1] for k, v in s["kernels"].items()
                if any(name in k for name in KERNELS))
    if dev_s == 0:
        return None
    fl = cfg["flow"]
    widths = work.flow_widths(fl["hidden_sizes"], 2 * fl["n_mixture"] + 1)
    per_layer = work.flow_layer_bounds(widths, fl["n_layers"],
                                       ctx["window"]["chains"],
                                       cfg["L"])["bound_ms"]
    bound_ms = sum(s["launches"].get(k, 0) / fl["n_layers"] * per_layer[k]
                   for k in ("K6", "K7", "K8"))
    return 100.0 * bound_ms * 1e-3 / dev_s
