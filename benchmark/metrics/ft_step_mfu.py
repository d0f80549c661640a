"""The FT-HMC trajectory's share of the card's fp32 peak: the conv flops it
needs (two energy flows at K6's count, 2 nstep + 1 forces at K7's and
K8's count over every layer, and K1's) times the trajectories of the
untraced window, over its seconds times 67 TFLOP/s."""
from benchmark.counts import work

UNIT = "%"


def read(ctx):
    cfg, w = ctx["config"], ctx["window"]
    if cfg["sampler"] != "fthmc" or not ctx["on_card"] or w["traj"] == 0:
        return None
    fl = cfg["flow"]
    widths = work.flow_widths(fl["hidden_sizes"], 2 * fl["n_mixture"] + 1)
    flops = work.ft_traj_flops(widths, fl["n_layers"], w["chains"], cfg["L"],
                               cfg["nstep"])
    return 100.0 * flops * w["traj"] / (w["seconds"]
                                        * work.PEAK_FP32_FLOPS)
