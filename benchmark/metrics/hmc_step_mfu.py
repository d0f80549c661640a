"""The plain-HMC step's share of the card's fp32 peak: the operations the
whole step needs (momentum draw, the leapfrog steps, both energies, the
accept: the K4 row of the counts) times the trajectories of the untraced
window, over its seconds times 67 TFLOP/s."""
from benchmark.counts import work

UNIT = "%"


def read(ctx):
    cfg, w = ctx["config"], ctx["window"]
    if cfg["sampler"] != "hmc" or not ctx["on_card"] or w["traj"] == 0:
        return None
    ops = work.plain_traj_ops(w["chains"], cfg["L"], cfg["nstep"])
    return 100.0 * ops * w["traj"] / (w["seconds"] * work.PEAK_FP32_FLOPS)
