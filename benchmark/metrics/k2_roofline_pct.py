"""K2's share of its roofline: the least time of its work (the K2 row of
the counts: the larger of its bytes and its operations) over its mean
device time a launch in the traced slice."""
from benchmark.counts import work

UNIT = "%"
KERNEL = "leapfrog_band_kernel"


def read(ctx):
    cfg, s = ctx["config"], ctx["slice"]
    times = [v for k, v in s["kernels"].items() if KERNEL in k]
    n = sum(v[0] for v in times)
    if cfg["sampler"] != "hmc" or not ctx["on_card"] or n == 0:
        return None
    bound_s = work.traj_bounds(ctx["window"]["chains"], cfg["L"],
                               cfg["nstep"])["K2"]["bound_ms"] * 1e-3
    return 100.0 * bound_s / (sum(v[1] for v in times) / n)
