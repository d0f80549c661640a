"""K11's share of its roofline: the least time of the solves and CG
iterations of the traced slice (``counts.fermion``; the program's
``fermion.CGLog``, read through ``drivers/schwinger.launches``) over the
device time of K11's kernel in the slice. A solve's iterations are its
slowest chain's, counted for every chain: where chains stop earlier the
share reads high by that much. None off the ``schwinger`` sampler, off
the card, or where the slice ran no K11."""
from benchmark.counts import fermion

UNIT = "%"
KERNEL = "cg_kernel"


def read(ctx):
    cfg, s = ctx["config"], ctx["slice"]
    if cfg["sampler"] != "schwinger" or not ctx["on_card"]:
        return None
    dev_s = sum(v[1] for k, v in s["kernels"].items()
                if KERNEL in k and "bfloat16" not in k)
    la = s["launches"]
    solves = sum(v for k, v in la.items() if k.startswith("cg_solves."))
    iters = sum(v for k, v in la.items() if k.startswith("cg_iters."))
    if dev_s == 0 or solves == 0:
        return None
    b = fermion.k11_bound(ctx["window"]["chains"], cfg["L"], solves, iters,
                          cfg["eo_precond"])
    return 100.0 * b["bound_ms"] * 1e-3 / dev_s
