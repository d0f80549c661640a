"""CG iterations a solve in the traced slice, every kind of solve together
(the force's and the Metropolis step's): the solves and iterations that
the program's ``fermion.CGLog`` holds (each solve's iterations the
slowest chain's), read through ``drivers/schwinger.launches``. None off
the ``schwinger`` sampler or where the slice made no solve."""
UNIT = "iters/solve"


def read(ctx):
    if ctx["config"]["sampler"] != "schwinger":
        return None
    la = ctx["slice"]["launches"]
    solves = sum(v for k, v in la.items() if k.startswith("cg_solves."))
    iters = sum(v for k, v in la.items() if k.startswith("cg_iters."))
    return iters / solves if solves else None
