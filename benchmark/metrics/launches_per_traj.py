"""Device kernel launches the profiler sees in the traced slice, per
trajectory: the port's own kernels and PyTorch's."""
UNIT = "launches/traj"


def read(ctx):
    s = ctx["slice"]
    if not ctx["on_card"] or s["traj"] == 0:
        return None
    return s["kernel_launches"] / s["traj"]
