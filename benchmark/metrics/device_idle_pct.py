"""Share of the untraced window's wall time in which the card has no work:
one less the device time that the window's trajectories need (the traced
slice's busy seconds a trajectory, the union of its device intervals from
the slice's own timeline) over the window's seconds. The slice's own idle
share (``device.busy_s`` over ``device.window_s``) also holds the
profiler's host cost, some 10 us a launch, which a step that the host
paces pays in full."""
UNIT = "%"


def read(ctx):
    s, w = ctx["slice"], ctx["window"]
    if not ctx["on_card"] or s["traj"] == 0 or w["traj"] == 0:
        return None
    busy_s = s["busy_s"] / s["traj"] * w["traj"]
    return 100.0 * (1.0 - busy_s / w["seconds"])
