"""The frozen counts reproduce the bounds the repository's kernel table
states (PERF.md: K7 0.00426, K8 0.00412 ms on the flagship's layer 1 at
64 chains of 16^2; K2 0.0553, K4 0.0787 ms at the headline's 1024 chains of
64^2 and 25 steps)."""
import pytest

from benchmark.counts import work

FLAGSHIP_WIDTHS = work.flow_widths((32, 32), 17)


@pytest.mark.parametrize("kernel, ms", [("K7", 0.00426), ("K8", 0.00412),
                                        ("K6", 0.00426)])
def test_coupling_bounds(kernel, ms):
    mu, off = work.layer_mask_params(1)
    b = work.coupling_bounds(FLAGSHIP_WIDTHS, mu, off, 64, 16)[kernel]
    assert b["bound_ms"] == pytest.approx(ms, abs=5e-6)
    assert b["bound_by"] == "operations"


@pytest.mark.parametrize("kernel, ms", [("K2", 0.0553), ("K4", 0.0787)])
def test_trajectory_bounds(kernel, ms):
    b = work.traj_bounds(1024, 64, 25)[kernel]
    assert b["bound_ms"] == pytest.approx(ms, abs=5e-5)
    assert b["bound_by"] == "operations"


def test_ft_trajectory_flops():
    """~243 GFLOP a flagship trajectory: 2 x 24 K6 and 17 x 24 K7 and K8
    layers and 17 K1 (2 nstep + 1 forces)."""
    fl = work.ft_traj_flops(FLAGSHIP_WIDTHS, 24, 64, 16, 8)
    assert fl == pytest.approx(242.8e9, rel=1e-3)


def test_masks_partition_the_lattice():
    for i in range(8):
        mu, off = work.layer_mask_params(i)
        fr, ac, pa = work.plaq_masks((16, 16), mu, off)
        assert ((fr + ac + pa) == 1).all()
        assert fr.sum() == 2 * ac.sum() == 2 * pa.sum()


def test_device_idle_share_reads_the_untraced_window():
    """The slice's busy seconds a trajectory, spread over the untraced
    window's trajectories: 0.02 s a trajectory, 1,000 trajectories in 25 s,
    so the card works 20 of the window's 25 s. The slice's own 3 s, which
    the profiler stretched, does not enter."""
    from benchmark import harness
    reader = harness.Cell(harness.ROOT, "hmc64_headline").readers()[
        "device_idle_pct"]
    ctx = {"on_card": True,
           "slice": {"busy_s": 2.0, "traj": 100, "window_s": 3.0},
           "window": {"traj": 1000, "seconds": 25.0}}
    assert reader.read(ctx) == pytest.approx(20.0)
    assert reader.read(dict(ctx, on_card=False)) is None
