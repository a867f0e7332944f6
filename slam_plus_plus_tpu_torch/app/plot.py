"""Trajectory/system plotting.

Port of slam_plus_plus_tpu/app/plot.py (reference CFlatSystem::Plot2D /
Plot3D, include/slam/FlatSystem.h:2717-2750, TGA output): a PNG through
matplotlib, or None where matplotlib is not installed, as there."""

from __future__ import annotations


def plot_system(system, path="solution.png"):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig, ax = plt.subplots(figsize=(8, 8))
    plotted = False
    for tname, store in system.vertex_stores.items():
        data = store.data
        if data.shape[1] < 2:
            continue
        if tname in ("pose2d",):
            ax.plot(data[:, 0], data[:, 1], "-", lw=0.5, color="tab:blue",
                    label="trajectory")
            plotted = True
        elif tname in ("landmark2d",):
            ax.plot(data[:, 0], data[:, 1], ".", ms=2, color="tab:red",
                    label="landmarks")
            plotted = True
        elif tname in ("pose3d", "cam", "scam", "spheron"):
            ax.plot(data[:, 0], data[:, 1], "-", lw=0.5, color="tab:blue",
                    label="trajectory (xy)")
            plotted = True
        elif tname in ("landmark3d", "xyz"):
            ax.plot(data[:, 0], data[:, 1], ".", ms=1, color="tab:red",
                    label="points (xy)")
            plotted = True
    if not plotted:
        plt.close(fig)
        return None
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
