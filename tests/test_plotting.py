"""utils.plotting smoke: each figure helper renders from rollout-shaped
arrays without a display."""

import matplotlib

matplotlib.use("Agg")

import numpy as np

from pdecontrolgym_jax.utils import ns_fields, spacetime_1d, surface_1d


def test_surface_1d_renders():
    h = np.sin(np.linspace(0, 6, 500)[:, None] + np.linspace(0, 3, 64)[None, :])
    ax = surface_1d(h, T=5.0, X=1.0)
    assert ax.name == "3d"
    assert len(ax.collections) == 1  # the surface
    ax.figure.canvas.draw()


def test_spacetime_1d_renders():
    h = np.random.default_rng(0).normal(size=(240, 32))
    ax = spacetime_1d(h, T=240.0, X=500.0, label="density")
    assert ax.get_title() == "density"
    assert len(ax.images) == 1
    ax.figure.canvas.draw()


def test_ns_fields_renders_both_layouts():
    rng = np.random.default_rng(0)
    u, v = rng.normal(size=(2, 21, 21))
    ax = ns_fields((u, v), X=1.0, Y=1.0)
    assert len(ax.collections) >= 2  # contourf + quiver
    stacked = np.stack([u, v], axis=-1)
    ax2 = ns_fields(stacked, X=1.0, Y=1.0)
    ax2.figure.canvas.draw()


def test_csv_loaders_match_reference(tmp_path):
    """load_csv/load_csv_all parse TB-exported scalar CSVs with the same
    contract as the reference's figure pipeline
    (examples/transportPDE/utils.py:58-88)."""
    from pdecontrolgym_jax.utils.plotting import load_csv, load_csv_all

    p = tmp_path / "run.csv"
    p.write_text(
        "Wall time,Step,Value\n"
        "1000.5,0,-12.25\n"
        "1001.5,10000,55.0\n"
        "1003.25,20000,180.125\n"
    )
    steps, rewards = load_csv(str(p))
    assert steps == [0, 10000, 20000]
    assert rewards == [-12.25, 55.0, 180.125]
    wall, steps2, rewards2 = load_csv_all(str(p))
    assert wall == [1000.5, 1001.5, 1003.25]
    assert (steps2, rewards2) == (steps, rewards)


def test_jsonl_loader_and_reward_curves(tmp_path):
    from pdecontrolgym_jax.utils import MetricsLogger
    from pdecontrolgym_jax.utils.plotting import load_jsonl, reward_curves

    logger = MetricsLogger(str(tmp_path), tensorboard=False)
    for i in range(12):
        logger.log(i, {"mean_reward": float(i) * 2.0, "loss": 1.0 / (i + 1)})
    logger.close()
    steps, vals = load_jsonl(str(tmp_path / "metrics.jsonl"))
    assert steps == list(range(12))
    assert vals[3] == 6.0
    ax = reward_curves(
        [(steps, vals), (steps, [v + 1 for v in vals])],
        labels=["PPO", "SAC"], smooth=3,
    )
    assert len(ax.lines) == 2
    assert ax.get_legend() is not None
    ax.figure.canvas.draw()
