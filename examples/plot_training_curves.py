"""Reward-vs-iterations training-curve figures from committed runs.

The reference builds these figures by hand from TensorBoard CSV exports
(``examples/transportPDE/utils.py:58-106`` ``load_csv``/``load_csv_all``,
duplicated in three example dirs). Here both sources work:

- ``metrics.jsonl`` written by ``utils.metrics.MetricsLogger`` (the native
  trainers' callback), loaded with ``utils.plotting.load_jsonl``;
- TB CSV exports, loaded with ``utils.plotting.load_csv`` (same row contract
  as the reference).

Default reproduces the committed figure:
    python examples/plot_training_curves.py
    -> docs/figures/transport_ppo_curve.png  (from docs/runs/transport_ppo)
"""

import argparse
import os

from pdecontrolgym_jax.utils.plotting import (
    load_csv,
    load_jsonl,
    reward_curves,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="*",
                    default=[os.path.join(REPO, "docs/runs/transport_ppo")],
                    help="run dirs (metrics.jsonl) or .csv files (TB export)")
    ap.add_argument("--key", default="eval",
                    help="JSONL metric to plot (e.g. eval, mean_reward)")
    ap.add_argument("--labels", nargs="*", default=None)
    ap.add_argument("--smooth", type=int, default=1)
    ap.add_argument("--out",
                    default=os.path.join(REPO,
                                         "docs/figures/transport_ppo_curve.png"))
    args = ap.parse_args()

    curves, labels = [], []
    for run in args.runs:
        if run.endswith(".csv"):
            curves.append(load_csv(run))
            labels.append(os.path.splitext(os.path.basename(run))[0])
        else:
            curves.append(load_jsonl(os.path.join(run, "metrics.jsonl"),
                                     key=args.key))
            labels.append(os.path.basename(os.path.normpath(run)))
    if args.labels:
        labels = args.labels

    ax = reward_curves(curves, labels=labels, smooth=args.smooth,
                       ylabel="mean episodic return (32-episode eval)")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    ax.figure.savefig(args.out, dpi=150)
    print(f"wrote {args.out}  ({len(curves)} curve(s))")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
