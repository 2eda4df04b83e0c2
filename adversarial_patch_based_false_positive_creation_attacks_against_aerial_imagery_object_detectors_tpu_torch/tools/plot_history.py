"""Plot training-loss curves from a run's ``train_log.jsonl`` (the
repository's ``tools/plot_history.py``).

The reference returns ``ep_loss_list`` for offline plotting and leaves
the np.save call commented out (reference train_patch.py:344,601-602);
here every run already writes a structured JSONL epoch log, and this
tool turns it into the loss-decomposition figure: one panel for the
victim-coupled creation losses (total / no_obj / no_cls), one for the
patch-regularity losses (tv / colorful / nps, log scale), plus the LR
schedule on a twin axis. Needs matplotlib (imported when it draws); no
device.

    python -m <package>.tools.plot_history RUN_DIR [-o out.png]
    (RUN_DIR is a train_patch --out-dir; reads RUN_DIR/train_log.jsonl)
"""

from __future__ import annotations

import argparse
import json
import os


def load_history(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise SystemExit(f"no epochs logged in {path}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="train_patch --out-dir (or a "
                                    "train_log.jsonl path directly)")
    ap.add_argument("-o", "--out", default=None,
                    help="output PNG (default RUN_DIR/loss_curves.png)")
    args = ap.parse_args(argv)

    path = args.run_dir
    if os.path.isdir(path):
        path = os.path.join(path, "train_log.jsonl")
    rows = load_history(path)
    out = args.out or os.path.join(os.path.dirname(path), "loss_curves.png")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ep = [r.get("epoch", i) for i, r in enumerate(rows)]

    def series(key):
        return [r.get(key, float("nan")) for r in rows]

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for key, style in [("loss", "k-"), ("no_obj", "C0-"), ("no_cls", "C1-"),
                       ("det", "C4-")]:
        vals = series(key)
        if any(v == v and v != 0.0 for v in vals):
            ax1.plot(ep, vals, style, label=key)
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    ax1.set_title("creation losses")
    ax1.legend()
    ax1.grid(alpha=0.3)

    for key, style in [("tv", "C2-"), ("colorful", "C3-"), ("nps", "C5-")]:
        vals = series(key)
        if any(v == v for v in vals):
            ax2.semilogy(ep, vals, style, label=key)
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("loss (log)")
    ax2.set_title("patch-regularity losses")
    ax2.legend(loc="upper left")
    ax2.grid(alpha=0.3)
    if any("lr" in r for r in rows):
        ax3 = ax2.twinx()
        ax3.plot(ep, series("lr"), "k--", alpha=0.5, label="lr")
        ax3.set_ylabel("lr")
        ax3.legend(loc="upper right")

    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out} ({len(rows)} epochs)")
    return {"out": out, "epochs": len(rows)}


if __name__ == "__main__":
    main()
