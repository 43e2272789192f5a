"""Offline training-curve plots from metrics.jsonl (the JSONL scalars that
both packages' `MetricsWriter` writes).  matplotlib is imported only by
`plot`.

    python -m finalproject_losslessimagecompression_tpu_torch.utils.plot_metrics \
        <log_dir> [--tag "train bpd"] [--out fig/train_bpd.png]
"""

from __future__ import annotations

import argparse
import json
import os


def load_series(log_dir: str, tag: str):
    steps, values = [], []
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("tag") == tag:
                steps.append(rec["step"])
                values.append(rec["value"])
    return steps, values


def plot(log_dir: str, tag: str, out: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps, values = load_series(log_dir, tag)
    if not steps:
        raise SystemExit(f"no records for tag {tag!r} in {log_dir}")
    plt.figure(figsize=(8, 5))
    plt.plot(steps, values)
    plt.xlabel("step")
    plt.ylabel(tag)
    plt.title(f"{tag} ({os.path.basename(log_dir.rstrip('/'))})")
    plt.grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    plt.savefig(out, dpi=120, bbox_inches="tight")
    print("wrote", out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log_dir")
    ap.add_argument("--tag", default="train bpd")
    ap.add_argument("--out", default="fig/train_bpd.png")
    args = ap.parse_args(argv)
    plot(args.log_dir, args.tag, args.out)


if __name__ == "__main__":
    main()
