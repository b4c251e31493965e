"""Combined train/val metric charts from the JSONL log (port of
``viz/charts.py``): one PNG per metric group, the train/ and val/ series on
a shared epoch axis (the reference's ``WandBMetricOrganizer`` panels,
rendered locally). matplotlib is imported only to draw: a machine without
it trains all the same, without charts.
"""

from __future__ import annotations

import json
from pathlib import Path

# The reference's metric groups (its define_metric calls), and MMTRSSM's kl_h.
GROUPS = ("loss", "recon", "recon/audio", "recon/vision", "kl", "kl_h")


def load_metrics(metrics_path: str | Path) -> list[dict]:
    """The rows of a ``metrics.jsonl`` file."""
    rows = []
    with open(metrics_path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def render_combined_charts(metrics_path: str | Path,
                           out_dir: str | Path | None = None) -> list[Path]:
    """One PNG per metric group with its train/ and val/ series, into
    ``out_dir`` (``charts/`` beside the metrics file by default)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics_path = Path(metrics_path)
    out_dir = Path(out_dir) if out_dir is not None else metrics_path.parent / "charts"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = load_metrics(metrics_path)
    if not rows:
        return []
    epochs = [r.get("epoch", i) for i, r in enumerate(rows)]
    written = []
    for group in GROUPS:
        series = {}
        for prefix in ("train", "val"):
            key = f"{prefix}/{group}"
            vals = [(e, r[key]) for e, r in zip(epochs, rows) if key in r]
            if vals:
                series[prefix] = vals
        if not series:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        for prefix, vals in series.items():
            xs, ys = zip(*vals)
            ax.plot(xs, ys, label=prefix)
        ax.set_xlabel("epoch")
        ax.set_ylabel(group)
        ax.set_title(f"{group} (train/val)")
        ax.legend()
        fig.tight_layout()
        path = out_dir / f"{group.replace('/', '_')}.png"
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written
