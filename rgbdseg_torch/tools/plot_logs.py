"""Training-curve plotting from trainer_state.json log histories
(counterpart of `rgbdseg_tpu/tools/plot_logs.py`, without matplotlib).

Capability parity with plot_json_log.py (reference: extractors :11-72/:250-351,
plot_multiple_training_metrics_with_category_map :375-597 and its CLI :602-650):
multi-run overlay of train loss, eval loss, LR + grad-norm twin axes, overall
mAP / mAP@50 / mAP@75 / mAR@100, and paginated per-category mAP+mAR curves
aligned across runs. Both trainers write HF-compatible trainer_state.json, so
either stack's logs plot here.

The figures are uint8 PNGs of a fixed size drawn by `utils/raster.py` (the
card's machine has no matplotlib): the same six fixed panels on
`training_metrics.png` and the same category pages `category_map_page<n>.png`
as the JAX tool, each curve in matplotlib's default colour cycle.

    python -m rgbdseg_torch.tools.plot_logs run_a/trainer_state.json run_b [--names a b] \
        [--output_dir plots] [--x_key epoch|step] [--categories_per_page 12]
"""

from __future__ import annotations

import argparse
import json
import math
import os

from ..data.image_io import write_png
from ..utils import raster

# Fixed panels: (title, [(key, linestyle, label_suffix)])
_FIXED_PANELS = [
    ("train loss", [("loss", "-", "")]),
    ("eval loss", [("eval_loss", "-", "")]),
    ("lr (solid) / grad norm (dotted)", None),  # special twin-axis panel
    ("eval mAP", [("eval_map", "-", "")]),
    ("eval mAP@50 / mAP@75", [("eval_map_50", "-", "@50"), ("eval_map_75", "--", "@75")]),
    ("eval mAR@100", [("eval_mar_100", "-", "")]),
]

_SUMMARY_KEYS = {
    "eval_map", "eval_map_50", "eval_map_75", "eval_map_small", "eval_map_medium",
    "eval_map_large", "eval_mar_1", "eval_mar_10", "eval_mar_100", "eval_mar_small",
    "eval_mar_medium", "eval_mar_large",
}
PANEL_W, PANEL_H = 640, 440  # training_metrics.png: 2 x 3 panels
CATEGORY_W, CATEGORY_H = 440, 340  # one per-category panel


def load_log_history(trainer_state_path: str) -> list[dict]:
    with open(trainer_state_path) as f:
        return json.load(f)["log_history"]


def extract_series(log_history: list[dict], key: str, x_key: str = "epoch"):
    xs, ys = [], []
    for e in log_history:
        if key in e and e.get(key) is not None and x_key in e:
            xs.append(e[x_key])
            ys.append(e[key])
    return xs, ys


def per_category_map_keys(log_history: list[dict]) -> list[str]:
    """Per-category eval_map_<name>/eval_mar_100_<name> keys (the reference's
    v2 extractor collects these dynamically, plot_json_log.py:250-351)."""
    keys = set()
    for e in log_history:
        for k in e:
            if (k.startswith("eval_map_") or k.startswith("eval_mar_100_")) and k not in _SUMMARY_KEYS:
                keys.add(k)
    return sorted(keys)


def _plot_panel(ax: raster.Axes, title, spec, hists, x_key) -> None:
    colors = iter(raster.COLORS * 8)
    if spec is None:  # LR + grad-norm twin axes (reference :149-182)
        for name, h in hists.items():
            ax.plot(*extract_series(h, "learning_rate", x_key), next(colors), "-", f"{name} lr")
        for name, h in hists.items():
            ax.plot(*extract_series(h, "grad_norm", x_key), next(colors), ":", f"{name} grad", right=True)
        ax.draw(title, x_key, "grad norm")
        return
    for name, h in hists.items():
        for key, style, suffix in spec:
            xs, ys = extract_series(h, key, x_key)
            if xs:
                ax.plot(xs, ys, next(colors), style, f"{name}{(' ' + suffix) if suffix else ''}")
    ax.draw(title, x_key)


def plot_multiple_training_metrics(
    runs: dict[str, str],
    output_dir: str,
    categories_per_page: int = 12,
    x_key: str = "epoch",
) -> list[str]:
    """runs: {run_name: trainer_state.json path}. Writes PNGs; returns paths.

    Page 1 = the six fixed panels; subsequent pages = per-category mAP/mAR
    curves, `categories_per_page` per figure, category set unioned and
    x-aligned across all runs (reference :420-424 sorts for consistent order).
    """
    os.makedirs(output_dir, exist_ok=True)
    hists = {name: load_log_history(p) for name, p in runs.items()}
    written = []

    img = raster.canvas(2 * PANEL_H, 3 * PANEL_W)
    for i, (title, spec) in enumerate(_FIXED_PANELS):
        ax = raster.Axes(img, (i % 3) * PANEL_W, (i // 3) * PANEL_H, PANEL_W, PANEL_H, twin=spec is None)
        _plot_panel(ax, title, spec, hists, x_key)
    p = os.path.join(output_dir, "training_metrics.png")
    write_png(p, img)
    written.append(p)

    cat_keys = sorted(set().union(*[per_category_map_keys(h) for h in hists.values()]) if hists else set())
    pages = math.ceil(len(cat_keys) / categories_per_page) if cat_keys else 0
    for page in range(pages):
        keys = cat_keys[page * categories_per_page : (page + 1) * categories_per_page]
        cols = min(4, len(keys))
        rows = math.ceil(len(keys) / cols)
        img = raster.canvas(rows * CATEGORY_H, cols * CATEGORY_W)
        for i, key in enumerate(keys):
            ax = raster.Axes(img, (i % cols) * CATEGORY_W, (i // cols) * CATEGORY_H, CATEGORY_W, CATEGORY_H)
            for (name, h), color in zip(hists.items(), raster.COLORS * 8):
                xs, ys = extract_series(h, key, x_key)
                if xs:
                    ax.plot(xs, ys, color, "-", name)
            ax.draw(key, x_key)
        p = os.path.join(output_dir, f"category_map_page{page + 1}.png")
        write_png(p, img)
        written.append(p)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description="Plot training metrics from trainer_state.json files")
    ap.add_argument("states", nargs="+", help="trainer_state.json paths (or run dirs containing one)")
    ap.add_argument("--names", nargs="*", default=None, help="run names (default: parent dir names)")
    ap.add_argument("--output_dir", default="plots")
    ap.add_argument("--x_key", default="epoch", choices=["epoch", "step"])
    ap.add_argument("--categories_per_page", type=int, default=12)
    args = ap.parse_args(argv)
    paths = [
        p if p.endswith(".json") else os.path.join(p, "trainer_state.json") for p in args.states
    ]
    names = args.names or [os.path.basename(os.path.dirname(os.path.abspath(p))) for p in paths]
    written = plot_multiple_training_metrics(
        dict(zip(names, paths)), args.output_dir, args.categories_per_page, args.x_key
    )
    for w in written:
        print(f"wrote {w}")
    return written


if __name__ == "__main__":
    main()
