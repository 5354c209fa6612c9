"""Plots over training metrics and evaluation outputs, for the PyTorch port.

The JAX package's ``viz.py`` (reference visualise.py:21-268,
analyse.py:303-411) with the same six plots, returns and errors, on record
columns read through the standard library's ``csv`` in place of pandas
DataFrames: ``metrics.csv`` written by the train loop (train/loop.py), and
the ``*_eval_df_per_meeting.csv`` / ``*_sum_stats.csv`` written by the
evaluator (eval/analyse.py).  matplotlib is imported when a plot is drawn,
not when this module is imported (the card's machine may not have it);
headless-safe (Agg backend).
"""

from __future__ import annotations

import csv
import math
from typing import Dict, Optional, Sequence

import numpy as np

Columns = Dict[str, np.ndarray]


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or an error that names the
    missing package."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plotting needs matplotlib, which is not installed "
            "(pip install matplotlib)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def read_columns(path: str) -> Columns:
    """A CSV as columns, as pandas reads it: a column whose every cell is a
    number (or empty, read as NaN) is float64, any other column text."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    cols: Columns = {}
    for i, name in enumerate(header):
        cells = [r[i] for r in rows]
        try:
            cols[name] = np.asarray([float(c) if c.strip() else math.nan for c in cells],
                                    dtype=np.float64)
        except ValueError:
            cols[name] = np.asarray(cells, dtype=object)
    return cols


def _rows(cols: Columns, mask: np.ndarray) -> Columns:
    return {k: v[mask] for k, v in cols.items()}


def _size(cols: Columns) -> int:
    return len(next(iter(cols.values()))) if cols else 0


def _groups(values: np.ndarray):
    """(key, row mask) per distinct non-NaN value, in sorted order (pandas'
    ``groupby``)."""
    for key in np.unique(values[~np.isnan(values)]):
        yield key, values == key


def _finish(fig, plt, out_path: Optional[str]):
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_train_metrics(
    metrics_csv: str, out_path: Optional[str] = None, title: Optional[str] = None
):
    """2x2 loss/accuracy/precision/recall grid, train vs val, over
    global_step (reference visualise.py:21-88)."""
    plt = _pyplot()
    df = read_columns(metrics_csv)
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    panels = [("loss", "Loss"), ("acc", "Accuracy"),
              ("precision", "Precision"), ("recall", "Recall")]
    # The epoch axis is the same in every panel: each epoch's first step.
    firsts = None
    if "epoch" in df and len(np.unique(df["epoch"][~np.isnan(df["epoch"])])) > 1:
        firsts = [(e, df["global_step"][m].min()) for e, m in _groups(df["epoch"])]
    for ax, (key, label) in zip(axes.flat, panels):
        for prefix, style in (("train", "-"), ("val", "--")):
            col = f"{prefix}_{key}"
            if col in df:
                ax.plot(df["global_step"], df[col], style, label=prefix)
        ax.set_xlabel("global step")
        ax.set_ylabel(label)
        ax.legend()
        ax.grid(alpha=0.3)
        if firsts is not None:
            top = ax.secondary_xaxis("top")
            top.set_xticks([step for _, step in firsts])
            top.set_xticklabels([f"e{int(e)}" for e, _ in firsts])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return _finish(fig, plt, out_path)


def _draw_pr_curves(ax, df: Columns, label: Optional[str] = None):
    """One precision-recall line per min_length (threshold as the curve
    parameter) onto ``ax``, shared by :func:`plot_precision_recall` and
    :func:`plot_experiment_comparison`."""
    for min_len, m in _groups(df["min_len"]):
        g = _rows(df, m)
        order = np.argsort(g["threshold"], kind="stable")
        name = f"min_len={min_len}"
        if label:
            name = f"{label} {name}"
        ax.plot(g["recall"][order], g["precision"][order], "o-", label=name, markersize=3)


def _finish_pr_axes(fig, ax, plt, out_path: Optional[str]):
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.grid(alpha=0.3)
    ax.legend()
    return _finish(fig, plt, out_path)


def _match_min_len(df: Columns, min_len: float) -> Columns:
    """Rows whose min_len equals ``min_len`` at 6-decimal precision: a
    reference-exported grid may carry float-repr noise (np.arange min_lens
    like 0.30000000000000004), the parity CLI's grid-join rule."""
    return _rows(df, np.round(df["min_len"], 6) == round(min_len, 6))


def plot_precision_recall(
    sum_stats_csv: str,
    out_path: Optional[str] = None,
    label: Optional[str] = None,
    min_len: Optional[float] = None,
):
    """Precision-recall curves, one line per min_length, threshold as the
    parameter (reference visualise.py:90-121).  ``min_len`` filters the
    sweep to a single smoothing setting (one curve)."""
    df = read_columns(sum_stats_csv)
    if min_len is not None:
        df = _match_min_len(df, min_len)
        if not _size(df):
            # An out-of-grid filter would render an empty (yet saved) figure.
            raise ValueError(
                f"no sweep rows with min_len={min_len} in {sum_stats_csv}"
            )
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    _draw_pr_curves(ax, df, label)
    return _finish_pr_axes(fig, ax, plt, out_path)


FP_COLUMNS = ("tot_fp_speech_time", "tot_fp_noise_time", "tot_fp_silence_time")


def plot_fp_confusion(
    eval_df_csv: str,
    out_path: Optional[str] = None,
    thresholds: Sequence[float] = (),
    min_len: Optional[float] = None,
):
    """Heatmap of false-positive time attributed to speech/noise/silence per
    (threshold, min_len), grouped on both like the reference
    (visualise.py:123-168); ``min_len`` filters to one setting; default
    shows each (threshold, min_len) as its own row."""
    df = read_columns(eval_df_csv)
    if thresholds:
        keep = [round(t, 6) for t in thresholds]
        df = _rows(df, np.isin(np.round(df["threshold"], 6), keep))
    if min_len is not None:
        df = _match_min_len(df, min_len)
    if not _size(df):
        # A filter value outside the sweep grid would otherwise render a
        # blank heatmap and report success.
        raise ValueError(
            f"no evaluation rows match thresholds={list(thresholds)} "
            f"min_len={min_len} in {eval_df_csv}"
        )
    keys = sorted({(t, m) for t, m in zip(df["threshold"], df["min_len"])
                   if not (math.isnan(t) or math.isnan(m))})
    data = np.asarray([
        [float(np.sum(df[c][(df["threshold"] == t) & (df["min_len"] == m)])) for c in FP_COLUMNS]
        for t, m in keys
    ]).reshape(len(keys), len(FP_COLUMNS))
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, max(3, 0.5 * len(keys))))
    im = ax.imshow(data, aspect="auto", cmap="viridis")
    ax.set_xticks(range(3))
    ax.set_xticklabels(["speech", "noise", "silence"])
    ax.set_yticks(range(len(keys)))
    ax.set_yticklabels([f"t={t} l={l}" for t, l in keys])
    for i in range(data.shape[0]):
        for j in range(data.shape[1]):
            ax.text(j, i, f"{data[i, j]:.1f}", ha="center", va="center",
                    color="white", fontsize=8)
    ax.set_title("false-positive time [s] by type")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return _finish(fig, plt, out_path)


def _per_meeting_at_threshold(
    eval_df_csv: str, threshold: float, min_len: Optional[float]
) -> Columns:
    """Per-meeting eval rows at one threshold (and optionally one min_len),
    6-decimal matched.  Raises when the filter empties, and when
    ``min_len`` is None while the CSV carries several min_len settings:
    pooling them would put every meeting in the histogram once per grid
    value."""
    df = read_columns(eval_df_csv)
    df = _rows(df, np.round(df["threshold"], 6) == round(threshold, 6))
    if min_len is not None:
        df = _match_min_len(df, min_len)
    elif "min_len" in df:
        rounded = np.round(df["min_len"], 6)
        lens = [float(v) for v in np.unique(rounded[~np.isnan(rounded)])]
        if len(lens) > 1:
            raise ValueError(
                f"eval_df has {len(lens)} min_len settings {lens}; pass "
                "min_len= (CLI: --min_len) to pick one — pooling would "
                "count every meeting once per setting"
            )
    if not _size(df):
        raise ValueError(
            f"no evaluation rows at threshold={threshold} "
            f"min_len={min_len} in {eval_df_csv}"
        )
    return df


def plot_aggregated_laughter_length_dist(
    eval_df_csv: str,
    threshold: float,
    out_path: Optional[str] = None,
    min_len: Optional[float] = None,
):
    """Histograms of per-meeting aggregated laughter time, predicted vs
    transcribed, at one threshold: three stacked panels zooming from the
    full range down to the short tail (reference analyse.py:303-357, with
    the meeting counts taken from the data and plain matplotlib
    histograms)."""
    df = _per_meeting_at_threshold(eval_df_csv, threshold, min_len)
    cols = ["tot_pred_time", "tot_transc_laugh_time"]
    # The reference's zoom levels: coarse, medium, fine.
    panels = [(1000, 50), (500, 10), (60, 1)]
    plt = _pyplot()
    fig, axs = plt.subplots(3, 1, figsize=(6, 8))
    for ax, (xmax, step) in zip(axs, panels):
        for col in cols:
            ax.hist(
                df[col], bins=np.arange(0, xmax + step, step),
                alpha=0.5, label=col,
            )
        ax.set_xlim(0, xmax)
        ax.grid(alpha=0.3)
    axs[-1].set_xlabel("Aggregated length [s]")
    axs[0].legend(fontsize=8)
    fig.supylabel("meetings")
    pred_median = float(np.nanmedian(df[cols[0]]))
    transc_median = float(np.nanmedian(df[cols[1]]))
    n_pred = int(np.sum(df["tot_pred_time"] > 0))
    fig.suptitle(
        f"Aggregated laughter per meeting (threshold {threshold})\n"
        f"median pred {pred_median:.2f}s / transc {transc_median:.2f}s; "
        f"{n_pred}/{_size(df)} meetings with predictions",
        fontsize=10,
    )
    fig.tight_layout()
    return _finish(fig, plt, out_path)


def plot_agg_pred_time_ratio_dist(
    eval_df_csv: str,
    threshold: float,
    out_path: Optional[str] = None,
    min_len: Optional[float] = None,
):
    """Distribution over meetings of predicted/transcribed laughter-time
    ratio (percent) at one threshold, with median/mean markers and the
    corpus-weighted precision/recall printed on the figure (reference
    analyse.py:359-411; meetings with no transcribed laughter are dropped
    from the ratio, and the annotation is computed from the filtered
    rows)."""
    df = _per_meeting_at_threshold(eval_df_csv, threshold, min_len)
    with_gt = _rows(df, df["tot_transc_laugh_time"] > 0)
    if not _size(with_gt):
        raise ValueError(
            f"no meetings with transcribed laughter at threshold={threshold} "
            f"in {eval_df_csv}"
        )
    ratio = with_gt["tot_pred_time"] / with_gt["tot_transc_laugh_time"] * 100.0
    median, mean = float(np.nanmedian(ratio)), float(np.nanmean(ratio))
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.hist(ratio, bins=30, alpha=0.7)
    ax.set_xlabel("pred_time / transc_time [%]")
    ax.set_ylabel("meetings")
    ax.grid(axis="y", alpha=0.3)
    ymax = ax.get_ylim()[1]
    ax.vlines(median, 0, ymax, colors="r", linestyles="dashed", label=f"median {median:.1f}%")
    ax.vlines(mean, 0, ymax, colors="b", linestyles="dashed", label=f"mean {mean:.1f}%")
    ax.legend()
    # Corpus-weighted stats over the filtered rows (sum times, then divide:
    # eval.analyse.calc_sum_stats' rule).
    tot_pred = float(np.nansum(df["tot_pred_time"]))
    tot_corr = float(np.nansum(df["corr_pred_time"]))
    tot_transc = float(np.nansum(df["tot_transc_laugh_time"]))
    prec = 1.0 if tot_pred == 0 else tot_corr / tot_pred
    recall = float("nan") if tot_transc == 0 else tot_corr / tot_transc
    ax.set_title(
        f"Predicted vs transcribed laughter time (threshold {threshold})\n"
        f"weighted precision {prec:.3f}, recall {recall:.3f}; "
        f"{int(np.sum(df['tot_pred_time'] > 0))}/{_size(df)} meetings "
        f"with predictions",
        fontsize=10,
    )
    fig.tight_layout()
    return _finish(fig, plt, out_path)


def plot_experiment_comparison(
    sum_stats_csvs: Dict[str, str],
    out_path: Optional[str] = None,
    min_len: Optional[float] = None,
):
    """Overlay precision-recall curves of several experiments (reference
    visualise.py:173-268)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    for name, path in sum_stats_csvs.items():
        df = read_columns(path)
        if min_len is not None:
            df = _match_min_len(df, min_len)
            if not _size(df):
                plt.close(fig)
                # Silently skipping one experiment would produce a
                # "comparison" missing a contender.
                raise ValueError(
                    f"no sweep rows with min_len={min_len} in {path} "
                    f"(experiment {name!r})"
                )
        _draw_pr_curves(ax, df, label=name)
    return _finish_pr_axes(fig, ax, plt, out_path)
