"""The port's plots (laughter_detection_icsi_tpu_torch/viz.py) against the
JAX package's ``viz.py`` on the same CSVs: each of the six figures, drawn
by both (no file), has the same axes, lines, bars, images, texts, labels,
limits and titles; the errors match; the port's ``cli/visualise`` refuses
what the JAX CLI refuses (tests/test_viz_and_tools.py's cases), with the
same messages.  Tolerance: exact."""

import numpy as np
import pandas as pd
import pytest

from cli import visualise as jax_cli
from laughter_detection_icsi_tpu import viz as jax_viz
from laughter_detection_icsi_tpu_torch import viz
from laughter_detection_icsi_tpu_torch.cli import visualise


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz")
    frames = {
        "metrics": {
            "global_step": [5, 10, 15, 20],
            "epoch": [0, 1, 1, 2],
            "train_loss": [0.7, 0.6, 0.5, 0.45],
            "train_acc": [0.5, 0.6, 0.7, 0.72],
            "train_precision": [0.6, 0.7, 0.75, 0.8],
            "train_recall": [0.4, 0.5, 0.6, 0.62],
            "val_loss": [0.72, 0.65, 0.6, np.nan],
            "val_acc": [0.48, 0.55, 0.6, np.nan],
            "val_precision": [0.55, 0.6, 0.65, np.nan],
            "val_recall": [0.38, 0.45, 0.5, np.nan],
        },
        "sum_stats": {
            # Unsorted thresholds: each curve is drawn in threshold order.
            "threshold": [0.5, 0.2, 0.8, 0.2, 0.8, 0.5],
            "min_len": [0.1, 0.1, 0.1, 0.2, 0.2, 0.2],
            "precision": [0.5, 0.3, 0.8, 0.35, 0.85, 0.55],
            "recall": [0.6, 0.9, 0.2, 0.85, 0.15, 0.55],
            "f1": [0.55, 0.45, 0.32, 0.5, 0.26, 0.55],
        },
        "eval_df": {
            "meeting": ["Bmr021", "Bmr021", "Btr001", "Btr001", "Bns001", "Bns001"],
            "threshold": [0.2, 0.5, 0.2, 0.5, 0.2, 0.5],
            "min_len": [0.2] * 6,
            "precision": [0.4, 0.6, 0.5, 1.0, 0.3, 0.7],
            "recall": [0.8, 0.5, 0.4, 0.2, 0.6, np.nan],
            "corr_pred_time": [8.0, 5.0, 2.0, 1.0, 3.0, 0.5],
            "tot_pred_time": [20.0, 8.3, 4.0, 1.0, 70.0, 12.5],
            "tot_transc_laugh_time": [10.0, 10.0, 5.0, 0.0, 40.0, 30.0],
            "tot_fp_speech_time": [3.0, 1.5, 1.0, 0.0, 20.0, 4.0],
            "tot_fp_noise_time": [0.5, 0.2, 0.0, 0.0, 7.5, 1.0],
            "tot_fp_silence_time": [8.0, 1.6, 1.0, 0.0, 39.5, 7.0],
        },
    }
    paths = {}
    for name, cols in frames.items():
        paths[name] = str(d / f"{name}.csv")
        pd.DataFrame(cols).to_csv(paths[name], index=False)
    multi = pd.read_csv(paths["eval_df"])
    other = multi.copy()
    other["min_len"] = 0.4
    paths["multi"] = str(d / "multi.csv")
    pd.concat([multi, other]).to_csv(paths["multi"], index=False)
    # Grid keys with float-repr noise, which the plots match at 6 decimals.
    # (Keys both parsers read alike: pandas' default parser reads some
    # 17-digit texts one ulp off, 0.30000000000000004 as 0.3, where the
    # port's csv reading rounds correctly.)
    noisy = pd.read_csv(paths["sum_stats"])
    noisy["min_len"] = [0.4000000000000001] * 3 + [0.5000000000000001] * 3
    paths["noisy"] = str(d / "noisy.csv")
    noisy.to_csv(paths["noisy"], index=False)
    return paths


def _text(t):
    return t.get_text() if t is not None else None


def _ticks(ax, axis: str) -> tuple:
    return (list(getattr(ax, f"get_{axis}ticks")()),
            [t.get_text() for t in getattr(ax, f"get_{axis}ticklabels")()])


def _describe(fig) -> list:
    """What a figure shows: per axes its lines, bars, images, texts,
    collections, ticks, labels, limits, legend and title, and the ticks of
    its secondary axes (the train plot's epochs); then the figure's
    titles."""
    fig.canvas.draw()
    out = []
    for a in fig.axes:
        out.extend(_ticks(child, "x") for child in a.child_axes)
        legend = a.get_legend()
        out.append(dict(
            title=a.get_title(), xlabel=a.get_xlabel(), ylabel=a.get_ylabel(),
            xlim=a.get_xlim(), ylim=a.get_ylim(),
            lines=[(ln.get_label(), ln.get_linestyle(), ln.get_marker(),
                    np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float))
                   for ln in a.get_lines()],
            bars=[(p.get_x(), p.get_width(), p.get_height(), p.get_label())
                  for p in a.patches],
            images=[np.asarray(im.get_array()) for im in a.get_images()],
            texts=[t.get_text() for t in a.texts],
            collections=[[np.asarray(s) for s in c.get_segments()]
                         for c in a.collections if hasattr(c, "get_segments")],
            xticks=_ticks(a, "x"), yticks=_ticks(a, "y"),
            legend=[t.get_text() for t in legend.get_texts()] if legend else None,
        ))
    out.append((_text(fig._suptitle), _text(fig._supylabel)))
    return out


PLOTS = [
    ("plot_train_metrics", lambda p: ((p["metrics"],), {"title": "run"})),
    ("plot_precision_recall", lambda p: ((p["sum_stats"],), {})),
    ("plot_precision_recall", lambda p: ((p["noisy"],), {"min_len": 0.4, "label": "x"})),
    ("plot_fp_confusion", lambda p: ((p["eval_df"],), {})),
    ("plot_fp_confusion", lambda p: ((p["multi"],), {"thresholds": [0.5], "min_len": 0.4})),
    ("plot_aggregated_laughter_length_dist", lambda p: ((p["eval_df"], 0.2), {})),
    ("plot_aggregated_laughter_length_dist", lambda p: ((p["multi"], 0.5), {"min_len": 0.4})),
    ("plot_agg_pred_time_ratio_dist", lambda p: ((p["eval_df"], 0.5), {})),
    ("plot_experiment_comparison",
     lambda p: (({"a": p["sum_stats"], "b": p["noisy"]},), {})),
]


@pytest.mark.parametrize("name,make", PLOTS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(PLOTS)])
def test_plot_shows_what_jax_shows(csvs, name, make):
    import matplotlib.pyplot as plt

    args, kw = make(csvs)
    want = getattr(jax_viz, name)(*args, out_path=None, **kw)
    got = getattr(viz, name)(*args, out_path=None, **kw)
    try:
        np.testing.assert_equal(_describe(got), _describe(want))
    finally:
        plt.close(got)
        plt.close(want)


ERRORS = [
    ("plot_aggregated_laughter_length_dist", lambda p: (p["eval_df"], 0.9), {}, "threshold=0.9"),
    ("plot_agg_pred_time_ratio_dist", lambda p: (p["eval_df"], 0.9), {}, "threshold=0.9"),
    ("plot_aggregated_laughter_length_dist", lambda p: (p["multi"], 0.5), {}, "min_len settings"),
    ("plot_agg_pred_time_ratio_dist", lambda p: (p["multi"], 0.5), {}, "min_len settings"),
    ("plot_agg_pred_time_ratio_dist", lambda p: (p["metrics_no_gt"], 0.5), {},
     "transcribed laughter"),
    ("plot_precision_recall", lambda p: (p["sum_stats"],), {"min_len": 99}, "min_len=99"),
    ("plot_fp_confusion", lambda p: (p["eval_df"],), {"thresholds": [0.9]}, "thresholds=[0.9]"),
    ("plot_experiment_comparison", lambda p: ({"a": p["sum_stats"]},), {"min_len": 99},
     "experiment 'a'"),
]


def test_errors_match_jax(csvs, tmp_path):
    no_gt = pd.read_csv(csvs["eval_df"])
    no_gt["tot_transc_laugh_time"] = 0.0
    paths = dict(csvs, metrics_no_gt=str(tmp_path / "no_gt.csv"))
    no_gt.to_csv(paths["metrics_no_gt"], index=False)
    for name, make, kw, needle in ERRORS:
        with pytest.raises(ValueError, match=needle.replace("[", r"\[")) as theirs:
            getattr(jax_viz, name)(*make(paths), out_path=None, **kw)
        with pytest.raises(ValueError, match=needle.replace("[", r"\[")) as ours:
            getattr(viz, name)(*make(paths), out_path=None, **kw)
        if needle != "min_len settings":  # JAX prints numpy scalars in its list
            assert str(ours.value) == str(theirs.value), name


def test_visualise_cli_refuses_what_jax_refuses(csvs, tmp_path):
    out = str(tmp_path / "x.png")
    s, e, m = csvs["sum_stats"], csvs["eval_df"], csvs["metrics"]
    for argv in (
        ["lengthdist", e, "--out", out],
        ["pr", s, "--out", out, "--threshold", "0.5"],
        ["ratiodist", s, "--out", out, "--threshold", "0.5"],
        ["pr", e, "--out", out],
        ["confusion", s, "--out", out],
        ["train", s, "--out", out],
        ["compare", f"a={e}", "--out", out],
        ["compare", s, "--out", out],
        ["compare", f"a={s}", f"a={s}", "--out", out],
        ["pr", s, s, "--out", out],
        ["train", m, "--out", out, "--min_len", "0.2"],
        ["pr", s, "--out", out, "--title", "t"],
    ):
        with pytest.raises(SystemExit) as theirs:
            jax_cli.main(argv)
        with pytest.raises(SystemExit) as ours:
            visualise.main(argv)
        assert str(ours.value) == str(theirs.value), argv
    for argv in (["pr", s, "--out", out, "--min_len", "99"],
                 ["compare", f"a={s}", "--out", out, "--min_len", "99"]):
        with pytest.raises(ValueError) as theirs:
            jax_cli.main(argv)
        with pytest.raises(ValueError) as ours:
            visualise.main(argv)
        assert str(ours.value) == str(theirs.value), argv
    assert not (tmp_path / "x.png").exists()


def test_visualise_cli_writes_each_mode(csvs, tmp_path):
    for argv in (
        ["train", csvs["metrics"], "--title", "run"],
        ["pr", csvs["noisy"], "--min_len", "0.5"],
        ["confusion", csvs["eval_df"]],
        ["lengthdist", csvs["eval_df"], "--threshold", "0.5"],
        ["ratiodist", csvs["multi"], "--threshold", "0.2", "--min_len", "0.2"],
        ["compare", f"a={csvs['sum_stats']}", f"b={csvs['noisy']}"],
    ):
        out = tmp_path / f"{argv[0]}.png"
        assert visualise.main(argv + ["--out", str(out)]) == 0
        assert out.stat().st_size > 10_000, argv


def test_plots_without_matplotlib_name_it(csvs, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.plot_precision_recall(csvs["sum_stats"])
