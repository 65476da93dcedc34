"""The port's figures, held against the JAX package's on the CPU.

- ``plot_cdf``, ``plot_delta_k`` and ``plot_consensus_matrix`` draw the
  same figure as the reference's on the same inputs (made from a numpy
  seed): every line's data, colour, width, marker and label, the legend,
  the PAC band, the axis labels, limits and ticks, the figure's size and
  dpi, the heatmap's image array, colour map and limits, the colorbar's
  label; the PNGs they save are equal byte for byte.
- ``fit(plot_cdf=True)`` draws one figure, once, at the end of every
  path (exact, streamed, in K batches, resumed, estimated), whose curves
  are ``[0] + cdf`` of the fit's results.
- ``run --plot-dir`` writes the reference's files (the heatmap only when
  Cij is kept), after the JSON; its CDF figure draws the printed run.
- Without matplotlib a plotting ``fit`` and ``run --plot-dir`` raise
  ``ImportError`` after the sweep, as the reference's do.
- The two constructors have the same defaults, ``plot_cdf=True`` among
  them.
"""

import inspect
import json
import os
import sys

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from consensus_clustering_tpu import ConsensusClustering as JaxCC  # noqa: E402
from consensus_clustering_tpu.cli import main as jax_main  # noqa: E402
from consensus_clustering_tpu.utils import plotting as ref  # noqa: E402
from consensus_clustering_tpu_torch import (  # noqa: E402
    ConsensusClustering,
    make_blobs,
)
from consensus_clustering_tpu_torch.cli import main  # noqa: E402
from consensus_clustering_tpu_torch.ops import _build  # noqa: E402
from consensus_clustering_tpu_torch.utils import plotting  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORR_CSV = os.path.join(REPO, "consensus_clustering_tpu_torch", "data",
                        "corr.csv")


@pytest.fixture(autouse=True)
def _no_figures_left(monkeypatch):
    """Every test starts and ends with no open figure; ``plt.show`` is
    counted, not run; each CLI call's build-dir choice is undone."""
    plt.close("all")
    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(1))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setenv("CCTPU_COMPILATION_CACHE", "off")
    yield shown
    plt.close("all")


def _cdf_data(ks, seed, bins=20):
    rng = np.random.default_rng(seed)
    out = {}
    for k in ks:
        hist = rng.random(bins)
        cdf = np.cumsum(hist) / hist.sum()
        out[k] = {"bin_edges": np.linspace(0.0, 1.0, bins + 1), "cdf": cdf,
                  "pac_area": float(cdf[17] - cdf[2])}
    return out


def _cij(n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n)
    cij = np.clip((labels[:, None] == labels[None, :]) * 0.8
                  + rng.random((n, n)) * 0.2, 0.0, 1.0)
    cij = (cij + cij.T) / 2
    np.fill_diagonal(cij, 1.0)
    return cij, labels


def _axes_record(ax):
    legend = ax.get_legend()
    return {
        "lines": [(np.asarray(line.get_xdata(), float).tolist(),
                   np.asarray(line.get_ydata(), float).tolist(),
                   line.get_color(), line.get_label(), line.get_linewidth(),
                   line.get_marker(), line.get_markersize())
                  for line in ax.get_lines()],
        "legend": None if legend is None else [
            t.get_text() for t in legend.get_texts()],
        "spans": [(p.get_xy(), p.get_width(), p.get_height(),
                   p.get_facecolor(), p.get_label()) for p in ax.patches],
        "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
        "limits": (ax.get_xlim(), ax.get_ylim()),
        "ticks": (ax.get_xticks().tolist(), ax.get_yticks().tolist()),
        "images": [(np.ma.getdata(im.get_array()).tolist(),
                    im.get_cmap().name, im.get_clim())
                   for im in ax.get_images()],
        "spines": {side: s.get_visible() for side, s in ax.spines.items()},
    }


def _record(fig):
    """What a reader of the figure sees, as comparable data."""
    return {"size": tuple(fig.get_size_inches()), "dpi": fig.dpi,
            "axes": [_axes_record(ax) for ax in fig.axes]}


_CASES = {
    "cdf_four_k": lambda m: m.plot_cdf(_cdf_data([2, 3, 4, 5], 0),
                                       show=False),
    "cdf_one_k": lambda m: m.plot_cdf(_cdf_data([7], 1), show=False),
    "cdf_ten_k_two_columns": lambda m: m.plot_cdf(
        _cdf_data(range(2, 12), 2), show=False),
    "cdf_interval": lambda m: m.plot_cdf(
        _cdf_data([2, 5, 9], 3), pac_interval=(0.2, 0.8), show=False),
    "delta_k_given": lambda m: m.plot_delta_k(
        [2, 3, 4, 5, 6], np.random.default_rng(4).random(5),
        np.random.default_rng(5).random(5), show=False),
    "delta_k_computed": lambda m: m.plot_delta_k(
        [2, 3, 4, 5, 6], np.sort(np.random.default_rng(6).random(5)),
        show=False),
    "delta_k_unsorted": lambda m: m.plot_delta_k(
        [5, 2, 3], [0.4, 0.1, 0.3], show=False),
    "matrix_labels": lambda m: m.plot_consensus_matrix(
        *_cij(17, 7), show=False),
    "matrix_no_labels": lambda m: m.plot_consensus_matrix(
        _cij(13, 8)[0], show=False),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_figure_equals_the_reference(case):
    theirs = _record(_CASES[case](ref))
    ours = _record(_CASES[case](plotting))
    assert ours == theirs
    assert ours["axes"]


def test_colorbar_label_and_heatmap_order():
    cij, labels = _cij(11, 9)
    figs = [m.plot_consensus_matrix(cij, labels, show=False)
            for m in (ref, plotting)]
    assert [f.axes[1].get_ylabel() for f in figs] == ["consensus index"] * 2
    order = np.argsort(labels, kind="stable")
    np.testing.assert_array_equal(
        np.asarray(figs[1].axes[0].get_images()[0].get_array()),
        cij[np.ix_(order, order)])


def test_delta_k_computed_equals_the_reference_function():
    from consensus_clustering_tpu.ops.analysis import delta_k

    areas = np.random.default_rng(10).random(6)
    fig = plotting.plot_delta_k(range(2, 8), areas, show=False)
    np.testing.assert_array_equal(fig.axes[1].get_lines()[0].get_ydata(),
                                  delta_k(areas))


@pytest.mark.parametrize("fn", ["plot_cdf", "plot_delta_k",
                                "plot_consensus_matrix"])
def test_saved_png_equals_the_reference(fn, tmp_path):
    args = {"plot_cdf": (_cdf_data([2, 3, 4], 11),),
            "plot_delta_k": ([2, 3, 4], [0.2, 0.5, 0.6]),
            "plot_consensus_matrix": _cij(9, 12)}[fn]
    paths = []
    for name, module in (("ref", ref), ("port", plotting)):
        paths.append(tmp_path / f"{name}.png")
        getattr(module, fn)(*args, show=False, save_path=str(paths[-1]))
    data = [p.read_bytes() for p in paths]
    assert data[0] and data[0] == data[1]


@pytest.mark.parametrize("fn", ["plot_cdf", "plot_delta_k",
                                "plot_consensus_matrix"])
def test_signatures_equal_the_reference(fn):
    assert (inspect.signature(getattr(plotting, fn))
            == inspect.signature(getattr(ref, fn)))


def test_constructor_defaults_equal_the_reference():
    theirs = inspect.signature(JaxCC.__init__).parameters
    ours = inspect.signature(ConsensusClustering.__init__).parameters
    assert {n: p.default for n, p in ours.items() if n != "device"} == {
        n: p.default for n, p in theirs.items()}
    assert ours["plot_cdf"].default is True


# -- fit(plot_cdf=True) --------------------------------------------------


@pytest.fixture(scope="module")
def blobs():
    x, _ = make_blobs(n_samples=90, n_features=4, centers=3,
                      cluster_std=1.0, random_state=4)
    return x.astype(np.float32)


def _drawn_curves():
    """The one open figure's curves, as lists."""
    (num,) = plt.get_fignums()
    (ax,) = plt.figure(num).axes
    return [list(line.get_ydata()) for line in ax.get_lines()]


def _assert_drew_the_fit(cc, shown):
    ks = sorted(cc.cdf_at_K_data)
    assert _drawn_curves() == [
        [0.0] + list(cc.cdf_at_K_data[k]["cdf"]) for k in ks]
    assert len(shown) == 1


@pytest.mark.parametrize("path", [
    dict(),
    dict(stream_h_block=4, accum_repr="packed"),
    dict(k_batch_size=1),
    dict(mode="estimate"),
])
def test_fit_draws_its_cdf_once(blobs, path, _no_figures_left):  # jaxlint: disable=JL018 -- the port at N=90, H=12 on the CPU
    cc = ConsensusClustering(K_range=(2, 3, 4), n_iterations=12,
                             random_state=9, device="cpu", plot_cdf=True,
                             **path).fit(blobs)
    _assert_drew_the_fit(cc, _no_figures_left)
    if path.get("mode") == "estimate":
        assert cc.metrics_["mode"] == "estimate"


def test_resumed_fit_draws_once(blobs, tmp_path, _no_figures_left):  # jaxlint: disable=JL018 -- the port at N=90, H=12 on the CPU
    kw = dict(K_range=(2, 3, 4), n_iterations=12, random_state=9,
              device="cpu", checkpoint_dir=str(tmp_path))
    first = ConsensusClustering(**kw, plot_cdf=False).fit(blobs)
    assert plt.get_fignums() == []
    events = tmp_path / "events.jsonl"
    again = ConsensusClustering(**kw, plot_cdf=True,
                                metrics_path=str(events)).fit(blobs)
    (done,) = [e for e in map(json.loads, events.read_text().splitlines())
               if e["event"] == "sweep_complete"]
    assert done["resumed_ks"] == [2, 3, 4]
    _assert_drew_the_fit(again, _no_figures_left)
    for k in (2, 3, 4):
        assert (again.cdf_at_K_data[k]["pac_area"]
                == first.cdf_at_K_data[k]["pac_area"])


def test_fit_without_matplotlib_raises_after_the_sweep(blobs, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for cls, x, extra in ((ConsensusClustering, blobs, dict(device="cpu")),
                          (JaxCC, blobs[:30], {})):
        cc = cls(K_range=(2, 3), n_iterations=6, random_state=1,
                 plot_cdf=True, **extra)
        with pytest.raises(ImportError, match="matplotlib"):
            cc.fit(x)
        assert sorted(cc.cdf_at_K_data) == [2, 3]
        assert cc.best_k_ in (2, 3)


# -- run --plot-dir ------------------------------------------------------


def _run_argv(tmp_path, name, *extra):
    return ["run", "--dataset", CORR_CSV, "--k", "2:4", "--iterations", "6",
            "--seed", "5", "--out", str(tmp_path / f"{name}.json"),
            "--plot-dir", str(tmp_path / name), *extra]


@pytest.mark.parametrize("store", ["auto", "off"])
def test_plot_dir_writes_the_reference_files(store, tmp_path, monkeypatch,
                                             capsys):
    drawn = []
    inner = plotting.plot_cdf

    def spy(data, **kwargs):
        fig = inner(data, **kwargs)
        drawn.append((data, _record(fig)))
        return fig

    monkeypatch.setattr(plotting, "plot_cdf", spy)
    jax_main(_run_argv(tmp_path, "ref", "--store-matrices", store))
    main(_run_argv(tmp_path, "port", "--store-matrices", store,
                   "--device", "cpu"))
    capsys.readouterr()
    names = {side: sorted(os.listdir(tmp_path / side))
             for side in ("ref", "port")}
    result = json.loads((tmp_path / "port.json").read_text())
    best = result["best_k"]
    expect = ["cdf.png", "delta_k.png"] + (
        [f"consensus_matrix_K{best}.png"] if store == "auto" else [])
    assert names["port"] == sorted(expect)
    assert sorted(n for n in names["ref"] if not n.startswith(
        "consensus_matrix")) == ["cdf.png", "delta_k.png"]
    assert len(names["ref"]) == len(names["port"])
    assert all(os.path.getsize(tmp_path / "port" / n) > 0
               for n in names["port"])
    ((data, fig),) = drawn
    assert {str(k): v["pac_area"] for k, v in data.items()} == \
        result["pac_area"]
    assert [line[1] for line in fig["axes"][0]["lines"]] == [
        [0.0] + list(data[k]["cdf"]) for k in (2, 3, 4)]


def test_plot_dir_without_matplotlib_keeps_the_json(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = _run_argv(tmp_path, "port", "--device", "cpu")
    argv.remove("--out")
    argv.remove(str(tmp_path / "port.json"))
    with pytest.raises(ImportError, match="matplotlib"):
        main(argv)
    printed = json.loads(capsys.readouterr().out)
    assert printed["K"] == [2, 3, 4] and printed["best_k"] in (2, 3, 4)


@pytest.mark.parametrize("extra", [
    ["--mode", "estimate"],
    ["--stream", "4", "--adaptive", "0.01"],
])
def test_plot_dir_refusals_equal_the_reference(extra, tmp_path):
    said = []
    for entry, device in ((jax_main, []), (main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            entry(_run_argv(tmp_path, "x", *extra, *device))
        said.append(str(exc.value.code))
    assert said[0] == said[1] and "--plot-dir" in said[1]
    assert not (tmp_path / "x").exists()
