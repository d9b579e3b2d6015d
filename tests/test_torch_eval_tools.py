"""The port's remaining eval tools against the JAX package: the pandas-free
comparison report (byte-equal CSV), summarize_multiplex_dir, the lines the
LMCC plots draw, evaluate_synthetic_dir, the baseline / analyze /
summarize-edges / draw subcommands and model_vs_heuristics."""

import io
import json
import os
import runpy
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("pandas")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.eval.analysis import comparison_report as jax_report  # noqa: E402
from mdcommunity_tpu.graphs.io import summarize_multiplex_dir as jax_summary  # noqa: E402
from mdcommunity_tpu_torch.cli import main as cli  # noqa: E402
from mdcommunity_tpu_torch.eval.analysis import comparison_report  # noqa: E402
from mdcommunity_tpu_torch.eval.writers import append_time_audc  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import summarize_multiplex_dir  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models_tpu", "unit_cost_full_r1", "best_model.ckpt")

# (unit-cost table, community table): missing sides, zero denominators
# (0 and 0/0), integer columns, repeated and numeric dataset names, a
# headerless file, upper-case and padded headers, very large and small values
TABLES = {
    "written": None,  # by eval/writers.append_time_audc, below
    "missing_and_zero": ("dataset,time,audc\nfb-tw,1.234567,0.12345678\n"
                         "homo,0.000000,0.00000000\nzzz,2.5,0.3\nq,0,1\n",
                         "Dataset ,Time,AUDC\nhomo,3.000000,0.20000000\nabc,1.0,0.5\n"
                         "fb-tw,1.1,0.1\nq,4,0\n"),
    "integers": ("dataset,time,audc\nz,1,2\na,3,4\nm,5,6\n",
                 "dataset,time,audc\nm,1,0.5\nz,2,1e-05\na,1e16,123456789012345678\n"),
    "repeated": ("dataset,time,audc\nm,1,0.5\nm,2,0.25\nb,3,1\n",
                 "dataset,time,audc\nm,7,0.5\nm,8,0.125\nb,0,0\n"),
    "numeric_names": ("dataset,time,audc\n3,1,2\n1,3,4\n20,5,6\n",
                      "dataset,time,audc\nx,1,2\n3,2,2\n"),
    "headerless": ("fb-tw,1,2\nx,3,4\ny,,5\n", "dataset,time,audc\nx,1.5,NA\ny,2,3\n"),
    "negative": ("dataset,time,audc\na,-1.0,-0.0\nb,2,0\n",
                 "dataset,time,audc\na,1,0\nb,-3,-0.5\n"),
}


def _tables(kind, tmp_path):
    a, b = tmp_path / "unit", tmp_path / "comm"
    a.mkdir()
    b.mkdir()
    if kind == "written":
        for i, (t, s) in enumerate([(1.5, 0.1), (0.0, 0.0), (2.25, 0.3)]):
            append_time_audc(str(a / "time&audc_syn.csv"), f"syn_{i}", t, s)
        for i, (t, s) in enumerate([(1.0, 0.2), (3.0, 0.25), (1e-7, 1e-9), (4.0, 0.5)]):
            append_time_audc(str(b / "time&audc_syn.csv"), f"syn_{i + 1}", t, s)
        return str(a), str(b)  # the directory form
    for d, text in zip((a, b), TABLES[kind]):
        (d / "time&audc_x.csv").write_text(text)
    return str(a / "time&audc_x.csv"), str(b / "time&audc_x.csv")


@pytest.mark.parametrize("kind", list(TABLES))
def test_comparison_report_bytes_equal_pandas(kind, tmp_path):
    a, b = _tables(kind, tmp_path)
    for x, y in ((a, b), (b, a), (a, a)):
        jax_report(x, y, str(tmp_path / "jax.csv"))
        rows = comparison_report(x, y, str(tmp_path / "sub" / "port.csv"))
        want = (tmp_path / "jax.csv").read_bytes()
        assert (tmp_path / "sub" / "port.csv").read_bytes() == want, want.decode()
        assert len(rows) == want.count(b"\n") - 1


def test_comparison_report_needs_both_metrics(tmp_path):
    (tmp_path / "a.csv").write_text("dataset,time\nq,1\n")
    (tmp_path / "b.csv").write_text("dataset,time,audc\nq,1,2\n")
    with pytest.raises(KeyError):
        jax_report(str(tmp_path / "a.csv"), str(tmp_path / "b.csv"), str(tmp_path / "o.csv"))
    with pytest.raises(KeyError):
        comparison_report(str(tmp_path / "a.csv"), str(tmp_path / "b.csv"),
                          str(tmp_path / "o.csv"))
    with pytest.raises(FileNotFoundError):
        comparison_report(str(tmp_path), str(tmp_path), str(tmp_path / "o.csv"))


def _edges_dir(tmp_path):
    d = tmp_path / "edges"
    d.mkdir()
    (d / "two.edges").write_text(
        "1 1 2\n1 2 3 0.5\n2 2 3\n2 3 4\n3 7 8\n3 8 9\n3 9 7\n"
        "# comment line\n\n1 x 4\n2 5\n2 4 5\n")
    (d / "one.edges").write_text("4 1 2\n4 2 3\n")
    (d / "empty.edges").write_text("")
    (d / "notes.txt").write_text("1 1 2\n")
    return d


def test_summarize_multiplex_dir_equals_jax(tmp_path):
    d = _edges_dir(tmp_path)
    want = jax_summary(str(d), str(tmp_path / "jax.csv"))
    got = summarize_multiplex_dir(str(d), str(tmp_path / "out" / "port.csv"))
    assert got == want
    assert [r["dataset"] for r in got] == ["empty", "one", "two"]
    assert got[1]["layer_m"] == "" and got[2]["n_layers"] == 3
    assert (tmp_path / "out" / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def _curve_files(tmp_path):
    rng = np.random.default_rng(0)
    files = {}
    for name, m in (("model", 30), ("hda", 24)):
        y = np.sort(rng.random(m))[::-1]
        (tmp_path / f"lmcc_{name}.txt").write_text(
            "".join(f"{v:.8f}\n" for v in y) + "0.05\n0.01\n")
        c = np.cumsum(rng.random(m + 3) / m)
        (tmp_path / f"cost_{name}.txt").write_text(
            "".join(f"{v:.8f}\n" for v in c) + "0.123\n")
        files[name] = (str(tmp_path / f"cost_{name}.txt"), str(tmp_path / f"lmcc_{name}.txt"))
    return files


def _drawn(monkeypatch, fn, *args, **kw):
    """The (label, x, y) of each line fn draws, read before its figure
    closes."""
    import matplotlib.pyplot as plt

    seen = []
    close = plt.close

    def spy(fig=None):
        seen.extend((ln.get_label(), np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
                    for ln in fig.axes[0].lines)
        close(fig)

    monkeypatch.setattr(plt, "close", spy)
    fn(*args, **kw)
    monkeypatch.setattr(plt, "close", close)
    return seen


@pytest.mark.parametrize("weighted", [False, True])
def test_plot_lines_equal_jax(weighted, tmp_path, monkeypatch):
    from mdcommunity_tpu.eval.plots import plot_lmcc_curves as jax_plot
    from mdcommunity_tpu_torch.eval.plots import plot_lmcc_curves

    files = _curve_files(tmp_path)
    curves = {k: (v if weighted else v[1]) for k, v in files.items()}
    if weighted:
        curves["bare"] = files["hda"][1]  # a bare LMCC path: the node fraction
    want = _drawn(monkeypatch, jax_plot, curves, str(tmp_path / "j.png"), "t", weighted)
    got = _drawn(monkeypatch, plot_lmcc_curves, curves, str(tmp_path / "p" / "p.png"), "t",
                 weighted)
    assert len(got) == len(want) == len(curves)
    for (gl, gx, gy), (wl, wx, wy) in zip(got, want):
        assert gl == wl and np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert (tmp_path / "p" / "p.png").stat().st_size > 0


def test_plot_without_matplotlib_names_it(tmp_path, monkeypatch):
    from mdcommunity_tpu_torch.eval.plots import plot_lmcc_curves

    files = _curve_files(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_lmcc_curves({"m": files["model"][1]}, str(tmp_path / "x.png"))


def _write_pairs(d, n, count, seed):
    from mdcommunity_tpu.graphs.gmm import gmm_duplex_edges

    rng = np.random.default_rng(seed)
    os.makedirs(d / f"syn_{n}")
    for i in range(count):
        for j, e in enumerate(gmm_duplex_edges(n, rng)):
            a = np.zeros((n, n), np.int64)
            a[e[:, 0], e[:, 1]] = a[e[:, 1], e[:, 0]] = 1
            np.save(d / f"syn_{n}" / f"adj{j + 1}_{i}.npy", a)


@pytest.mark.parametrize("variant,ckpt", [
    ("unit_cost", "unit_cost_full_r1"), ("degree_cost", "degree_cost_full_r1")])
def test_evaluate_synthetic_dir_equals_jax(variant, ckpt, tmp_path):
    from mdcommunity_tpu.eval.synthetic import evaluate_synthetic_dir as jax_dir
    from mdcommunity_tpu_torch.eval.synthetic import evaluate_synthetic_dir
    from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params

    path = os.path.join(REPO, "models_tpu", ckpt, "best_model.ckpt")
    _write_pairs(tmp_path, 30, 3, 4)
    want = jax_dir(load_params(path), str(tmp_path), "30", n_graphs=5, variant=variant)
    got = evaluate_synthetic_dir(load_model(path, device="cpu"), str(tmp_path), "30",
                                 n_graphs=5, variant=variant, device="cpu")
    np.testing.assert_allclose([got[0], got[1], got[4]], [want[0], want[1], want[4]],
                               rtol=1e-6)
    with pytest.raises(FileNotFoundError):
        evaluate_synthetic_dir(load_model(path, device="cpu"), str(tmp_path), "64",
                               device="cpu")


def _run(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        cli(argv)
    return out.getvalue()


def test_cli_baseline_cpu_equals_jax(tmp_path):
    from mdcommunity_tpu.cli import main as jax_cli

    for method, extra in (("degree", []), ("ci", ["--syn-stop"]),
                          ("closeness", ["--combine", "add", "--protect-frac", "0.05"])):
        argv = ["baseline", "--method", method, "--size", "32", "--n-graphs", "3",
                "--seed", "2", *extra]
        want = io.StringIO()
        with redirect_stdout(want):
            jax_cli(argv + ["--cpu", "-o", str(tmp_path / f"j_{method}.csv")])
        got = _run(argv + ["--cpu", "-o", str(tmp_path / f"t_{method}.csv")])
        assert json.loads(got) == json.loads(want.getvalue())
        names = [ln.split(",")[0] for ln in (tmp_path / f"t_{method}.csv").read_text().split()]
        assert names == [ln.split(",")[0]
                         for ln in (tmp_path / f"j_{method}.csv").read_text().split()]


def test_cli_analyze_summarize_draw_cpu(tmp_path):
    a, b = _tables("written", tmp_path)
    _run(["analyze", "--unitcost", a, "--community", b, "-o", str(tmp_path / "r.csv"),
          "--cpu"])
    jax_report(a, b, str(tmp_path / "j.csv"))
    assert (tmp_path / "r.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()

    d = _edges_dir(tmp_path)
    out = _run(["summarize-edges", "--data", str(d), "-o", str(tmp_path / "s.csv")])
    lines = out.splitlines()
    assert lines[0] == "dataset\tn_nodes\tn_layers\tlayer_m\tlayer_n"
    assert lines[-1] == f"Summary written to: {tmp_path / 's.csv'}"
    assert len(lines) == 5 and lines[3].startswith("two\t9\t3\t")

    files = _curve_files(tmp_path)
    png = tmp_path / "plots" / "w.png"
    out = _run(["draw", f"model={files['model'][0]}:{files['model'][1]}",
                f"hda={files['hda'][1]}", "-o", str(png), "--weighted", "--title", "t"])
    assert out.strip() == f"wrote {png}" and png.stat().st_size > 0


def test_model_vs_heuristics_equals_jax_script(monkeypatch, capsys):
    from mdcommunity_tpu_torch import model_vs_heuristics

    args = ["--sizes", "32", "--n-graphs", "2", "--syn-stop"]
    monkeypatch.setattr(sys, "argv", ["model_vs_heuristics.py", "--model", CKPT, "--cpu",
                                      *args])
    runpy.run_path(os.path.join(REPO, "scripts", "model_vs_heuristics.py"),
                   run_name="__main__")
    want = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    rows = model_vs_heuristics.main(args + ["--cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows == want == lines[:-1]
    assert lines[-1] == {"device": "cpu", "gpu": None}
