"""The port imports neither jax, optax, networkx, pandas, matplotlib nor the
JAX package, and its entry points run on the card unless the caller asks for
the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mdcommunity_tpu_torch")


def _submodules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([PKG], prefix="mdcommunity_tpu_torch.")
    )


def test_import_leaves_jax_out():
    """A fresh interpreter (conftest.py imports jax in this one) imports the
    package and every submodule, the checkpoint loader runs (every variant's
    committed checkpoints) and so do the CE prior and the HCA structure,
    with none of jax, networkx, pandas and matplotlib imported."""
    mods = _submodules()
    for m in ("ops.band_kernels", "rl.big_trainer", "train_1m", "ops.blocked_kernels",
              "graphs.duplex", "graphs.gmm", "graphs.blocked", "env.cascade", "env.env",
              "env.batch", "rl.dqn", "eval.synthetic", "parallel.mesh",
              "parallel.band_partition", "ops.probe_kernels", "graphs.synth",
              "utils.timing", "probe_f32_epi", "bench_nibble", "tune_band",
              "probe_hbm_roof", "rl.replay", "rl.replay_prioritized",
              "utils.profiling", "cli", "graphs.louvain", "graphs.community",
              "graphs.hca", "models.hca", "models.hca_banded", "graphs.centrality",
              "eval.baselines", "eval.analysis", "eval.plots", "ops.band_spmm",
              "parallel.partition", "model_vs_heuristics", "multihost_smoke",
              "bench_spmm", "scaling_bench", "bench_cascade_host", "bf16_ab_train"):
        assert f"mdcommunity_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params\n"
        "load_params('models_tpu/unit_cost_full_r1/best_model.ckpt')\n"
        "for d in ('degree_100k_r5', 'ce_100k_r5', 'hca_100k_r5', 'degree_cost_full_r1',\n"
        "          'ce_full_r1', 'hca_full_r1'):\n"
        "    load_model(f'models_tpu/{d}/best_model.ckpt', device='cpu')\n"
        "from mdcommunity_tpu_torch.graphs.io import duplex_from_layers\n"
        "e = [(0, 1), (1, 2), (2, 0), (3, 4)]\n"
        "duplex_from_layers(5, e, e, prior_feature='boundary', hca=True, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'networkx', 'pandas', 'matplotlib', "
        "'mdcommunity_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


_BAD_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|optax|networkx|mdcommunity_tpu)(\s|\.|$)", re.M
)
# matplotlib only inside the functions that draw (eval/plots.py)
_TOP_IMPORT = re.compile(r"^(import|from)\s+(pandas|matplotlib)(\s|\.|$)", re.M)


def test_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _BAD_IMPORT.search(src), path
        assert not _TOP_IMPORT.search(src), path
        assert "import pandas" not in src, path


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    """With device unset and no CUDA card, entry points raise instead of
    falling back to the CPU."""
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.array([[0, 1], [1, 2], [2, 3]])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_banded_duplex(4, e, e, S=8, B=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        from mdcommunity_tpu_torch.large_graph_demo import main

        main(["--sizes", "16"])
    banded, _, _ = build_banded_duplex(4, e, e, S=8, B=8, device="cpu")
    assert banded.device.type == "cpu"


def test_constructors_need_cuda_unless_cpu_asked(monkeypatch):
    """The model and band constructors resolve their device as the entry
    points do: CUDA unless the caller names one."""
    from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params
    from mdcommunity_tpu_torch.models.net import from_jax_params
    from mdcommunity_tpu_torch.ops.dense_band import build_dense_band
    from mdcommunity_tpu_torch.train_1m import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = "models_tpu/unit_cost_full_r1/best_model.ckpt"
    s, d = np.array([0, 1]), np.array([1, 0])
    for call in (lambda: load_model(ckpt), lambda: from_jax_params(load_params(ckpt)),
                 lambda: build_dense_band(s, d, 4, S=8, B=8),
                 lambda: main(["--n", "64", "--iters", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert load_model(ckpt, device="cpu").w_n2l.device.type == "cpu"
    assert build_dense_band(s, d, 4, S=8, B=8, device="cpu").device.type == "cpu"


def test_small_graph_entry_points_need_cuda_unless_cpu_asked(monkeypatch, tmp_path):
    """The small-graph slice's graph constructors and entry points resolve their
    device as the others do: CUDA unless the caller names one."""
    from mdcommunity_tpu_torch.eval.real import evaluate_real
    from mdcommunity_tpu_torch.eval.synthetic import evaluate_synthetic_generated
    from mdcommunity_tpu_torch.graphs.blocked import build_blocked_duplex
    from mdcommunity_tpu_torch.graphs.duplex import build_duplex
    from mdcommunity_tpu_torch.graphs.gmm import generate_pool
    from mdcommunity_tpu_torch.graphs.io import duplex_from_layers
    from mdcommunity_tpu_torch.large_graph_demo import write_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.ops.blocked_kernels import build_block_coo
    from mdcommunity_tpu_torch.rl.dqn import make_valid_pool
    from mdcommunity_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
    net = load_model("models_tpu/unit_cost_full_r1/best_model.ckpt", device="cpu")
    write_edges(str(tmp_path / "toy.edges"), e, e)
    calls = [
        lambda: build_duplex(4, e, e, 8, 128),
        lambda: duplex_from_layers(4, e, e),
        lambda: generate_pool(np.random.default_rng(0), 1, 30, 50, 64, 1024),
        lambda: build_blocked_duplex(4, e, e, S=8, T=8),
        lambda: build_block_coo(e[:, 0], e[:, 1], 4, 8, 8),
        lambda: make_valid_pool(Config(n_valid=1)),
        lambda: evaluate_synthetic_generated(net, [32], n_graphs=1),
        lambda: evaluate_real(net, str(tmp_path), "toy.edges", str(tmp_path / "out"),
                              n_nodes=4, layers=(1, 2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert build_duplex(4, e, e, 8, 128, device="cpu").device.type == "cpu"


def test_trainer_entry_points_need_cuda_unless_cpu_asked(monkeypatch, tmp_path):
    """The DQN agent and `cli train` resolve their device as the other entry
    points do: CUDA unless the caller passes device="cpu" or --cpu."""
    import dataclasses

    from mdcommunity_tpu_torch.cli import main
    from mdcommunity_tpu_torch.rl.dqn import DQNAgent
    from mdcommunity_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(Config().smoke, max_iteration=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        DQNAgent(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", "--smoke", "--save-dir", str(tmp_path / "x")])
    assert DQNAgent(cfg, device="cpu").device.type == "cpu"


def test_baseline_entry_points_need_cuda_unless_cpu_asked(monkeypatch, capsys):
    """`cli baseline` and model_vs_heuristics run on the card unless --cpu
    is given, as the other entry points do."""
    from mdcommunity_tpu_torch import model_vs_heuristics
    from mdcommunity_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: main(["baseline", "--size", "32", "--n-graphs", "1"]),
                 lambda: model_vs_heuristics.main(["--sizes", "32", "--n-graphs", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    main(["baseline", "--size", "32", "--n-graphs", "1", "--cpu"])
    assert '"method": "degree"' in capsys.readouterr().out
