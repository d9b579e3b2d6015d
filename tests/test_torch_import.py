"""The port imports neither jax, optax nor the JAX package, and its entry
points run on the card unless the caller asks for the CPU."""

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
    package and every submodule, and the checkpoint loader runs."""
    mods = _submodules()
    assert "mdcommunity_tpu_torch.ops.band_kernels" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from mdcommunity_tpu_torch.models.checkpoint import load_params\n"
        "load_params('models_tpu/unit_cost_full_r1/best_model.ckpt')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'mdcommunity_tpu')]\n"
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
    r"^\s*(import|from)\s+(jax|jaxlib|optax|mdcommunity_tpu)(\s|\.|$)", re.M
)


def test_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _BAD_IMPORT.search(src), path


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
