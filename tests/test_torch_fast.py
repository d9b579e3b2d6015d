"""The fast eval slice as a whole, against the JAX package: the banded
forward with precise=False, greedy dismantling in that mode, the scoped
matmul precision, the CLI's test-real and test-synthetic, and the
reference-checkpoint conversion.

Forward tolerance.  The two packages round the same values at the same
points (bf16(col ⊙ h), bf16(mirror sub), bf16 storage), and on the same h
the operator is bit-equal (tests/test_torch_band_bf16.py).  But h comes from
f32 dense layers that sum in another order in each package, and an element
within that f32 noise of a bf16 rounding boundary rounds to neighbouring
bf16 values on the two sides: one bf16 ulp, 2^-8 of an |h| <= 1.  Such flips
are rare and local, so almost every node agrees to f32 rounding (F32 of
max|Q|, for at least 99% of the live nodes) and the few touched by a flip
within two bf16 ulps of max|Q| (FLIP).  That is tighter than
tests/test_net_packed.py's 5e-2 bf16 tolerance.  The Pallas engine's four
modes are in tests/test_torch_fast_packed.py.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.env.host_env import make_host_env as jax_make_env  # noqa: E402
from mdcommunity_tpu.eval.metrics import dismantle_greedy_banded as jax_dismantle  # noqa: E402
from mdcommunity_tpu.eval.synthetic import evaluate_synthetic_sweep as jax_sweep  # noqa: E402
from mdcommunity_tpu.graphs.banded import apply_severs as jax_apply_severs  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.models import torch_convert as jax_convert  # noqa: E402
from mdcommunity_tpu.models.net import banded_test_forward as jax_forward  # noqa: E402
from mdcommunity_tpu.cli import _load_params as jax_load_params  # noqa: E402
from mdcommunity_tpu_torch import cli  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import make_host_env  # noqa: E402
from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy_banded  # noqa: E402
from mdcommunity_tpu_torch.eval.real import evaluate_real  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import apply_severs, build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges, write_edges  # noqa: E402
from mdcommunity_tpu_torch.models import torch_convert  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward, from_jax_params  # noqa: E402
from mdcommunity_tpu_torch.utils.device import matmul_precision  # noqa: E402

CKPT = "models_tpu/unit_cost_full_r1/best_model.ckpt"
F32 = 1e-5       # of max|Q|: f32 sums in another order
FLIP = 2 ** -7   # of max|Q|: two bf16 ulps, where a bf16 rounding flipped
N_GREEDY, SEED, GREEDY_STEPS = 1024, 1, 40


@pytest.fixture(scope="module")
def models():
    """Each package's own loader: the JAX CLI's and the port's."""
    return jax_load_params(CKPT), load_model(CKPT, device="cpu")


_JAX_FAST = jax.jit(lambda p, b, c: jax_forward(p, b, c, precise=False))


def _jax_fast(params, jb, covered):
    return np.asarray(_JAX_FAST(params, jb, jnp.asarray(covered)))


def assert_fast_q_close(q, ref, share=0.99):
    """Same -inf masks; every live node within FLIP of max|Q|, at least a
    `share` of them within F32.  Returns the max disagreement in units of
    max|Q|."""
    q, ref = np.asarray(q, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(q), fin)
    scale = np.abs(ref[fin]).max()
    err = np.abs(q[fin] - ref[fin]) / scale
    assert err.max() <= FLIP, err.max()
    assert np.mean(err <= F32) >= share, np.sort(err)[-20:]
    return err.max()


@pytest.mark.parametrize("covered_frac", [0.0, 0.2])
def test_fast_forward_matches_xla_engine(models, covered_frac):
    """n = 4,096 (the unfused forward is the XLA engine's counterpart)."""
    params, net = models
    n = 4096
    rng = np.random.default_rng(7)
    e0, e1 = synth_duplex_edges(n, 6, rng)
    jb, _, _ = jax_build(n, e0, e1)
    tb, _, _ = build_banded_duplex(n, e0, e1, device="cpu")
    covered = (rng.random(tb.pad_n) < covered_frac) | ~tb.node_mask.numpy()
    ref = _jax_fast(params, jb, covered)
    q = banded_test_forward(net, tb, torch.from_numpy(covered), precise=False)
    err = assert_fast_q_close(q, ref)
    print(f"fast forward vs XLA engine, n={n}: max err {err:.3e} of max|Q|")
    # and it is not the precise forward
    exact = banded_test_forward(net, tb, torch.from_numpy(covered))
    fin = torch.isfinite(exact)
    assert (q[fin] - exact[fin]).abs().max() > 1e-4 * exact[fin].abs().max()


def test_precise_forward_refuses_bf16_storage(models):
    _, net = models
    tb, _, _ = build_banded_duplex(512, *synth_duplex_edges(512, 6, np.random.default_rng(0)),
                                   device="cpu")
    with pytest.raises(ValueError, match="precise=True"):
        banded_test_forward(net, tb, ~tb.node_mask, act_dtype=torch.bfloat16)


def _q_after(models, edges, prefix, n):
    """Both engines' fast Q after removing `prefix` one by one, with the band
    edits each dismantling loop makes (the JAX loop pads sever lists)."""
    params, net = models
    e0, e1 = edges
    jb, _, (j0, j1) = jax_build(n, e0, e1)
    tb, _, _ = build_banded_duplex(n, e0, e1, device="cpu")
    env = make_host_env(n, j0, j1)
    jax_sever = jax.jit(jax_apply_severs, static_argnames=("layer",))

    def sever(layer, ns):
        nonlocal jb
        if not len(ns):
            return
        k = 8
        while k < len(ns):
            k *= 2
        s, d, v = np.zeros(k, np.int32), np.zeros(k, np.int32), np.zeros(k, bool)
        s[: len(ns)], d[: len(ns)], v[: len(ns)] = ns[:, 0], ns[:, 1], True
        jb = jax_sever(jb, layer, jnp.asarray(s), jnp.asarray(d), jnp.asarray(v))
        e = torch.from_numpy(ns)
        apply_severs(tb, layer, e[:, 0], e[:, 1], torch.ones(len(ns), dtype=torch.bool))

    for layer in range(2):
        sever(layer, env.edges[layer][env.sever[layer]])
    for a in prefix:
        _, new = env.step(int(a))
        for layer in range(2):
            sever(layer, new[layer])
    covered = np.pad(env.covered, (0, tb.pad_n - n), constant_values=True)
    qt = banded_test_forward(net, tb, torch.from_numpy(covered), precise=False).numpy()
    return _jax_fast(params, jb, covered), qt


def test_fast_greedy_matches_jax_up_to_a_near_tie(models):
    """StepRatio 0, GREEDY_STEPS removals, in both packages' fast mode (the
    JAX XLA engine, the port's unfused forward).  Removals are identical up to the
    first difference, and there both engines' forwards disagree by a
    rounding-level amount d (<= FLIP of max|Q|) and each engine's pick beats
    the other's by at most 2d (the most a disagreement of d can reverse)."""
    params, net = models
    n = N_GREEDY
    edges = synth_duplex_edges(n, 6, np.random.default_rng(SEED))
    jb, _, (j0, j1) = jax_build(n, *edges)
    jsol, jscore, _ = jax_dismantle(params, jb, jax_make_env(n, j0, j1), precise=False,
                                    max_steps=GREEDY_STEPS)
    tb, _, (t0, t1) = build_banded_duplex(n, *edges, device="cpu")
    stats = {}
    tsol, tscore, tcurve = dismantle_greedy_banded(
        net, tb, make_host_env(n, t0, t1), fuse_sage=False, precise=False,
        max_steps=GREEDY_STEPS, stats=stats)
    print(f"fast greedy n={n}: JAX AUDC {jscore:.6f} ({len(jsol)} removals), "
          f"port AUDC {tscore:.6f} ({len(tsol)} removals)")
    assert stats["precise"] is False and stats["act_dtype"] == "float32"
    assert len(tsol) == len(jsol) == GREEDY_STEPS and len(set(tsol)) == len(tsol)
    assert abs(tscore - float(np.sum(tcurve[1:]) / n)) <= 1e-9
    k = next((i for i, (a, b) in enumerate(zip(jsol, tsol)) if a != b), None)
    if k is None:
        assert tsol == jsol and abs(tscore - jscore) <= 1e-9
        return
    qj, qt = _q_after(models, edges, tsol[:k], n)
    fin = np.isfinite(qj)
    d = np.abs(qj[fin] - qt[fin]).max()
    a_j, a_t = jsol[k], tsol[k]
    print(f"first difference at removal {k}: JAX takes {a_j}, port {a_t}; "
          f"disagreement {d:.3e} (max|Q| {np.abs(qj[fin]).max():.3e}); gaps "
          f"{qj[a_j] - qj[a_t]:.3e} (JAX), {qt[a_t] - qt[a_j]:.3e} (port)")
    assert d <= FLIP * np.abs(qj[fin]).max()
    assert qj[a_j] == qj[fin].max() and qt[a_t] == qt[fin].max()
    assert qj[a_j] - qj[a_t] <= 2 * d and qt[a_t] - qt[a_j] <= 2 * d
    assert k >= 10  # an identical prefix first
    assert abs(tscore - jscore) < 0.05 * jscore


@pytest.mark.parametrize("precise", [True, False])
def test_matmul_precision_restores_the_flags(precise):
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    try:
        for start in ((True, False), (False, True)):
            mm.allow_tf32, cudnn.allow_tf32 = start
            with matmul_precision(precise):
                assert mm.allow_tf32 == cudnn.allow_tf32 == (not precise)
            assert (mm.allow_tf32, cudnn.allow_tf32) == start
            with pytest.raises(KeyError):
                with matmul_precision(precise):
                    raise KeyError("inside")
            assert (mm.allow_tf32, cudnn.allow_tf32) == start
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


def test_fast_dismantling_leaves_the_flags(models):
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    try:
        mm.allow_tf32, cudnn.allow_tf32 = False, True
        n = 512
        tb, _, (t0, t1) = build_banded_duplex(
            n, *synth_duplex_edges(n, 6, np.random.default_rng(3)), device="cpu")
        dismantle_greedy_banded(models[1], tb, make_host_env(n, t0, t1), step=16,
                                max_steps=64, precise=False)
        assert (mm.allow_tf32, cudnn.allow_tf32) == (False, True)
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


def test_cli_test_real_fast(models, tmp_path, capsys):
    """`cli test-real --cpu --fast --packed` on a 4,200-node synthetic
    .edges file (above the small-graph threshold, so the banded path) writes
    the reference's result files with the AUDC evaluate_real returns."""
    n, name = 4200, "synthetic_4200_multiplex.edges"
    write_edges(str(tmp_path / name), *synth_duplex_edges(n, 6, np.random.default_rng(5)))
    cli.main(["test-real", "--cpu", "--model", CKPT, "--data", str(tmp_path),
              "-o", str(tmp_path / "cli"), "--datasets", name, "--n-nodes", str(n),
              "--layers", "1", "2", "--step-ratio", "0.05", "--batch-env",
              "--packed", "--fast"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{name}: audc=")
    stats = {}
    sol, _, score = evaluate_real(models[1], str(tmp_path), name, str(tmp_path / "direct"),
                                  step_ratio=0.05, n_nodes=n, layers=(1, 2),
                                  batch_env=True, device="cpu", precise=False, stats=stats)
    assert stats["precise"] is False and stats["model_calls"] > 5
    assert float(line.split("audc=")[1].split()[0]) == pytest.approx(score, abs=1e-6)
    assert f"removed={len(sol)}" in line
    sub = tmp_path / "cli" / "StepRatio_0.0500"
    tag = "synthetic_4200_multiplex_12"
    assert (sub / f"Soluion_{tag}.txt").read_text().split() == [str(v) for v in sol]
    lmcc = (sub / f"NormalizedLMCC_{tag}.txt").read_text().split()
    assert abs(float(lmcc[-2]) - score) <= 1e-8
    row = (tmp_path / "cli" / "time&audc_real.csv").read_text().split()[-1].split(",")
    assert row[0] == name and float(row[2]) == pytest.approx(score, abs=1e-8)


def test_cli_test_synthetic_sweep_matches_jax(models, tmp_path, capsys):
    params, _ = models
    out = tmp_path / "rows.txt"
    cli.main(["--cpu", "test-synthetic", "--model", CKPT, "--sizes", "32",
              "--n-graphs", "3", "--sweep-param", "g", "--sweep-values", "0.1", "0.9",
              "-o", str(out)])
    rows = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    ref = jax_sweep(params, "g", [0.1, 0.9], size=32, n_graphs=3)
    assert [r["g"] for r in rows] == [0.1, 0.9] and len(out.read_text().splitlines()) == 2
    for r, j in zip(rows, ref):
        assert r["size"] == j["size"] == 32
        for key in ("score_mean", "score_std", "cost_mean"):
            assert r[key] == pytest.approx(j[key], rel=1e-5, abs=0), key


def test_torch_convert_round_trip(models, tmp_path):
    """The JAX package's params_to_state_dict (the reference's layout), read
    by the port's loader, gives the net from_jax_params gives: same Q; and
    the port writes the same state_dict back, an HCA net's too."""
    params, _ = models
    sd = jax_convert.params_to_state_dict(params)
    net = torch_convert.state_dict_to_net(sd, device="cpu")
    direct = from_jax_params(jax.tree_util.tree_map(np.array, params), device="cpu")
    path = str(tmp_path / "ref.ckpt")
    torch.save(sd, path)
    loaded = torch_convert.load_any_model(path, device="cpu")
    assert isinstance(torch_convert.load_any_model(CKPT, device="cpu"), type(direct))
    n = 512
    tb, _, _ = build_banded_duplex(n, *synth_duplex_edges(n, 6, np.random.default_rng(4)),
                                   device="cpu")
    q = banded_test_forward(direct, tb, ~tb.node_mask)
    for other in (net, loaded):
        for (k, x), (_, y) in zip(other.named_parameters(), direct.named_parameters()):
            assert torch.equal(x, y), k
        # equal values; the checkpoint's arrays keep their own strides, so the
        # matmuls may sum in another order
        torch.testing.assert_close(banded_test_forward(other, tb, ~tb.node_mask), q,
                                   rtol=0, atol=1e-5)
    back = torch_convert.net_to_state_dict(net)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # an HCA net's reference state_dict (w_n2l [3, 64] and the three heads):
    # read into an HcaQNet, written back the same; the JAX package's
    # converter reads the same arrays from it
    from mdcommunity_tpu_torch.models.checkpoint import load_params
    from mdcommunity_tpu_torch.models.hca import HCA_HEADS, HcaQNet

    hca_params = load_params("models_tpu/hca_100k_r5/best_model.ckpt")
    sd_hca = torch_convert.params_to_state_dict(hca_params)
    assert set(sd_hca) == set(sd) | set(HCA_HEADS)
    hca_net = torch_convert.state_dict_to_net(sd_hca, device="cpu")
    assert isinstance(hca_net, HcaQNet) and hca_net.w_n2l.shape == (3, 64)
    back = torch_convert.net_to_state_dict(hca_net)
    assert set(back) == set(sd_hca)
    for k in sd_hca:
        assert torch.equal(back[k], sd_hca[k]), k
    jax_hca = jax_convert.state_dict_to_params(sd_hca)
    for k in HCA_HEADS + ("w_n2l", "p_node_conv"):
        np.testing.assert_array_equal(np.asarray(jax_hca[k]), hca_params[k])
    assert os.path.getsize(path) > 0
