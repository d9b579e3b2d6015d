"""The port's large-graph HCA forward (models/hca_banded.banded_hca_forward,
the kernels' plain CPU versions) against the benchmark's float64 plain
reference (mdbench/reference_hca.py) at 4,096 nodes of the benchmark's
generator, intact and after two batches of removals, with seeded random
weights and with the committed checkpoint; the reference's own judgement
of the program (reference_hca.gaps) in the same place.

Tolerance: Q over the nodes both layers select is held to 2e-5 of its
max |Q|.  The forward runs in f32 against float64: about ten dependent
D = 64 products and normalisations a path, each rounding to 2^-24, give
~1e-6 (read here: under 1e-6); 2e-5 leaves twenty times that, while a
forward whose dense products round their operands to TF32's 10-bit
mantissa, or whose band products run K1's bf16 mode (precise=False), errs
by 1e-4 to 1e-2 and fails it (both are tested).  Unselected nodes sit at
-1e9·w (w the gate weight); they are held to 2e-5 relative, and the
selection itself exactly (no near-tie excused at these seeds)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from mdbench import common, gen, reference as ref, reference_hca
from mdcommunity_tpu_torch.env.host_env import make_host_env
from mdcommunity_tpu_torch.eval.metrics import top_k_stable
from mdcommunity_tpu_torch.graphs.banded import apply_severs, build_banded_duplex
from mdcommunity_tpu_torch.graphs.hca import hca_communities_and_features
from mdcommunity_tpu_torch.models.checkpoint import load_model
from mdcommunity_tpu_torch.models.hca import HcaQNet, init_hca_params
from mdcommunity_tpu_torch.models.hca_banded import banded_hca_forward, make_hca_band_data
from torch_one_thread import one_torch_thread  # noqa: F401

N = 4096
K = 41               # a batch: 1% of the nodes
TOL = 2e-5
CKPT = "models_tpu/hca_full_r1/best_model.ckpt"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv, np.float64) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v, np.float64)
    return out


@pytest.fixture(scope="module")
def graph():
    (e0, e1), _ = gen.make_inputs({"avg_deg": 6, "graph_seed": 21, "shuffle": False},
                                  {"node_cost": "unit"}, 2200000005, N)
    comm_id, n_comms, feat = hca_communities_and_features(N, e0, e1)
    return (e0, e1), comm_id, n_comms, feat


def _states(net, graph, precise=True):
    """The program's Q and the reference's judgement at the intact state and
    after each of two batches of its own top-K removals (the env's
    cascades, their severs applied to the band): [(Gaps, Out, Q in
    original ids)]."""
    (e0, e1), comm_id, n_comms, feat = graph
    banded, perm, ordered = build_banded_duplex(N, e0, e1, device="cpu")
    perm = np.asarray(perm, np.int64)
    hd = make_hca_band_data(comm_id, n_comms, feat, perm, banded.pad_n, device="cpu")
    env = make_host_env(N, ordered[0], ordered[1], engine="native")
    ctx = common.Ctx(root=ROOT, cell={}, config={"name": "hca"}, traffic={}, seed=0,
                     seconds=0.0, trace=False, device=torch.device("cpu"), n=N, t_process=0.0)
    setup = common.Setup((e0, e1), None, None, perm, None, ordered, None, CKPT)
    judge = common.Judge(ctx, setup, [np.array(e) for e in env.edges])
    href = reference_hca.HcaReference(N, (e0, e1), comm_id, net.ref_params, judge.cfg_ref,
                                      torch.device("cpu"))

    def sever(pairs):
        for layer in range(2):
            e = torch.from_numpy(np.asarray(pairs[layer], np.int64).reshape(-1, 2))
            if len(e):
                apply_severs(banded, layer, e[:, 0], e[:, 1], torch.ones(len(e), dtype=torch.bool))

    sever([env.edges[layer][env.sever[layer]] for layer in range(2)])
    covered = torch.from_numpy(np.pad(env.covered, (0, banded.pad_n - N), constant_values=True))
    out = []
    for batch in range(3):
        q = banded_hca_forward(net, banded, hd, covered, precise=precise)
        _, acts = top_k_stable(q, K)
        state, bad = judge.to_ref(common.read_state(env))
        assert bad == 0
        qp = torch.empty(N, dtype=torch.float64)
        qp[torch.from_numpy(perm)] = q[:N].double()
        o = href.forward(state)
        g = reference_hca.gaps(o, href.cid, qp, torch.from_numpy(perm[acts]), K, 0.0)
        out.append((g, o, href.cid, qp))
        if batch < 2:
            _, new_sev, _ = env.step_many(acts)
            covered[torch.from_numpy(acts.astype(np.int64))] = True
            sever(new_sev)
    return out


def _net(which):
    if which == "checkpoint":
        net = load_model(CKPT, device="cpu")
        net.ref_params = ref.read_params(CKPT)
    else:
        params = init_hca_params(torch.Generator().manual_seed(0))
        net = HcaQNet(params)
        net.ref_params = _flat(params)
    assert isinstance(net, HcaQNet)
    return net


@pytest.mark.parametrize("which", ["seeded", "checkpoint"])
def test_forward_against_the_plain_reference(graph, which):
    for g, o, cid, qp in _states(_net(which), graph):
        assert g.sel_gap == 0 and g.excused == 0 and g.both > 0
        assert g.q_err <= TOL, g
        assert g.pick_gap == 0.0, g
        q_ref = o.q(cid)
        low = torch.isfinite(q_ref) & (q_ref < -1e8)
        assert bool(low.any())
        torch.testing.assert_close(qp[low], q_ref[low], rtol=2e-5, atol=0)


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Products(TorchFunctionMode):
    """Every float32 matrix product with its operands rounded to TF32's
    10-bit mantissa (what the card's TF32 dense layers read)."""

    PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul, torch.mm,
                torch.Tensor.mm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS and all(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                                         for a in args[:2]):
            args = (_tf32(args[0]), _tf32(args[1])) + tuple(args[2:])
        return func(*args, **kwargs)


@pytest.mark.parametrize("mode", ["tf32", "bf16_band"])
def test_lower_precision_fails_the_tolerance(graph, mode):
    net = _net("checkpoint")
    if mode == "tf32":
        with _Tf32Products():
            res = _states(net, graph)
    else:
        res = _states(net, graph, precise=False)
    worst = max(g.q_err for g, *_ in res)
    assert worst > TOL, worst


def test_c_pad_too_small_raises(graph):
    (e0, e1), comm_id, n_comms, feat = graph
    banded, perm, _ = build_banded_duplex(N, e0, e1, device="cpu")
    with pytest.raises(ValueError, match="c_pad"):
        make_hca_band_data(comm_id, n_comms, feat, perm, banded.pad_n, c_pad=8, device="cpu")
    hd = make_hca_band_data(comm_id, n_comms, feat, perm, banded.pad_n, device="cpu")
    assert hd.c_pad >= int(n_comms.max()) and int(hd.comm_id.max()) < hd.c_pad


def test_rehearsal_of_the_cell_is_correct():
    """python -m mdbench.run --workload hca.dismantle_banded_1m --rehearse 4096."""
    args = ["--workload", "hca.dismantle_banded_1m", "--seed", "2200000031", "--seconds", "4",
            "--trace", "0", "--rehearse", str(N)]
    p = subprocess.run([sys.executable, "-m", "mdbench.run", *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == {"start_gap", "cascade_gap", "sel_gap", "q_err", "pick_gap"}
    assert set(res["metrics"]) == {"removals_per_s", "setup_s"}
