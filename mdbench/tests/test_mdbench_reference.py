"""The plain reference against the port's plain CPU path at a small size:
the same Q, loss and gradient in float64, the f32 path inside the cells'
limits, the bf16 path (precise=False) outside them, and the cascade equal
to the native host env's."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from mdbench import common, gen, reference as ref
from mdbench.manifest import Manifest

N = 4096


def _limits(root, cell):
    with open(os.path.join(root, "mdbench", "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def _setup(root, name, shuffle, seed=7):
    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.graphs.banded import apply_severs, build_banded_duplex

    cfg = {"node_cost": "degree" if name == "degree_cost" else "unit"}
    (e0, e1), w = gen.make_inputs({"avg_deg": 6, "graph_seed": 11, "shuffle": shuffle}, cfg, seed, N)
    banded, perm, ordered = build_banded_duplex(N, e0, e1, device="cpu", weights=w)
    env = make_host_env(N, ordered[0], ordered[1], engine="native",
                        weights=None if w is None else w[:, perm].astype(np.float64))

    def sever(pairs):
        for layer in range(2):
            e = torch.from_numpy(np.asarray(pairs[layer], np.int64).reshape(-1, 2))
            if len(e):
                apply_severs(banded, layer, e[:, 0], e[:, 1], torch.ones(len(e), dtype=torch.bool))

    sever([env.edges[layer][env.sever[layer]] for layer in range(2)])
    rng = np.random.default_rng(seed)
    _, new, _ = env.step_many(rng.choice(N, 300, replace=False))
    sever(new)
    covered = torch.from_numpy(np.pad(env.covered, (0, banded.pad_n - N), constant_values=True))
    state = ref.intact_state(N, (e0, e1))
    for layer, L in enumerate(state.layers):
        idx = np.searchsorted(L.keys, ref.pair_keys(perm[env.edges[layer]]))
        cnt = np.zeros(len(L.u))
        np.add.at(cnt, idx, env.sever[layer])
        L.sev = cnt > 0
    state.covered[perm] = env.covered
    ckpt = common.checkpoint(root, Manifest.load(root).config(name))
    return dict(banded=banded, perm=perm, env=env, covered=covered, state=state, w=w,
                edges=(e0, e1), ckpt=ckpt, rng=rng)


def _q_err(qb, qr, perm):
    qp = torch.empty(N, dtype=torch.float64)
    qp[torch.from_numpy(perm)] = qb[:N].double()
    act = torch.isfinite(qr)
    assert torch.equal(act, torch.isfinite(qp))
    return float((qp[act] - qr[act]).abs().max() / qr[act].abs().max())


@pytest.mark.parametrize("name,shuffle,cell", [
    ("unit_cost", True, "unit_cost.train_1m"),
    ("degree_cost", False, "degree_cost.dismantle_banded_1m")])
def test_q_against_port(root, name, shuffle, cell):
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward

    s = _setup(root, name, shuffle)
    inp = ref.inputs(s["state"], [len(e) for e in s["edges"]], s["w"],
                     ref.config_reference(name), "cpu")
    qr = ref.q_values(ref.tensors(ref.read_params(s["ckpt"]), "cpu"), inp)
    net = load_model(s["ckpt"], device="cpu")
    fuse = s["banded"].spill_free
    kw = dict(fuse_sage=fuse, variant=name)
    q64 = banded_test_forward(copy.deepcopy(net).double(), s["banded"], s["covered"],
                              variant=name)
    q32 = banded_test_forward(net, s["banded"], s["covered"], **kw)
    qbf = banded_test_forward(net, s["banded"], s["covered"], precise=False, **kw)
    lim = _limits(root, cell)["q_err"]
    assert _q_err(q64, qr, s["perm"]) < 1e-12
    assert _q_err(q32, qr, s["perm"]) < lim
    assert _q_err(qbf, qr, s["perm"]) > lim


@pytest.mark.parametrize("name,shuffle", [("unit_cost", True), ("degree_cost", False)])
def test_loss_and_gradient_against_port(root, name, shuffle):
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_train_loss

    s = _setup(root, name, shuffle)
    env, rng = s["env"], s["rng"]
    alive = np.flatnonzero(env.alive_nodes(0) & env.alive_nodes(1) & ~env.covered)
    acts = rng.choice(alive, 16, replace=False)
    targets = rng.normal(size=16) * 0.01 - 0.05
    net = copy.deepcopy(load_model(s["ckpt"], device="cpu")).double().requires_grad_(True)
    lp = banded_train_loss(net, s["banded"], s["covered"], torch.from_numpy(acts),
                           torch.tensor(targets), alpha=1e-3, remat=False, variant=name)
    lp.backward()
    inp = ref.inputs(s["state"], [len(e) for e in s["edges"]], s["w"],
                     ref.config_reference(name), "cpu")
    p = ref.tensors(ref.read_params(s["ckpt"]), "cpu", grad=True)
    lr = ref.loss(p, inp, torch.from_numpy(s["perm"][acts]), torch.tensor(targets), 1e-3)
    lr.backward()
    assert abs(float(lp.detach()) - float(lr.detach())) < 1e-12 * abs(float(lr.detach()))
    for k, x in net.named_parameters():
        assert torch.allclose(x.grad, p[k].grad, rtol=1e-9, atol=1e-15), k


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, generator=g, dtype=torch.float64)
    mine, adam = {"x": x.clone()}, ref.Adam(1e-3)
    t = x.clone().requires_grad_(True)
    opt = torch.optim.Adam([t], lr=1e-3)
    for _ in range(3):
        grad = torch.randn(5, 3, generator=g, dtype=torch.float64)
        t.grad = grad.clone()
        opt.step()
        mine = adam.step(mine, {"x": grad})
    assert torch.allclose(mine["x"], t.detach(), rtol=0, atol=1e-15)


@pytest.mark.parametrize("shuffle", [True, False])
def test_cascade_against_native_env(root, shuffle):
    from mdcommunity_tpu_torch.env.host_env import make_host_env

    (e0, e1), _ = gen.make_inputs({"avg_deg": 6, "graph_seed": 11, "shuffle": shuffle}, {"node_cost": "unit"}, 3, N)
    env = make_host_env(N, e0, e1, engine="native")
    mine = ref.cascade(ref.intact_state(N, (e0, e1)))
    rng = np.random.default_rng(4)
    for batch in range(6):
        def theirs():
            st = ref.intact_state(N, (e0, e1))
            for layer, L in enumerate(st.layers):
                idx = np.searchsorted(L.keys, ref.pair_keys(env.edges[layer]))
                cnt = np.zeros(len(L.u))
                np.add.at(cnt, idx, env.sever[layer])
                L.sev = cnt > 0
            st.covered[:] = env.covered
            st.rank = env.rank
            return st
        assert ref.state_gap(mine, theirs()) == 0, batch
        acts = rng.choice(np.flatnonzero(~env.covered), 200, replace=False)
        env.step_many(acts)
        mine = ref.cascade(mine, acts)
