"""HCA's community pass (ops/hca_kernels.comm_adj) against its K1 form.

The pass writes (Mᵀ A_live M > 0) with the diagonal set to the real
communities straight from the stored edges; models/hca_banded.community_graph
computes the counts Mᵀ(A_live M) by K1 on the one-hot membership and is kept
as its check.  Each case holds the plain version to
(community_graph(...) > 0) · (1 − I) + I · real exactly, on both layers, at
c_pad = 512 (two K1 chunks): a fresh band; a band after severs that remove
every edge between one pair of communities (that entry drops to 0) and a
few more, with covered nodes; a nibble base; a shuffled build whose layers
have mirror overflow and spill edges; narrow bands (S 40, B 8: int8 and
nibble rows whose pitch is no multiple of 16 bytes, so the kernel reads them
in 4-byte words, where the other builds take 16-byte words).  The CUDA cases
hold the kernel to the plain version bit for bit and to a relaunch; they
skip without a card.  This file imports no JAX; on a card without JAX:

    python -m pytest --noconftest tests/test_torch_hca_comm.py -q -k cuda
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

from mdcommunity_tpu_torch.graphs.banded import (
    BandedDuplex,
    apply_severs,
    build_banded_duplex,
)
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
from mdcommunity_tpu_torch.models.hca_banded import community_graph, make_hca_band_data
from mdcommunity_tpu_torch.ops import hca_kernels
from mdcommunity_tpu_torch.ops.dense_band import build_dense_band

N = 1500
C_PAD = 512
N_COMMS = (300, 280)  # communities a layer: arcs of the generator's angular ids
CASES = ("fresh", "severed", "nibble", "spill", "narrow", "narrow_nibble")
NARROW = dict(S=40, B=8)  # pitch 56 int8, 28 nibble bytes: 4-byte words on the card
cuda = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")


def _edges(shuffle, simple=False):
    e0, e1 = synth_duplex_edges(N, 6, np.random.default_rng(3), shuffle=shuffle)
    if simple:  # each undirected edge once: a nibble holds at most 7
        e0, e1 = (np.unique(np.sort(e, axis=1), axis=0) for e in (e0, e1))
    return e0, e1


def _spill_build(e0, e1, device):
    """Both layers in the given ids (no reordering), at most 8 mirror slots
    a block: shuffled ids put most edges out of band, so the layers have
    mirror overflow and spill."""
    dbgs = [build_dense_band(np.r_[e[:, 0], e[:, 1]], np.r_[e[:, 1], e[:, 0]], N, S=64, B=32,
                             max_mirror=8, device=device) for e in (e0, e1)]
    mask = torch.zeros(dbgs[0].pad_n, dtype=torch.bool, device=device)
    mask[:N] = True
    rows = torch.ones(2, dbgs[0].pad_n, device=device)
    return BandedDuplex(dbgs[0], dbgs[1], mask, N, (len(e0), len(e1)), 0, rows,
                        torch.zeros_like(rows)), np.arange(N)


def _case(name, device):
    """(banded, HcaBandData at c_pad 512, live bool [pad_n], the severed
    pair of layer 0's communities or None) on `device`."""
    nibble = name in ("nibble", "narrow_nibble")
    e0, e1 = _edges(shuffle=name == "spill", simple=nibble)
    if name == "spill":
        bdx, perm = _spill_build(e0, e1, device)
    else:
        shape = NARROW if name.startswith("narrow") else dict(S=64, B=32)
        bdx, perm, _ = build_banded_duplex(N, e0, e1, **shape, max_rank=0, device=device,
                                           nibble=nibble)
    # the arcs are of the generator's ids (before a shuffle): communities
    # then hold most of their edges, as Louvain's do
    ids = np.arange(N) if name != "spill" else np.argsort(
        np.random.default_rng(3).permutation(N))
    comm = np.stack([(ids * k) // N for k in N_COMMS])
    hd = make_hca_band_data(comm, np.array(N_COMMS), np.zeros((N, 3), np.float32), perm,
                            bdx.pad_n, c_pad=C_PAD, device=device)
    rng = np.random.default_rng(7)
    covered = np.zeros(bdx.pad_n, bool)
    covered[N:] = True
    if name in ("severed", "spill"):
        covered[rng.choice(N, N // 10, replace=False)] = True
    pair = None
    if name == "severed":
        inv = np.empty(N, np.int64)
        inv[perm] = np.arange(N)
        s, d = inv[e0[:, 0]], inv[e0[:, 1]]
        cid = hd.comm_id[0].cpu().numpy()
        live = ~covered
        cross = np.flatnonzero((cid[s] != cid[d]) & live[s] & live[d])
        pair = (int(cid[d[cross[0]]]), int(cid[s[cross[0]]]))
        between = (np.minimum(cid[s], cid[d]) == min(pair)) & (
            np.maximum(cid[s], cid[d]) == max(pair))
        cut = np.union1d(np.flatnonzero(between), rng.choice(len(e0), 20, replace=False))
        apply_severs(bdx, 0, torch.from_numpy(s[cut]).to(device),
                     torch.from_numpy(d[cut]).to(device),
                     torch.ones(len(cut), dtype=torch.bool, device=device))
    return bdx, hd, torch.from_numpy(~covered).to(device), pair


def _k1_form(bdx, hd, layer, live):
    a = (community_graph(bdx, hd, layer, live.float()) > 0).float()
    eye = torch.eye(hd.c_pad)
    real = (torch.arange(hd.c_pad) < hd.n_comms[layer]).float()
    return a * (1.0 - eye) + eye * real[:, None]


@pytest.mark.parametrize("name", CASES)
def test_comm_adj_plain_equals_k1_form(name):
    """The plain pass equals the K1 form exactly on both layers; the
    severed pair reads 0 after the severs and 1 before them."""
    bdx, hd, live, pair = _case(name, "cpu")
    if name == "spill":
        for layer in range(2):
            d = bdx.dbg(layer)
            assert d.C > 0 and d.ccoo.nnz > 0 and d.spill.nnz > 0
    if name in ("nibble", "narrow_nibble"):
        assert bdx.dbg0.nibble
    if name.startswith("narrow"):
        d = bdx.dbg0
        assert d.S == NARROW["S"] and (d.W2 // (2 if d.nibble else 1)) % 16 != 0
    for layer in range(2):
        got = hca_kernels.comm_adj(bdx.dbg(layer), hd.comm_id[layer], live,
                                   hd.n_comms[layer], hd.c_pad)
        ref = _k1_form(bdx, hd, layer, live)
        assert got.dtype == torch.float32 and got.shape == (C_PAD, C_PAD)
        assert torch.equal(got, ref)
        off = got * (1.0 - torch.eye(C_PAD))
        assert 0 < int(off.sum()) < hd.n_comms[layer] ** 2
    if pair is not None:  # layer 0's pair, with and without the severs
        c, c2 = pair
        a0 = hca_kernels.comm_adj(bdx.dbg0, hd.comm_id[0], live, hd.n_comms[0], C_PAD)
        assert float(a0[c, c2]) == 0.0 and float(a0[c2, c]) == 0.0
        fresh, fhd = _case("fresh", "cpu")[:2]
        b0 = hca_kernels.comm_adj(fresh.dbg0, fhd.comm_id[0], live, fhd.n_comms[0], C_PAD)
        assert float(b0[c, c2]) == 1.0 and float(b0[c2, c]) == 1.0


def test_comm_adj_dtype_and_refusals():
    """The table follows the forward's dtype (f64 here, bit-equal to f32's
    values); the wrapper refuses a float live mask or int32 community ids."""
    bdx, hd, live, _ = _case("fresh", "cpu")
    a32 = hca_kernels.comm_adj(bdx.dbg0, hd.comm_id[0], live, hd.n_comms[0], C_PAD)
    a64 = hca_kernels.comm_adj(bdx.dbg0, hd.comm_id[0], live, hd.n_comms[0], C_PAD,
                               torch.float64)
    assert a64.dtype == torch.float64 and torch.equal(a64.float(), a32)
    with pytest.raises(ValueError):
        hca_kernels.comm_adj(bdx.dbg0, hd.comm_id[0], live.float(), hd.n_comms[0], C_PAD)
    with pytest.raises(ValueError):
        hca_kernels.comm_adj(bdx.dbg0, hd.comm_id[0].int(), live, hd.n_comms[0], C_PAD)


@cuda
@pytest.mark.parametrize("name", CASES)
def test_comm_adj_cuda_equals_plain(name):
    """The CUDA kernel on the card equals the plain version on the same
    build bit for bit, and a relaunch gives the same table."""
    bdx, hd, live, _ = _case(name, torch.device("cuda"))
    cpu_bdx, cpu_hd, cpu_live, _ = _case(name, "cpu")
    before = hca_kernels.launches["hca_comm_adj"]
    for layer in range(2):
        args = (hd.comm_id[layer], live, hd.n_comms[layer], hd.c_pad)
        got = hca_kernels.comm_adj(bdx.dbg(layer), *args)
        again = hca_kernels.comm_adj(bdx.dbg(layer), *args)
        ref = hca_kernels.comm_adj_plain(cpu_bdx.dbg(layer), cpu_hd.comm_id[layer], cpu_live,
                                         cpu_hd.n_comms[layer], cpu_hd.c_pad)
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), ref)
    assert hca_kernels.launches["hca_comm_adj"] - before == 4
