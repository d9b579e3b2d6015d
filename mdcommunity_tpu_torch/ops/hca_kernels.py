"""HCA-Dismantler's community-graph pass: CUDA wrapper, plain version, counter.

comm_adj(dbg, cid, live, n_real, c_pad, dtype) gives one layer's binarised
live community graph with self loops, the table models/hca.hca_head
multiplies the community rows by:

  out[c, c'] = 1   some edge stored in dbg with a nonzero weight joins a live
                   node of community c (destination) and a live node of
                   community c' != c (source)
  out[c, c]  = 1   for c < n_real, else 0

over the storage that K1 reads and that ops/dense_band.sever_edges edits in
place (the band cells, the mirror COO through mirror_node, the spill COO),
so a sever or restore_banded shows in the next pass.  Weights are edge
multiplicities (never negative), so it equals the K1 form
models/hca_banded.community_graph's (counts > 0) · (1 − I) + I · real bit for
bit.  csrc/hca.cu holds the kernel and says what bounds it.

On a CPU tensor it runs its plain PyTorch version (any float dtype); on a
CUDA tensor it launches the kernel (float32, as K1; built with nvcc for
sm_90a at first use into the package's _build/) or raises, and adds one to
launches["hca_comm_adj"].
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from mdcommunity_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, build_library
from mdcommunity_tpu_torch.ops.dense_band import DenseBandGraph, band_rows

SRC = os.path.join(CSRC, "hca.cu")
LIB = os.path.join(BUILD_DIR, "libmdc_hca.so")

# passes launched on CUDA tensors (one a layer a forward)
launches = {"hca_comm_adj": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(force: bool = False) -> str:
    """Compile csrc/hca.cu for sm_90a if the library is missing or older than
    the source; returns the library path."""
    return build_library(SRC, LIB, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mdc_hca_comm_adj.restype = i
        lib.mdc_hca_comm_adj.argtypes = ([p] + [i] * 5 + [p] * 4 + [ll] + [p] * 3 + [ll]
                                         + [p] * 3 + [i] * 2 + [p])
        _lib = lib
    return _lib


def comm_edges(dbg: DenseBandGraph):
    """(dst, src, weight) of every edge stored in dbg: the band cells (the
    base's S band rows, a nibble base unpacked), the mirror COO's edges
    through mirror_node, the spill COO's; int64 node ids."""
    S, B, pad_n = dbg.S, dbg.B, dbg.pad_n
    band = band_rows(dbg)
    blk, r, lc = torch.nonzero(band, as_tuple=True)
    dst = [blk * S + r, dbg.mirror_node.reshape(-1)[dbg.ccoo.d_dst], dbg.spill.d_dst]
    src = [torch.remainder(blk * S - B + lc, pad_n),
           dbg.mirror_node.reshape(-1)[dbg.ccoo.d_src], dbg.spill.d_src]
    w = [band[blk, r, lc].to(torch.float32), dbg.w_cov, dbg.w_spill]
    return torch.cat(dst), torch.cat(src), torch.cat(w)


def comm_adj_plain(dbg: DenseBandGraph, cid: torch.Tensor, live: torch.Tensor, n_real: int,
                   c_pad: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    dst, src, w = comm_edges(dbg)
    keep = (w != 0) & live[dst] & live[src] & (cid[dst] != cid[src])
    out = torch.zeros((c_pad, c_pad), dtype=dtype, device=live.device)
    out[cid[dst[keep]], cid[src[keep]]] = 1
    out.diagonal().copy_(torch.arange(c_pad, device=live.device) < n_real)
    return out


def comm_adj(dbg: DenseBandGraph, cid: torch.Tensor, live: torch.Tensor, n_real: int,
             c_pad: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One layer's community table [c_pad, c_pad] in `dtype` (the module
    docstring): cid int64 [pad_n], each node's community in [0, c_pad);
    live bool [pad_n]; n_real the real communities."""
    if cid.dtype != torch.int64 or live.dtype != torch.bool:
        raise ValueError(f"comm_adj takes int64 cid and bool live, got {cid.dtype}, "
                         f"{live.dtype}")
    if tuple(cid.shape) != (dbg.pad_n,) or tuple(live.shape) != (dbg.pad_n,):
        raise ValueError(f"cid and live must be [pad_n={dbg.pad_n}], got "
                         f"{tuple(cid.shape)}, {tuple(live.shape)}")
    dev = live.device
    if dev.type == "cpu":
        return comm_adj_plain(dbg, cid, live, n_real, c_pad, dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dtype != torch.float32:  # as K1, which runs the forward's pooling
        raise ValueError(f"the community kernel writes float32, not {dtype}")
    want = [("base", dbg.base, torch.int8), ("mirror_node", dbg.mirror_node, torch.int64),
            ("ccoo.d_src", dbg.ccoo.d_src, torch.int64),
            ("ccoo.d_dst", dbg.ccoo.d_dst, torch.int64), ("w_cov", dbg.w_cov, torch.float32),
            ("spill.d_src", dbg.spill.d_src, torch.int64),
            ("spill.d_dst", dbg.spill.d_dst, torch.int64),
            ("w_spill", dbg.w_spill, torch.float32), ("cid", cid, torch.int64),
            ("live", live, torch.bool)]
    for name, t, dt in want:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: the community kernel takes a contiguous {dt} tensor "
                             f"on {dev}, got {t.dtype} on {t.device}")
    out = torch.empty((c_pad, c_pad), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _load().mdc_hca_comm_adj(
            dbg.base.data_ptr(), dbg.n_blocks, dbg.S, dbg.B, dbg.C, int(dbg.nibble),
            dbg.mirror_node.data_ptr(), dbg.ccoo.d_src.data_ptr(), dbg.ccoo.d_dst.data_ptr(),
            dbg.w_cov.data_ptr(), dbg.ccoo.nnz, dbg.spill.d_src.data_ptr(),
            dbg.spill.d_dst.data_ptr(), dbg.w_spill.data_ptr(), dbg.spill.nnz,
            cid.data_ptr(), live.data_ptr(), out.data_ptr(), c_pad, int(n_real),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the community kernel failed to launch with CUDA error {rc}")
    launches["hca_comm_adj"] += 1
    return out
