"""Blocked-pair SpMM (K4) and SDDMM (K5): layout, CUDA wrappers, plain
versions, counters, and the differentiable BlockSpmm.

The layout is the JAX package's (ops/pallas_spmm.py): nodes in blocks of S
rows; an edge (u -> v) belongs to the block pair (v//S, u//S); edges are
stored pair-major in chunks of T slots, and this pair-slot order is the
graph's own edge order (graphs/blocked.py), so the live-edge weights arrive
laid out as w [P, T], with w = 0 on padding slots.

K4 `spmm_block`   out = A @ h                              (kernel mdc_spmm_block)
K5 `sddmm_block`  dw[p, t] = h[src row of (p, t)] · g[dst row of (p, t)]
                                                           (kernel mdc_sddmm_block)

They replace the JAX package's Pallas TPU kernels _spmm_kernel and
_sddmm_kernel; the CUDA sources are in csrc/blocked.cu, which also says what
bounds them on an H100.  The port adds to BlockCOO the per-destination-row
lists of real slots (row_ptr, row_slot) that K4 walks, built once on the host.

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA tensor it
launches its kernel or raises.  Nothing falls back.  The kernels build with
nvcc for sm_90a at first use into the package's _build/ directory.  Each
launch adds one to `launches[name]`: spmm_block for K4 in a forward,
spmm_block_bwd for K4 in BlockSpmm's backward, sddmm_block for K5.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, build_library
from mdcommunity_tpu_torch.utils.device import resolve_device

SRC = os.path.join(CSRC, "blocked.cu")
LIB = os.path.join(BUILD_DIR, "libmdc_blocked.so")

launches = {"spmm_block": 0, "spmm_block_bwd": 0, "sddmm_block": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(force: bool = False) -> str:
    """Compile csrc/blocked.cu for sm_90a if the library is missing or older
    than the source; returns the library path (ptxas report in
    _build/blocked_ptxas.log)."""
    return build_library(SRC, LIB, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mdc_spmm_block.restype = i
        lib.mdc_spmm_block.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.mdc_sddmm_block.restype = i
        lib.mdc_sddmm_block.argtypes = [p] * 7 + [ctypes.c_longlong] + [i] * 3 + [p]
        _lib = lib
    return _lib


# ---------------------------------------------------------------- layout


@dataclasses.dataclass(frozen=True)
class BlockCOO:
    """Pair-major blocked COO (destination-major), tensors on one device.

    rowptr   : int32[n_blocks+1]   pair range per destination block
    src_blk  : int32[P]            source block of each pair chunk
    dst_blk  : int32[P]            destination block of each pair chunk
    lsrc     : int32[P, T]         local source row within the source block
    ldst     : int32[P, T]         local destination row within the dest block
    row_ptr  : int32[n_blocks·S+1] range of each destination row in row_slot
    row_slot : int32[E]            slot ids p·T + t of the real edges, by
                                   destination row, then slot
    Padding slots carry lsrc = ldst = 0 and must have w = 0; pairs past
    rowptr[-1] are padding (P is padded to a multiple of 8, as the JAX
    package pads it).
    """

    rowptr: torch.Tensor
    src_blk: torch.Tensor
    dst_blk: torch.Tensor
    lsrc: torch.Tensor
    ldst: torch.Tensor
    row_ptr: torch.Tensor
    row_slot: torch.Tensor
    n_nodes: int
    S: int
    T: int

    @property
    def n_blocks(self) -> int:
        return (self.n_nodes + self.S - 1) // self.S

    @property
    def n_rows(self) -> int:
        return self.n_blocks * self.S

    @property
    def n_pairs(self) -> int:
        return self.src_blk.shape[0]

    @property
    def n_slots(self) -> int:
        return self.n_pairs * self.T

    @property
    def device(self) -> torch.device:
        return self.lsrc.device


def build_block_coo(
    src: np.ndarray, dst: np.ndarray, n: int, S: int = 512, T: int = 1024,
    device=None,
) -> Tuple[BlockCOO, np.ndarray, np.ndarray, np.ndarray]:
    """Blocked layout for directed edges, on `device` (CUDA unless named).

    Returns (bcoo, slot_src, slot_dst, slot_mask): the edge arrays in
    pair-slot order ([P·T] numpy arrays each), the JAX package's.  Callers
    keep all per-edge state in this order; the kernels' w is reshape(P, T)."""
    device = resolve_device(device)
    if S < 1 or T < 1:
        raise ValueError(f"S={S} and T={T} must be positive")
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n_blocks = (n + S - 1) // S
    key = (dst // S) * n_blocks + (src // S)
    order = np.argsort(key, kind="stable")
    src, dst, key = src[order], dst[order], key[order]
    E = len(src)

    # position of each edge within its block pair, the chunk of T it lands
    # in, and that chunk's global pair index
    uniq, first, counts = np.unique(key, return_index=True, return_counts=True)
    inv = np.repeat(np.arange(len(uniq)), counts)          # edge -> unique-pair id
    pos = np.arange(E) - first[inv]                        # rank within pair
    chunks_per_pair = (counts + T - 1) // T
    chunk_base = np.concatenate([[0], np.cumsum(chunks_per_pair)])
    pair_id = chunk_base[inv] + pos // T                   # edge -> pair chunk
    slot = (pos % T).astype(np.int64)
    n_pairs = int(chunk_base[-1])
    P = n_pairs + (-n_pairs) % 8

    pair_key = np.zeros(P, np.int64)
    pair_key[:n_pairs] = np.repeat(uniq, chunks_per_pair)
    pair_dstblk = pair_key // n_blocks
    pair_srcblk = pair_key % n_blocks
    pair_dstblk[n_pairs:] = 0
    pair_srcblk[n_pairs:] = 0

    lsrc = np.zeros((P, T), np.int32)
    ldst = np.zeros((P, T), np.int32)
    slot_src = np.zeros((P, T), np.int32)
    slot_dst = np.zeros((P, T), np.int32)
    slot_mask = np.zeros((P, T), bool)
    lsrc[pair_id, slot] = (src - pair_srcblk[pair_id] * S).astype(np.int32)
    ldst[pair_id, slot] = (dst - pair_dstblk[pair_id] * S).astype(np.int32)
    slot_src[pair_id, slot] = src.astype(np.int32)
    slot_dst[pair_id, slot] = dst.astype(np.int32)
    slot_mask[pair_id, slot] = True

    # pairs are grouped by destination block; padded pairs sit past
    # rowptr[-1], so no destination block iterates over them
    rowptr = np.zeros(n_blocks + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(pair_dstblk[:n_pairs], minlength=n_blocks))
    # K4's per-row lists: each real slot under its destination row, in slot
    # order (a fixed order, so the kernel's sums are deterministic)
    slot_id = pair_id * T + slot
    by_row = np.lexsort((slot_id, dst))
    row_ptr = np.zeros(n_blocks * S + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(dst, minlength=n_blocks * S))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    bcoo = BlockCOO(
        rowptr=t(rowptr), src_blk=t(pair_srcblk), dst_blk=t(pair_dstblk),
        lsrc=t(lsrc), ldst=t(ldst), row_ptr=t(row_ptr), row_slot=t(slot_id[by_row]),
        n_nodes=int(n), S=int(S), T=int(T),
    )
    return bcoo, slot_src.reshape(-1), slot_dst.reshape(-1), slot_mask.reshape(-1)


def _rows(bcoo: BlockCOO, n_pairs: int):
    """Global source and destination rows of the slots of the first
    n_pairs pair chunks, int64 [n_pairs·T] each."""
    S = bcoo.S
    src = bcoo.src_blk[:n_pairs, None].long() * S + bcoo.lsrc[:n_pairs].long()
    dst = bcoo.dst_blk[:n_pairs, None].long() * S + bcoo.ldst[:n_pairs].long()
    return src.reshape(-1), dst.reshape(-1)


# ---------------------------------------------------------------- plain


def spmm_block_plain(bcoo: BlockCOO, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """K4's plain version, the JAX kernel's function: every slot of the
    pairs below rowptr[-1] adds w·h[src row] into its destination row."""
    n_real = int(bcoo.rowptr[-1])
    src, dst = _rows(bcoo, n_real)
    msg = h[src] * w[:n_real].reshape(-1, 1)
    return torch.zeros_like(h).index_add_(0, dst, msg)


def sddmm_block_plain(bcoo: BlockCOO, h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5's plain version: the dot product of every slot's rows, padding
    slots and padded pairs included, [P, T]."""
    src, dst = _rows(bcoo, bcoo.n_pairs)
    return torch.sum(h[src] * g[dst], dim=-1).reshape(bcoo.n_pairs, bcoo.T)


# ---------------------------------------------------------------- wrappers


def _check(bcoo: BlockCOO, named) -> None:
    """Raise on what the kernels (and plain versions) do not take; named is
    [(name, tensor, shape)] with shape None for an [n_rows, D] operand."""
    dt = named[0][1].dtype
    dev = named[0][1].device
    if dt != torch.float32 and not (dt == torch.float64 and dev.type == "cpu"):
        raise NotImplementedError(
            f"blocked kernels take f32 (the plain versions also f64 on the "
            f"CPU), got {dt} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    D = None
    for name, t, shape in named:
        if shape is None:
            if t.dim() != 2 or t.shape[0] != bcoo.n_rows or (D is not None and t.shape[1] != D):
                raise ValueError(f"{name} must be [n_blocks·S={bcoo.n_rows}, D], "
                                 f"got {tuple(t.shape)}")
            D = t.shape[1]
        elif tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype}, expected {dt}")
        if t.device != dev or bcoo.device != dev:
            raise ValueError(f"{name} is on {t.device}, the layout on {bcoo.device}")


def _launch(fn, name, args, ints, out) -> torch.Tensor:
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{name}: all operands must be contiguous")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        rc = fn(*[t.data_ptr() for t in args], out.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    return out


def spmm_block(bcoo: BlockCOO, w: torch.Tensor, h: torch.Tensor,
               counter: str = "spmm_block") -> torch.Tensor:
    """K4: out = A @ h.  w f32 [P, T] live-edge weights (0 on padding
    slots); h f32 [n_blocks·S, D]; returns [n_blocks·S, D].  A launch counts
    under launches[counter]."""
    _check(bcoo, [("h", h, None), ("w", w, (bcoo.n_pairs, bcoo.T))])
    if h.device.type == "cpu":
        return spmm_block_plain(bcoo, w, h)
    out = torch.empty_like(h)
    _launch(_load().mdc_spmm_block, counter,
            [bcoo.row_ptr, bcoo.row_slot, bcoo.src_blk, bcoo.lsrc, w, h],
            [bcoo.n_rows, bcoo.S, bcoo.T, h.shape[1]], out)
    launches[counter] += 1
    return out


def sddmm_block(bcoo: BlockCOO, h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5: dw [P, T], dw[p, t] = h[src row] · g[dst row] for every slot
    (padding slots give h[src_blk·S]·g[dst_blk·S], padded pairs h[0]·g[0],
    as the JAX kernel gives them)."""
    _check(bcoo, [("h", h, None), ("g", g, None)])
    if h.device.type == "cpu":
        return sddmm_block_plain(bcoo, h, g)
    out = torch.empty((bcoo.n_pairs, bcoo.T), dtype=h.dtype, device=h.device)
    _launch(_load().mdc_sddmm_block, "sddmm_block",
            [bcoo.src_blk, bcoo.dst_blk, bcoo.lsrc, bcoo.ldst, h, g],
            [bcoo.n_slots, bcoo.S, bcoo.T, h.shape[1]], out)
    launches["sddmm_block"] += 1
    return out


class BlockSpmm(torch.autograd.Function):
    """A @ h over a blocked layout, differentiable in w and h.

    Holds only for a symmetric adjacency with equal weights in both
    orientations (the duplex graphs store both directions of every edge
    with one liveness): then dh = Aᵀg = Ag is K4 on the incoming gradient,
    counted under spmm_block_bwd, and dw = K5(h, g) (the JAX package's
    pallas_spmm.spmm custom_vjp, :403-421)."""

    @staticmethod
    def forward(ctx, bcoo: BlockCOO, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ctx.bcoo = bcoo
        ctx.save_for_backward(w, h)
        return spmm_block(bcoo, w, h)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        w, h = ctx.saved_tensors
        g = g.contiguous()
        dh = spmm_block(ctx.bcoo, w, g, "spmm_block_bwd") if ctx.needs_input_grad[2] else None
        dw = sddmm_block(ctx.bcoo, h, g) if ctx.needs_input_grad[1] else None
        return None, dw, dh


def blocked_spmm(bcoo: BlockCOO, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A @ h through BlockSpmm (symmetric adjacency)."""
    return BlockSpmm.apply(bcoo, w, h)
