"""Band-operator kernels K1, K2 and K3: CUDA wrappers, plain versions, counters.

K1 `spmm_band` computes   out = row ⊙ (A_band @ (col ⊙ h) + Gᵀ·mir_sub)
K2 `sage_step` computes   h' = l2n(relu(out_K1 @ A_w + h @ B_w))
K3 `spmm_band_halo` is K1 on one shard of a gp mesh: its windows run
linearly over [left halo | local rows | right halo] instead of around the
ring (parallel/band_partition.py drives it)

over a DenseBandGraph (ops/dense_band.py): A_band is the int8 base's S band
rows, G the mirror one-hot (`slot_of_row`), and `mir_sub` [nb·C, D] the
mirror-space result that ops/dense_band.mirror_sub computes in PyTorch.  They
replace the JAX package's Pallas TPU kernel ops/band_pallas.py::_make_kernel
(modes sage=False, sage=True and halo=True); the CUDA sources are in csrc/band.cu,
which also says what bounds them on an H100.  K1 is also the operator's
backward: ops/dense_band.BandSpmm launches it with row and col swapped,
counted under `band_spmm_bwd`.

precise=True (the default) is the kernel's f32-operand mode: the window
value x = col·h is taken in f32 and split into three bf16 pieces hi + mid +
lo = x (split_bf16x3), which the kernel multiplies by the band on the bf16
tensor cores, three passes whose products are exact, summed a k16 step at a
time into f32 (csrc/band.cu says why that is f32's result and what bounds
it; chip_smoke.py holds it to the plain version run in f64).  precise=False
is its bf16 mode (the JAX package's precise=False): the band, bf16(col ⊙ h)
(formed in f32, rounded to nearest even) and bf16(mir_sub) are the operands,
sums and the epilogue run in f32.  Its storage follows h: f32, or bf16 (the
JAX package's act_dtype=bf16), and then the output is rounded to bf16 too.
bf16 storage needs precise=False, as net_packed.py:142-143 enforces.  Both
modes launch one kernel with one plan (launch_plan: the rows a CTA and the
window-reach skip).  D is at most 256 (K2: 128).

The TPU kernel's other modes: a graph built with nibble=True
(ops/dense_band.py) stores two window columns a byte, and every kernel reads
it (the same values in the same order: the int8 build's bits).  f32_epi=False
on sage_step rounds K2's epilogue operands to bf16 (band_pallas.py:653-668),
in either precise mode.  diag= on spmm_band selects one of K1's timing
variants (band_pallas.py:280-286), whose output is wrong by design: noscale
(A_band @ h + Gᵀ·mir_sub, no scales) and nodot (out[i] = row[i]·col[j]·h[j],
j = i − B mod pad_n) have plain versions; noh and hlin have no defined
output and run only on the card.

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA tensor it
launches its kernel or raises.  Nothing falls back.  The kernels build with
nvcc for sm_90a at first use into the package's _build/ directory.  Each
wrapper adds one to `launches[name]` where it launches its kernel: the bf16
modes count under `<kernel>_bf16`, or `<kernel>_bf16_act` with bf16 storage;
K2's bf16 epilogue under band_sage_bf16epi[_bf16[_act]]; a nibble graph's
launches add `_nib`; the diag variants count under
band_spmm[_bf16]_diag_<name>.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from mdcommunity_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, build_library
from mdcommunity_tpu_torch.ops.dense_band import band_rows

SRC = os.path.join(CSRC, "band.cu")
LIB = os.path.join(BUILD_DIR, "libmdc_band.so")

# K1's timing variants (diag=), by their code in csrc/band.cu
DIAGS = {"noscale": 1, "nodot": 2, "noh": 3, "hlin": 4}
_MODES = ("", "_bf16", "_bf16_act")
_NIB = ("", "_nib")

# kernel launches on CUDA tensors, by kernel name; band_spmm_bwd counts the
# launches of K1 that compute a gradient (ops/dense_band.BandSpmm.backward),
# band_halo_bwd those of K3 (parallel/band_partition.ShardedBandSpmm), and
# band_spmm_bf16_bwd, band_halo_bf16_bwd those of their bf16 modes (the bf16
# fit, precise=False)
launches = {
    f"{k}{m}{n}": 0 for k in ("band_spmm", "band_sage", "band_sage_bf16epi", "band_halo")
    for m in _MODES for n in _NIB
}
launches.update({f"{k}{m}_bwd{n}": 0 for k in ("band_spmm", "band_halo")
                 for m in _MODES[:2] for n in _NIB})
launches.update({f"band_spmm{m}_diag_{d}": 0 for m in _MODES[:2] for d in DIAGS})
# K1 on the HCA one-hot membership at width c_pad, precise and bf16 mode
# (models/hca_banded.community_graph, kept as the check of the community
# pass ops/hca_kernels.comm_adj)
launches.update({f"band_spmm_comm{m}{n}": 0 for m in _MODES[:2] for n in _NIB})

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(force: bool = False) -> str:
    """Compile csrc/band.cu for sm_90a if the library is missing or older
    than the source; returns the library path (ptxas report in
    _build/band_ptxas.log)."""
    return build_library(SRC, LIB, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        # the trailing ints: nb, S, B, C, D, then [bf16_act,] nib and
        # diag (K1), epi_bf16 (K2) or b0, b1 before them (K3), then tr and
        # geo (launch_plan)
        lib.mdc_band_spmm.restype = i
        lib.mdc_band_spmm.argtypes = [p] * 7 + [i] * 9 + [p]
        lib.mdc_band_sage.restype = i
        lib.mdc_band_sage.argtypes = [p] * 9 + [i] * 9 + [p]
        lib.mdc_band_spmm_bf16.restype = i
        lib.mdc_band_spmm_bf16.argtypes = [p] * 7 + [i] * 10 + [p]
        lib.mdc_band_sage_bf16.restype = i
        lib.mdc_band_sage_bf16.argtypes = [p] * 9 + [i] * 10 + [p]
        lib.mdc_band_spmm_halo.restype = i
        lib.mdc_band_spmm_halo.argtypes = [p] * 11 + [i] * 10 + [p]
        lib.mdc_band_spmm_halo_bf16.restype = i
        lib.mdc_band_spmm_halo_bf16.argtypes = [p] * 11 + [i] * 11 + [p]
        _lib = lib
    return _lib


# ---------------------------------------------------------------- launch plan

KC = 64         # window columns a chunk of the contraction (csrc/band.cu KB)
MAX_ROWS = 256  # rows a CTA, at most
MIN_ROWS = 64   # the split's floor: the 64-row tiles of the first bf16 design


def window_reach(S: int, B: int, nb: int, r0: int, r1: int) -> Tuple[int, int]:
    """The window columns [lo, hi) in which local rows [r0, r1) of a band
    block can hold band entries, as the kernels skip by it.

    The band test (dense_band.band_slots) keeps an edge only if each end
    lies in the other's block window.  On a ring of three or more blocks a
    source in window columns [0, B) sits in the previous block at row
    S − B + w, whose window reaches the destination row r only if r < B;
    one in [S + B, W2) sits in the next block, whose window reaches r only
    if r >= S − B.  With one or two blocks the window wraps onto the block
    itself or its only neighbour and any column can hold an entry."""
    W2 = S + 2 * B
    if nb < 3:
        return 0, W2
    return (0 if r0 < B else B), (W2 if r1 > S - B else S + B)


def rows_per_cta(nb: int, S: int, sms: int) -> int:
    """Rows of a band block a CTA takes, in every mode: the whole block
    (rounded up to 16, at most 256), halved while the launch's nb blocks
    would leave an SM without a CTA, down to 64 rows (K2 lowers it further
    where its shared memory asks).  Each CTA stages the window columns its
    rows reach once (window_reach), so a whole-block CTA stages each window
    row once a block; at 18,432 rows (72 blocks of 256) 128-row CTAs time
    best on the H100 (PERF.md)."""
    tr = min(MAX_ROWS, -(-S // 16) * 16)
    while nb * -(-S // tr) < sms and tr > MIN_ROWS:
        tr = max(MIN_ROWS, -(-(tr // 2) // 16) * 16)
    return tr


def launch_plan(nb: int, S: int, ring_nb: int, sms: int) -> Tuple[int, int]:
    """(tr, geo) of a launch over nb blocks of S rows of a graph whose ring
    has ring_nb blocks (a K3 shard passes its own count: the ring has at
    least as many) on a card of `sms` SMs: the rows a CTA, and whether the
    window-reach skip holds (a ring of three or more blocks)."""
    return rows_per_cta(nb, S, sms), int(ring_nb >= 3)


def _launch_plan(dev: torch.device, nb: int, S: int, ring_nb: int) -> Tuple[int, int]:
    return _plan(dev.index if dev.index is not None else torch.cuda.current_device(),
                 nb, S, ring_nb)


@functools.lru_cache(maxsize=None)
def _plan(index: int, nb: int, S: int, ring_nb: int) -> Tuple[int, int]:
    return launch_plan(nb, S, ring_nb,
                       torch.cuda.get_device_properties(index).multi_processor_count)


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The precise mode's operands: f32 x as three bf16 tensors hi + mid +
    lo, as csrc/band.cu stages each window value col·h: hi = bf16(x), mid =
    bf16(x − hi), lo = bf16(x − hi − mid), each rounded to nearest even.
    x − hi has at most 16 significant bits and x − hi − mid at most 8, so
    both remainders are exact in f32 and lo is exact in bf16 wherever x's
    last bit (2^-23 of its binade) lies on bf16's grid: hi + mid + lo = x
    for 2^-110 <= |x| < (2 − 2^-8)·2^127; below, lo rounds to the subnormal
    grid (an error under 2^-134); above, hi rounds to infinity.  An int8 or
    nibble band value times any piece has at most 16 significant bits, so
    the kernel's products are exact."""
    if x.dtype != torch.float32:
        raise ValueError(f"split_bf16x3 takes f32, got {x.dtype}")
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


# ---------------------------------------------------------------- checks


def _compute_dtype(h: torch.Tensor) -> torch.dtype:
    """The dtype the scales, mir_sub, weights and sums take: f32 for bf16
    storage, else h's own."""
    return torch.float32 if h.dtype == torch.bfloat16 else h.dtype


def _check(dbg, row, col, h, mir_sub, ab=(), precise=True) -> None:
    """Raise on what the kernels (and plain versions) do not take."""
    on_cpu = h.device.type == "cpu"
    stores = (torch.float32, torch.bfloat16) if not precise else (torch.float32,)
    if h.dtype not in stores and not (h.dtype == torch.float64 and on_cpu):
        raise NotImplementedError(
            f"band kernels take {' or '.join(map(str, stores))} h with "
            f"precise={precise} (the plain versions also f64 on the CPU), got "
            f"{h.dtype} on {h.device}; bf16 storage needs precise=False"
        )
    if dbg.base.dtype != torch.int8 or dbg.slot_of_row.dtype != torch.int32:
        raise NotImplementedError("band kernels take an int8 base and int32 slots")
    pitch = dbg.W2 // 2 if dbg.nibble else dbg.W2
    if tuple(dbg.base.shape) != (dbg.n_blocks, dbg.S + dbg.C, pitch):
        raise ValueError(f"base must be [{dbg.n_blocks}, {dbg.S + dbg.C}, {pitch}] "
                         f"(nibble={dbg.nibble}), got {tuple(dbg.base.shape)}")
    if h.dim() != 2 or h.shape[0] != dbg.pad_n:
        raise ValueError(f"h must be [pad_n={dbg.pad_n}, D], got {tuple(h.shape)}")
    D = h.shape[1]
    dt = _compute_dtype(h)
    want = [
        ("row", row, (dbg.pad_n,), dt),
        ("col", col, (dbg.pad_n,), dt),
        ("mir_sub", mir_sub, (dbg.n_blocks * dbg.C, D), dt),
    ] + [(f"w{i}", w, (D, D), dt) for i, w in enumerate(ab)]
    for name, t, shape, want_dt in want:
        if tuple(t.shape) != shape or t.dtype != want_dt:
            raise ValueError(
                f"{name} must be {want_dt} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    for name, t in [("base", dbg.base), ("slot_of_row", dbg.slot_of_row)] + [
        (w[0], w[1]) for w in want
    ]:
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")


def _counter(kernel: str, h: torch.Tensor, precise: bool, nibble: bool = False,
             diag: str = "full") -> str:
    mode = "" if precise else ("_bf16_act" if h.dtype == torch.bfloat16 else "_bf16")
    return (f"{kernel}{mode}{'_nib' if nibble else ''}"
            + ("" if diag == "full" else f"_diag_{diag}"))


def _launch(fn, dbg, row, col, h, mir_sub, extra, name, flags) -> torch.Tensor:
    """Launch `fn` with the operands, the shape ints and the mode ints
    `flags` ([bf16_act,] nib, diag or epi_bf16, tr, geo)."""
    tensors = [dbg.base, h, row, col, mir_sub, dbg.slot_of_row, *extra]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all operands must be contiguous")
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        rc = fn(
            *[t.data_ptr() for t in tensors], out.data_ptr(),
            dbg.n_blocks, dbg.S, dbg.B, dbg.C, h.shape[1], *map(int, flags), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    launches[name] += 1
    return out


# ---------------------------------------------------------------- plain


def _windows(x: torch.Tensor, nb: int, S: int, B: int) -> torch.Tensor:
    """[pad_n, D] -> circular windows [nb, W2, D]: block i's window is rows
    [i·S − B, i·S + S + B) mod pad_n."""
    xb = x.reshape(nb, S, -1)
    prev = torch.roll(xb, 1, dims=0)
    nxt = torch.roll(xb, -1, dims=0)
    return torch.cat([prev[:, S - B:], xb, nxt[:, :B]], dim=1)


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _band_plain(dbg, row, col, h, mir_sub, precise, halo=None, blocks=None) -> torch.Tensor:
    """K1 in the compute dtype, before any storage rounding; with halo =
    (lh, rh, lc, rc) K3, whose windows run linearly over [lh | h | rh].
    Rows of the blocks [b0, b1) (all by default).  A nibble base is
    unpacked first (the same values)."""
    nb, S, B, C = dbg.n_blocks, dbg.S, dbg.B, dbg.C
    b0, b1 = blocks or (0, nb)
    D = h.shape[1]
    dt = _compute_dtype(h)
    hc = h.to(dt) * col[:, None]
    if halo is not None:
        lh, rh, lc, rc = halo
        hc = torch.cat([lh.to(dt) * lc[:, None], hc, rh.to(dt) * rc[:, None]])
    if not precise:  # the kernel's operands: bf16(col ⊙ h), bf16(sub)
        hc, mir_sub = _to_bf16(hc), _to_bf16(mir_sub)
    if halo is None:
        hw = _windows(hc, nb, S, B)[b0:b1]
    else:  # block b's window is rows [b·S, b·S + W2) of [lh | h | rh]
        hw = hc[b0 * S: b1 * S + 2 * B].unfold(0, dbg.W2, S).transpose(1, 2).contiguous()
    out = torch.einsum("bsw,bwd->bsd", band_rows(dbg, b0, b1).to(hc.dtype), hw)
    if C:
        slot = dbg.slot_of_row[b0:b1].to(torch.int64)
        flat = torch.arange(b0, b1, device=h.device)[:, None] * C + slot
        exp = mir_sub[flat.clamp(min=0).reshape(-1)].reshape(b1 - b0, S, D)
        out = out + torch.where((slot >= 0)[..., None], exp, torch.zeros_like(exp))
    return out.reshape(-1, D) * row[b0 * S: b1 * S, None]


def spmm_band_plain(dbg, row, col, h, mir_sub, precise: bool = True) -> torch.Tensor:
    """K1's plain version (the JAX package's _spmm_band3 without the spill):
    one einsum over the materialised windows, then the mirror expansion and
    the row scale; precise=False rounds the operands as the kernel does, and
    the result to h's storage dtype."""
    return _band_plain(dbg, row, col, h, mir_sub, precise).to(h.dtype)


def spmm_band_diag_plain(dbg, row, col, h, mir_sub, diag: str,
                         precise: bool = True) -> torch.Tensor:
    """The plain versions of K1's two timing variants that have a defined
    output: noscale, A_band @ h + Gᵀ·mir_sub (K1 at unit scales), and nodot,
    out[i] = row[i]·col[j]·h[j] with j = i − B (mod pad_n), col[j]·h[j]
    rounded to bf16 in the bf16 mode (the staged window value)."""
    if diag == "noscale":
        ones = torch.ones_like(row)
        return spmm_band_plain(dbg, ones, ones, h, mir_sub, precise)
    if diag == "nodot":
        dt = _compute_dtype(h)
        cw = torch.roll(h.to(dt) * col[:, None], dbg.B, dims=0)
        if not precise:
            cw = _to_bf16(cw)
        return (cw * row[:, None]).to(h.dtype)
    raise NotImplementedError(f"diag={diag!r} has no defined output and no plain "
                              "version: it runs only on a CUDA tensor")


def sage_step_plain(dbg, row, col, h, mir_sub, A_w, B_w,
                    precise: bool = True, f32_epi: bool = True) -> torch.Tensor:
    """K2's plain version: the fused GraphSAGE step of sage_step_packed, its
    epilogue in the compute dtype (f32_epi=True) on the unrounded pool, or
    with f32_epi=False on the pool, own rows, A_w and B_w rounded to bf16
    (f32 sums), as the kernel's bf16 epilogue."""
    pool = _band_plain(dbg, row, col, h, mir_sub, precise)
    hown = h.to(pool.dtype)
    if not f32_epi:
        pool, hown, A_w, B_w = map(_to_bf16, (pool, hown, A_w, B_w))
    z = torch.relu(pool @ A_w + hown @ B_w)
    z = z * torch.rsqrt(torch.clamp(torch.sum(z * z, -1, keepdim=True), min=1e-24))
    return z.to(h.dtype)


def spmm_band_halo_plain(shard, row, col, h, lh, rh, lc, rc, mir_sub, blocks=None,
                         precise: bool = True) -> torch.Tensor:
    """K3's plain version: the rows of blocks [b0, b1) (all by default) of
    one shard, [(b1 - b0)·S, D] in h's storage dtype; one einsum over the
    linear windows of [lc ⊙ lh | col ⊙ h | rc ⊙ rh], then the mirror
    expansion and the row scale, rounding as spmm_band_plain.  A halo given
    as None reads as zeros (no block of an interior range reads it)."""
    D, B = h.shape[1], shard.B
    zh, zc = h.new_zeros((B, D)), col.new_zeros(B)
    halo = (zh if lh is None else lh, zh if rh is None else rh,
            zc if lc is None else lc, zc if rc is None else rc)
    return _band_plain(shard, row, col, h, mir_sub, precise, halo, blocks).to(h.dtype)


# ---------------------------------------------------------------- wrappers


def spmm_band(dbg, row, col, h, mir_sub, counter: Optional[str] = None,
              precise: bool = True, diag: str = "full") -> torch.Tensor:
    """K1: out = row ⊙ (A_band @ (col ⊙ h) + Gᵀ·mir_sub), [pad_n, D] in h's
    storage dtype.  The spill COO is not part of it
    (ops/dense_band.spmm_dense_band adds it).  A launch counts under
    launches[counter] (with `_nib` for a nibble graph), by default the
    mode's own counter.  diag selects a timing variant (module doc; int8
    base, f32 storage): noscale and nodot run their plain versions on a CPU
    tensor, noh and hlin raise there."""
    _check(dbg, row, col, h, mir_sub, precise=precise)
    if diag != "full":
        if diag not in DIAGS:
            raise ValueError(f"diag must be 'full' or one of {sorted(DIAGS)}, got {diag!r}")
        if dbg.nibble or h.dtype != torch.float32 or counter is not None:
            raise ValueError("the diag variants take an int8 base, f32 storage and "
                             "their own counter")
        if h.device.type == "cpu":
            return spmm_band_diag_plain(dbg, row, col, h, mir_sub, diag, precise)
    elif h.device.type == "cpu":
        return spmm_band_plain(dbg, row, col, h, mir_sub, precise)
    name = (f"{counter}{'_nib' if dbg.nibble else ''}" if counter
            else _counter("band_spmm", h, precise, dbg.nibble, diag))
    code = DIAGS.get(diag, 0)
    plan = _launch_plan(h.device, dbg.n_blocks, dbg.S, dbg.n_blocks)
    if precise:
        return _launch(_load().mdc_band_spmm, dbg, row, col, h, mir_sub, (), name,
                       (dbg.nibble, code, *plan))
    return _launch(_load().mdc_band_spmm_bf16, dbg, row, col, h, mir_sub, (), name,
                   (h.dtype == torch.bfloat16, dbg.nibble, code, *plan))


def sage_step(dbg, row, col, h, mir_sub, A_w, B_w, precise: bool = True,
              f32_epi: bool = True) -> torch.Tensor:
    """K2: h' = l2n(relu(K1(h) @ A_w + h @ B_w)) in one pass, with
    A_w = W1 @ W3[:d] and B_w = W2 @ W3[d:] (concat-matmul algebra of the
    reference layer concat(pool @ W1, h @ W2) @ W3).  The l2n clamps Σz² at
    1e-24.  The epilogue runs in f32, or with f32_epi=False on bf16-rounded
    dot operands with f32 sums (sage_step_packed(f32_epi=False)), in either
    precise mode.  The graph's spill must be empty: its edges would have to
    land before the relu, and the kernel does not read them."""
    _check(dbg, row, col, h, mir_sub, (A_w, B_w), precise)
    if dbg.spill.nnz:
        raise ValueError("sage_step needs an empty spill set")
    if h.device.type == "cpu":
        return sage_step_plain(dbg, row, col, h, mir_sub, A_w, B_w, precise, f32_epi)
    name = _counter("band_sage" if f32_epi else "band_sage_bf16epi", h, precise, dbg.nibble)
    plan = _launch_plan(h.device, dbg.n_blocks, dbg.S, dbg.n_blocks)
    if precise:
        return _launch(_load().mdc_band_sage, dbg, row, col, h, mir_sub, (A_w, B_w), name,
                       (dbg.nibble, not f32_epi, *plan))
    return _launch(_load().mdc_band_sage_bf16, dbg, row, col, h, mir_sub, (A_w, B_w),
                   name, (h.dtype == torch.bfloat16, dbg.nibble, not f32_epi, *plan))


def spmm_band_halo(shard, row, col, h, lh, rh, lc, rc, mir_sub, blocks=None,
                   out: Optional[torch.Tensor] = None, counter: Optional[str] = None,
                   precise: bool = True) -> torch.Tensor:
    """K3: writes the rows of blocks [b0, b1) (all by default) of one shard's
    band operator into `out` [local_n, D] (allocated when not given) and
    returns it.

    shard is the shard's DenseBandGraph (parallel/band_partition.py: its own
    base blocks, slot_of_row and mirror table; pad_n = local_n).  row, col
    [local_n] and h [local_n, D] are the shard's rows; lh, rh [B, D] the last
    B rows of the left shard and the first B of the right one, in h's dtype,
    with their col scales lc, rc [B].  They may be None when no block of the
    range reads them (1 <= b0 and b1 <= n_blocks − 1: the interior call,
    which the caller can issue before the halos arrive).  precise and the
    storage dtype as in spmm_band; a launch counts under launches[counter],
    by default band_halo, band_halo_bf16 or band_halo_bf16_act."""
    nb, S, B = shard.n_blocks, shard.S, shard.B
    b0, b1 = blocks or (0, nb)
    if not 0 <= b0 < b1 <= nb:
        raise ValueError(f"block range [{b0}, {b1}) outside [0, {nb})")
    _check(shard, row, col, h, mir_sub, precise=precise)
    halos = [("lh", lh, (B, h.shape[1]), h.dtype), ("rh", rh, (B, h.shape[1]), h.dtype),
             ("lc", lc, (B,), col.dtype), ("rc", rc, (B,), col.dtype)]
    for name, t, shape, dt in halos:
        if t is None:
            if b0 < 1 or b1 > nb - 1:
                raise ValueError(f"{name} is read by blocks [{b0}, {b1}) and may not be None")
        elif tuple(t.shape) != shape or t.dtype != dt or t.device != h.device:
            raise ValueError(f"{name} must be {dt} {shape} on {h.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if out is None:
        out = torch.empty_like(h)
    elif out.shape != h.shape or out.dtype != h.dtype or out.device != h.device:
        raise ValueError("out must be like h")
    if h.device.type == "cpu":
        out[b0 * S: b1 * S] = spmm_band_halo_plain(shard, row, col, h, lh, rh, lc, rc,
                                                   mir_sub, (b0, b1), precise)
        return out
    tensors = [shard.base, h, row, col, mir_sub, shard.slot_of_row, out] + [
        t for _, t, _, _ in halos if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spmm_band_halo: all operands must be contiguous")
    nib = shard.nibble
    name = (f"{counter}{'_nib' if nib else ''}" if counter
            else _counter("band_halo", h, precise, nib))
    ptr = [0 if t is None else t.data_ptr()
           for t in (shard.base, h, lh, rh, row, col, lc, rc, mir_sub, shard.slot_of_row, out)]
    args = [*ptr, nb, S, B, shard.C, h.shape[1], b0, b1]
    plan = _launch_plan(h.device, b1 - b0, S, nb)
    lib = _load()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if precise:
            rc_ = lib.mdc_band_spmm_halo(*args, int(nib), *plan, stream)
        else:
            rc_ = lib.mdc_band_spmm_halo_bf16(*args, int(h.dtype == torch.bfloat16), int(nib),
                                              *plan, stream)
    if rc_ != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc_}")
    launches[name] += 1
    return out
