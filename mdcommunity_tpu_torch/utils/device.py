"""Device selection for the port's entry points, the dense layers'
precision, and their row-chunked products."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

# rows of one product in row_matmul: a gp = 4 shard of a 2^20-node graph
ROW_CHUNK = 1 << 18


def row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (w moved to x's device) over fixed chunks of ROW_CHUNK rows of
    x (its dim -2), each chunk one product.

    cuBLAS picks its f32 GEMM by the row count, and two choices can round
    a row's dot product apart in the last bit: on an H100 a 2^18-row
    product ran one kernel and a 2^20-row one another with a split-K
    reduction, so the per-shard dense layers of a gp = 4, 2^20-node graph
    differed from the whole graph's.  Every product of node rows by a
    weight (the embedding, the message-passing rounds, the fusion, the Q
    head) runs through this helper.  Where a shard's rows are a whole
    number of chunks, the sharded and the unsharded forward issue the same
    products, so a row's result does not depend on the sharding; the other
    case the rule allows is a shard and a whole graph that each fit in one
    chunk (up to 2^18 nodes), where each stays one product, as before, and
    the card gave equal bits (2^18 nodes, gp = 4).  The rows of a graph
    whose shards are neither may differ in the last bit.  Above ROW_CHUNK
    rows x must be 2-D (RowMatmul)."""
    w = w.to(x.device)
    if x.shape[-2] <= ROW_CHUNK:
        return x @ w
    if x.dim() != 2:
        raise ValueError(f"row_matmul chunks a 2-D x only, got {tuple(x.shape)}")
    return RowMatmul.apply(x, w)


class RowMatmul(torch.autograd.Function):
    """x @ w for a 2-D x of more than ROW_CHUNK rows: one product a chunk,
    each written into its rows of the output (torch.mm(out=): no
    concatenation copy); the backward's dx likewise, dw one product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _chunked_mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _chunked_mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = x.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def _chunked_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    out = x.new_empty((x.shape[0], w.shape[1]))
    for r in range(0, x.shape[0], ROW_CHUNK):
        torch.mm(x[r:r + ROW_CHUNK], w, out=out[r:r + ROW_CHUNK])
    return out


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With `device` unset and no CUDA card this raises instead of falling back
    to the CPU, so a run that was meant for the card never silently measures
    PyTorch's CPU kernels.  Pass device="cpu" to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def set_precise_matmul() -> None:
    """True-f32 dense layers for the precise eval: no TF32 in matmuls or
    convolutions (the counterpart of the JAX package's
    default_matmul_precision('highest')).  Greedy dismantling quality is
    sensitive to eval-path Q rounding (bf16 eval cost ~0.035 AUDC on an
    18k-node graph in the JAX package's measurements)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def matmul_precision(precise: bool) -> Iterator[None]:
    """The dense layers' precision for the span of a `with` block (the
    counterpart of the JAX package's eval/metrics._prec_ctx): precise=True
    turns TF32 off in matmuls and cuDNN (default_matmul_precision
    ('highest')), precise=False turns it on (XLA's default f32 matmul
    precision on an NVIDIA GPU is TF32, so this is the fast eval's dense
    layers).  Both flags are restored on exit, after an exception too, so a
    fast forward leaves a later precise one in the same process untouched."""
    cuda_mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda_mm.allow_tf32, cudnn.allow_tf32)
    cuda_mm.allow_tf32 = cudnn.allow_tf32 = not precise
    try:
        yield
    finally:
        cuda_mm.allow_tf32, cudnn.allow_tf32 = saved
