"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


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
