"""The port's fast forward (precise=False) against the JAX package's Pallas
engine, net_packed.banded_test_forward_packed(precise=False) in interpret
mode, with unfused SAGE steps and h stored in f32 or in bf16; the fused
steps are in tests/test_torch_fast_fused.py (each interpreted forward
compiles for seconds, so the four modes take two files).  The tolerance and
its reasons are tests/test_torch_fast.py's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.cli import _load_params as jax_load_params  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.banded import pack_duplex  # noqa: E402
from mdcommunity_tpu.models.net_packed import banded_test_forward_packed  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402

from test_torch_fast import CKPT, assert_fast_q_close  # noqa: E402

N = 1024


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(0)
    e0, e1 = synth_duplex_edges(N, 6, rng)
    jb, _, _ = jax_build(N, e0, e1)
    tb, _, _ = build_banded_duplex(N, e0, e1, device="cpu")
    assert tb.spill_free and tb.dbg0.C and tb.dbg1.C  # fused steps, live mirrors
    covered = (rng.random(tb.pad_n) < 0.1) | ~tb.node_mask.numpy()
    return jax_load_params(CKPT), jb, pack_duplex(jb), tb, covered


def check_fast_forward(state, fuse_sage, act_dtype):
    params, jb, pks, tb, covered = state
    fwd = jax.jit(lambda p, b, k, c: banded_test_forward_packed(
        p, b, k, c, interpret=True, fuse_sage=fuse_sage, precise=False,
        act_dtype=getattr(jnp, act_dtype)))
    ref = fwd(params, jb, pks, jnp.asarray(covered))
    q = banded_test_forward(load_model(CKPT, device="cpu"), tb, torch.from_numpy(covered),
                            fuse_sage=fuse_sage, precise=False,
                            act_dtype=getattr(torch, act_dtype))
    err = assert_fast_q_close(q, ref)
    print(f"fuse_sage={fuse_sage} act_dtype={act_dtype}: max err {err:.3e} of max|Q|")


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_fast_unfused_forward_matches_packed_engine(state, act_dtype):
    check_fast_forward(state, False, act_dtype)
