"""The port's fast gp-sharded forward (models/net.banded_test_forward(
mesh=..., precise=False)) against the JAX package's sharded packed engine,
net_packed.banded_test_forward_packed(mesh=..., interpret=True), on the
8-device CPU mesh; and that engine's fault, which the port does not copy:
it passes no `precise` to its halo-mode kernel, so precise=True runs the
kernel's bf16 mode, and its Q equals the port's precise=False, not its
precise=True.  (Each interpreted sharded forward compiles for ~6 s.)"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.cli import _load_params as jax_load_params  # noqa: E402
from mdcommunity_tpu.graphs.banded import pack_duplex  # noqa: E402
from mdcommunity_tpu.graphs.banded import shard_banded_duplex as jax_shard_duplex  # noqa: E402
from mdcommunity_tpu.models.net_packed import banded_test_forward_packed  # noqa: E402
from mdcommunity_tpu.parallel.band_partition import shard_band_vectors, shard_packed_band  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

from test_torch_fast import assert_fast_q_close  # noqa: E402
from test_torch_sharded import CKPT, _graph  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def net():
    return load_model(CKPT, device="cpu")


@pytest.fixture(scope="module")
def packed_sharded():
    """The JAX package's sharded packed forward at n = 2,048 (8 blocks),
    gp = 2, G = 2 (two programs a shard), with precise=True and with
    precise=False."""
    jb, tb, covered = _graph(2048, 0)
    jm = jax_mesh(dp=4, gp=2, devices=jax.devices()[:8])
    pks = [shard_packed_band(jm, pk) for pk in pack_duplex(jb, G=2)]
    args = (jax_load_params(CKPT), jax_shard_duplex(jm, jb), *pks,
            shard_band_vectors(jm, jnp.asarray(covered)))
    qs = {}
    for precise in (True, False):
        fwd = jax.jit(lambda p, b, k0, k1, c: banded_test_forward_packed(
            p, b, (k0, k1), c, interpret=True, mesh=jm, precise=precise))
        qs[precise] = np.asarray(fwd(*args))
    return tb, covered, qs


def test_sharded_fast_forward_matches_packed_engine(net, packed_sharded):
    """precise=False (h stored in f32, as the engine's default act_dtype)
    against the packed engine's bf16 halo kernel; the tolerance and its
    reasons are tests/test_torch_fast.py's."""
    tb, covered, qs = packed_sharded
    q = banded_test_forward(net, tb, torch.from_numpy(covered), mesh=make_mesh(2, "cpu"),
                            precise=False)
    err = assert_fast_q_close(q, qs[False])
    print(f"sharded fast forward vs packed engine: max err {err:.3e} of max|Q|")


def test_jax_sharded_packed_forward_ignores_precise(net, packed_sharded):
    """The JAX package's fault, pinned: spmm_band_packed_sharded passes no
    `precise` to _make_kernel (band_partition.py:246-248), whose default is
    the bf16 mode, so its sharded forward gives the same Q with
    precise=True as with precise=False, and that Q is the port's
    precise=False one, more than 1e-4 of max|Q| from the port's (f32)
    precise=True one."""
    tb, covered, qs = packed_sharded
    np.testing.assert_array_equal(qs[True], qs[False])
    mesh = make_mesh(2, "cpu")
    cov = torch.from_numpy(covered)
    fast = banded_test_forward(net, tb, cov, mesh=mesh, precise=False)
    exact = banded_test_forward(net, tb, cov, mesh=mesh)
    assert_fast_q_close(fast, qs[True])
    fin = np.isfinite(qs[True])
    scale = np.abs(qs[True][fin]).max()
    assert np.abs(exact.numpy()[fin] - qs[True][fin]).max() > 1e-4 * scale
