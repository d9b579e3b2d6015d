"""The port's fast forward with fused SAGE steps (kernel K2's bf16 mode)
against the JAX package's Pallas engine in interpret mode, h stored in f32
or in bf16 (tests/test_torch_fast_packed.py has the unfused forward and the
tolerance's reasons)."""

import pytest

pytest.importorskip("jax")

from test_torch_fast_packed import check_fast_forward, state  # noqa: E402,F401


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_fast_fused_forward_matches_packed_engine(state, act_dtype):  # noqa: F811
    check_fast_forward(state, True, act_dtype)
