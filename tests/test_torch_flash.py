"""The port's flash attention on the CPU against ``repro``'s: the plain
PyTorch version (what a CPU tensor runs, and what chip_smoke.py holds the
CUDA kernel to) against the Pallas kernel in interpret mode and against
``repro``'s pure-jnp oracle, on the same numpy inputs.  The CUDA kernel
itself runs only on a card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as fa_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels import all_kernels
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref

# test_kernels.py's tolerances: float32 summation order; bf16 rounding of
# the probabilities and of the output (2^-9 relative)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

CASES = [
    (1, 256, 4, 4, 64),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 384, 4, 1, 128),     # MQA, odd seq blocks
    (1, 128, 4, 4, 112),     # kimi-k2 head_dim
    (1, 256, 14, 2, 128),    # G = 7, deepseek-coder-33b's grouping
]


def _inputs(rng, b, s, t, h, kv, d):
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d)).astype(np.float32))


def _jax(x, dtype):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d", CASES)
def test_plain_matches_pallas_kernel(dtype, b, s, h, kv, d):
    rng = np.random.default_rng(s + h + d)
    q, k, v = _inputs(rng, b, s, s, h, kv, d)
    want = flash_attention_pallas(_jax(q, dtype), _jax(k, dtype),
                                  _jax(v, dtype), causal=True, block_q=128,
                                  block_k=128, interpret=True)
    got = t_ref.flash_attention(_torch(q, dtype), _torch(k, dtype),
                                _torch(v, dtype), causal=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,t,h,kv,d", [
    (1, 128, 256, 2, 2, 64),     # S < T: top-left causal alignment
    (1, 96, 160, 14, 2, 16),     # G = 7, neither length a tile multiple
    (2, 256, 256, 8, 2, 64),
    # the CUDA kernel's wgmma body's edges: one row and one key, S < T and
    # neither a tile multiple, B = 2 with G = 7 past one 128-row tile
    (1, 1, 1, 7, 1, 128),
    (1, 100, 300, 14, 2, 128),
    (1, 200, 520, 8, 4, 64),
    (2, 130, 130, 14, 2, 64),
])
def test_plain_matches_reference_oracle(dtype, causal, b, s, t, h, kv, d):
    rng = np.random.default_rng(b * s + t + h)
    q, k, v = _inputs(rng, b, s, t, h, kv, d)
    want = fa_ref.flash_attention(_jax(q, dtype), _jax(k, dtype),
                                  _jax(v, dtype), causal=causal)
    got = t_ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                                _torch(v, dtype), causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_noncausal_matches_pallas_kernel():
    """test_kernels.py's non-causal case: T a multiple of the kv block."""
    rng = np.random.default_rng(0)
    q, k, v = _inputs(rng, 1, 128, 256, 2, 2, 64)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False,
                                  interpret=True)
    got = t_ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_kernel_is_registered_and_refuses_cpu_tensors():
    assert t_kernel.KERNEL in all_kernels()
    assert t_kernel.KERNEL.source.name == "flash_attention.cu"
    assert t_kernel.KERNEL.source.exists()
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.flash_attention(x, x, x)
