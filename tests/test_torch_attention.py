"""The port's attention forward against the JAX package, on the CPU.

- ``mha``'s plain path against JAX's ``flash_attention`` (its Pallas
  kernel in interpret mode, block 128) and its ``attention_ref``, causal
  and full, float32 and bfloat16, at (1, 2, 256, 64), (2, 1, 384, 128) and
  (1, 1, 256, 256). Tolerance 2e-5 in float32 and 2e-2 in bfloat16, the
  JAX package's own: the packages add in other orders, and in bfloat16 one
  rounding of the output can land one unit apart.
- The launcher's checks (shape, ``S % block``, head dim <= 256) hold
  before it looks at the device.
- The kernel itself is held against the plain version on the card by
  ``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as j_flash_attention,
)
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import mha

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 1, 384, 128),
                                   (1, 1, 256, 256)])
def test_mha_plain_matches_jax_kernel_and_ref(shape, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(8)
    qkv = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in qkv)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in qkv)
    # both packages round the same float32 inputs to the same bf16 bits
    np.testing.assert_array_equal(np.asarray(jq, np.float32),
                                  tq.float().numpy())
    got = mha(tq, tk, tv, causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == shape
    got = got.float().numpy()
    j_kernel = j_flash_attention(jq, jk, jv, causal=causal, block_q=128,
                                 block_k=128)
    j_ref = j_attention_ref(jq, jk, jv, causal=causal)
    for name, exp in (("kernel", j_kernel), ("ref", j_ref)):
        np.testing.assert_allclose(got, np.asarray(exp, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


def test_mha_plain_causal_first_row_is_v0():
    """Row 0 of causal attention sees key 0 alone: the output is v[0]."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 3, 128, 32))
                                .astype(np.float32)) for _ in range(3))
    out = mha(q, k, v, causal=True)
    assert torch.equal(out[:, :, 0], v[:, :, 0])
    full = mha(q, k, v, causal=False)
    assert not torch.allclose(full[:, :, 0], v[:, :, 0])


def test_flash_attention_launcher_checks_shapes_first():
    x = torch.zeros((1, 2, 256, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="multiple of block_q"):
        flash_attention(*(torch.zeros((1, 2, 200, 64)),) * 3)
    with pytest.raises(ValueError, match="head dim 320"):
        flash_attention(*(torch.zeros((1, 1, 128, 320)),) * 3)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(x, x, torch.zeros((1, 2, 256, 32)))
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        flash_attention(x[0], x[0], x[0])
    # the plain path takes any head dim
    big = torch.zeros((1, 1, 128, 320))
    assert mha(big, big, big).shape == big.shape
