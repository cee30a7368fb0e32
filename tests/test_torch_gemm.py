"""The batched-GEMM microbench's wrapper on the CPU, where ``bmm`` is its
plain version, against the plain reference the TPU script times
(``jnp.einsum(..., preferred_element_type=float32)`` on bf16 operands;
its ``pallas_bmm`` uses TPU-only VMEM scratch and has no interpret path).
Ragged shapes that no tile divides; float32 sums of exact bf16 products
in two orders: 1e-5 relative Frobenius (measured 1.2e-7).  The card's
kernel is held to the same in ``test_torch_cuda_kernels.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch.scripts.bench_gemm import bmm, bmm_plain, flops


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("b,m,k,n", [(3, 37, 53, 29), (2, 130, 264, 72), (1, 16, 8, 8)])
def test_bmm_cpu_matches_jax_einsum(b, m, k, n):
    rng = np.random.default_rng(0)
    a, x = _bf16(rng, (b, m, k)), _bf16(rng, (b, k, n))
    before = bmm.launches
    out = bmm(a, x)
    assert bmm.launches == before  # the CPU runs the plain version, no kernel
    assert out.dtype == torch.float32 and out.shape == (b, m, n)
    ja = jnp.asarray(a.float().numpy(), jnp.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    ref = np.asarray(jnp.einsum("fij,fjd->fid", ja, jx, preferred_element_type=jnp.float32))
    assert _rel(out.numpy(), ref) < 1e-5
    assert torch.equal(out, bmm_plain(a, x))


def test_bmm_guidance_layout_matches_jax_einsum():
    rng = np.random.default_rng(1)
    a, x = _bf16(rng, (3, 40, 24)), _bf16(rng, (2, 3, 24, 17))
    out = bmm(a, x)
    assert out.shape == (2, 3, 40, 17)
    ref = np.asarray(jnp.einsum("fij,kfjc->kfic", jnp.asarray(a.float().numpy(), jnp.bfloat16),
                                jnp.asarray(x.float().numpy(), jnp.bfloat16), preferred_element_type=jnp.float32))
    assert _rel(out.numpy(), ref) < 1e-5
    assert flops(a, x) == 2.0 * 2 * 3 * 40 * 24 * 17


def test_count_launch_is_exact_across_threads():
    """Launch counters are read as exact counts; wrappers run on worker
    threads too, so concurrent increments must not be lost."""
    from concurrent.futures import ThreadPoolExecutor

    from fresco_torch import kernels

    def wrapper():
        pass

    wrapper.launches = 0

    def bump(_):
        for _ in range(2000):
            kernels.count_launch(wrapper)

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(bump, range(8)))
    assert wrapper.launches == 8 * 2000
