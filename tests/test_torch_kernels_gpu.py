"""Card tests of the port's kernels against their plain versions.

This file imports neither JAX nor tlie_tpu, so it runs on the card machine,
where JAX is not installed; the repository's conftest imports JAX, so skip
it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the fixture decides, not the import).
Tolerance: 1e-5 of max|h|, as for the CPU tests and chip_smoke.py.
"""

import pytest
import torch

from tlie_tpu_torch.ops import LAUNCHES, diag_linear_scan, diag_scan_cuda, diag_scan_plain

RTOL_OF_MAX = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel builds and runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(h, ref):
    h = h if isinstance(h, tuple) else (h,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    scale = max(r.abs().max().item() for r in ref)
    return max((g - w).abs().max().item() for g, w in zip(h, ref)) <= RTOL_OF_MAX * scale


@pytest.mark.gpu
@pytest.mark.parametrize("shape, a_shape", [((2, 256, 128), (256, 128)), ((3, 77, 40), (40,))],
                         ids=["lru_like", "ragged"])
def test_complex_scan_kernel_matches_plain(cuda_device, shape, a_shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    r = 0.9 + 0.09 * torch.rand(a_shape, device=cuda_device, generator=g)
    th = 6.28 * torch.rand(a_shape, device=cuda_device, generator=g)
    a = (r * torch.cos(th), r * torch.sin(th))
    b = tuple(torch.randn(shape, device=cuda_device, generator=g) for _ in range(2))
    before = LAUNCHES["diag_scan"]
    h = diag_linear_scan(a, b)  # routed to the kernel by the CUDA tensors
    torch.cuda.synchronize()
    assert LAUNCHES["diag_scan"] == before + 1
    assert _close(h, diag_scan_plain(a, b))


@pytest.mark.gpu
def test_real_scan_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a = 0.9 + 0.09 * torch.rand(4, 300, 64, device=cuda_device, generator=g)
    b = torch.randn(4, 300, 64, device=cuda_device, generator=g)
    h = diag_scan_cuda(a, b)
    torch.cuda.synchronize()
    assert _close(h, diag_scan_plain(a, b))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    b = torch.randn(2, 8, 4, device=cuda_device)
    with pytest.raises(TypeError):
        diag_scan_cuda(b.double(), b.double())
    with pytest.raises(ValueError):
        diag_scan_cuda(b, b.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(NotImplementedError):
        diag_linear_scan(b, b, reverse=True)
