"""Card tests of the port's kernels against their plain versions.

This file imports neither JAX nor tlie_tpu, so it runs on the card machine,
where JAX is not installed; the repository's conftest imports JAX, so skip
it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the fixture decides, not the import).
Tolerance: 1e-5 of max|h| (and of max|d| for the backward), as for the CPU
tests and chip_smoke.py; ``da`` within 1e-5 of Σ (max|d|·|h_{t-1}| +
|d_t|·max|h|) over the axes it is summed along.
"""

import pytest
import torch

from tlie_tpu_torch.ops import LAUNCHES, diag_linear_scan, diag_scan_cuda, diag_scan_plain
from tlie_tpu_torch.ops.scan import _shift, _sum_to, diag_scan_bwd_cuda, diag_scan_bwd_plain

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
    with pytest.raises(ValueError):
        diag_scan_bwd_cuda(b, b, b.transpose(1, 2).contiguous().transpose(1, 2))
    # the reverse scan runs through the forward kernel's reverse mode
    a = 0.5 * torch.ones_like(b)
    assert _close(diag_linear_scan(a, b, reverse=True), diag_scan_plain(a, b, reverse=True))


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("shape, a_shape", [((4, 512, 128), (128,)), ((2, 300, 40), (300, 40)),
                                            ((3, 97, 96), (3, 97, 96))],
                         ids=["lru_lambda", "per_step", "per_example"])
def test_backward_kernel_matches_plain(cuda_device, shape, a_shape, reverse):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    r = 0.9 + 0.09 * torch.rand(a_shape, device=cuda_device, generator=g)
    th = 6.28 * torch.rand(a_shape, device=cuda_device, generator=g)
    a = (r * torch.cos(th), r * torch.sin(th))
    b = tuple(torch.randn(shape, device=cuda_device, generator=g) for _ in range(2))
    w = tuple(torch.randn(shape, device=cuda_device, generator=g) for _ in range(2))
    h = diag_scan_plain(a, b, reverse=reverse)
    before = LAUNCHES["diag_scan_bwd"]
    da, d = diag_scan_bwd_cuda(a, h, w, reverse=reverse)
    torch.cuda.synchronize()
    assert LAUNCHES["diag_scan_bwd"] == before + 1
    da_ref, d_ref = diag_scan_bwd_plain(a, h, w, reverse=reverse)
    assert _close(d, d_ref)
    h_prev = sum(_shift(x, 1 if reverse else -1).abs() for x in h)
    d_abs = sum(x.abs() for x in d_ref)
    hmax = max(x.abs().max() for x in h)
    tol = RTOL_OF_MAX * _sum_to(d_abs.max() * h_prev + d_abs * hmax, torch.Size(a_shape))
    for x, y in zip(da, da_ref):
        assert x.shape == a_shape and bool(((x - y).abs() <= tol).all())
