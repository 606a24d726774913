"""tlie_tpu_torch.ops.scan against tlie_tpu.ops.scan.

The port's plain sequential scan (the CPU path, and the reference its CUDA
kernel is held against on the card) must match the three JAX routes: the
sequential ``lax.scan``, the associative scan, and the Pallas TPU kernel run
in interpret mode as tests/test_ops_scan.py runs it.  Tolerance: 1e-5 of
max|h| — f32 accumulation over L steps with |a| < 1 in two different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tlie_tpu.ops.scan import diag_linear_scan as jax_scan
from tlie_tpu_torch.ops import _build, scan
from tlie_tpu_torch.ops.scan import diag_linear_scan, diag_scan_plain

torch.set_num_threads(1)

B, L, N = 2, 256, 128  # eligible for the Pallas kernel: N % 128 == 0, L % 256 == 0
RTOL_OF_MAX = 1e-5


def _inputs(complex_mode, seed=0):
    """Decay on the LRU ring, shared across the batch (L, N) when complex
    and per example (B, L, N) when real; inputs (B, L, N)."""
    rng = np.random.default_rng(seed)
    if complex_mode:
        r = rng.uniform(0.9, 0.99, (L, N))
        th = rng.uniform(0.0, 6.28, (L, N))
        a = ((r * np.cos(th)).astype(np.float32), (r * np.sin(th)).astype(np.float32))
        b = tuple(rng.standard_normal((B, L, N)).astype(np.float32) for _ in range(2))
        return a, b
    a = rng.uniform(0.9, 0.99, (B, L, N)).astype(np.float32)
    b = rng.standard_normal((B, L, N)).astype(np.float32)
    return a, b


def _torch(x):
    return tuple(torch.from_numpy(p) for p in x) if isinstance(x, tuple) else torch.from_numpy(x)


def _jax(x):
    return tuple(jnp.asarray(p) for p in x) if isinstance(x, tuple) else jnp.asarray(x)


def _planes(x):
    return [np.asarray(p) for p in x] if isinstance(x, tuple) else [np.asarray(x)]


@pytest.mark.parametrize("impl", ["scan", "assoc", "pallas"])
@pytest.mark.parametrize("complex_mode", [True, False], ids=["complex", "real"])
def test_plain_matches_jax_routes(complex_mode, impl):
    a, b = _inputs(complex_mode)
    h = diag_linear_scan(_torch(a), _torch(b))
    if impl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            ref = jax_scan(_jax(a), _jax(b), impl="pallas")
    else:
        ref = jax_scan(_jax(a), _jax(b), impl=impl)
    got, want = _planes(h), _planes(ref)
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, L, N)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL_OF_MAX * scale)


def test_plain_reverse_matches_jax():
    a, b = _inputs(True, seed=1)
    h = diag_linear_scan(_torch(a), _torch(b), reverse=True)
    ref = jax_scan(_jax(a), _jax(b), impl="scan", reverse=True)
    scale = max(np.abs(np.asarray(w)).max() for w in ref)
    for g, w in zip(h, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=RTOL_OF_MAX * scale)


def test_real_decay_with_complex_input_is_promoted_to_a_pair():
    a, b = _inputs(True, seed=2)
    h = diag_linear_scan(_torch(a)[0], _torch(b))
    ref = jax_scan(_jax(a)[0], _jax(b), impl="scan")
    for g, w in zip(h, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_cuda_request_raises_and_does_not_fall_back(monkeypatch):
    """A tensor routed to the card (device check mocked: no card here) must
    reach the kernel wrapper and raise, never the plain loop; the reverse
    scan too, through the forward kernel's reverse mode."""
    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(scan, "_on_cuda", lambda t: True)
    monkeypatch.setattr(scan, "diag_scan_plain", no_fallback)
    a, b = (_torch(x) for x in _inputs(True))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        diag_linear_scan(a, b)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        diag_linear_scan(a, b, reverse=True)


def test_wrapper_rejects_cpu_tensors_and_counts_nothing():
    a, b = (_torch(x) for x in _inputs(False))
    before = _build.LAUNCHES["diag_scan"]
    with pytest.raises(ValueError):
        scan.diag_scan_cuda(a, b)
    assert _build.LAUNCHES["diag_scan"] == before


def test_unsupported_axis_and_device_raise():
    a, b = (_torch(x) for x in _inputs(False))
    with pytest.raises(ValueError, match="time axis"):
        diag_linear_scan(a, b, axis=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        diag_linear_scan(a.to("meta"), b.to("meta"))


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.mark.parametrize(
    "a_shape, want",
    [((N,), (0, 0)), ((L, N), (0, N)), ((1, L, N), (0, N)), ((B, L, N), (L * N, N)),
     ((B, 1, N), (N, 0))],
    ids=["per_channel", "shared_over_batch", "leading_one", "per_example",
         "per_example_constant_in_time"],
)
def test_kernel_reads_a_through_strides(a_shape, want):
    """How the kernel reads a broadcast decay: a batch stride of 0 for a
    decay shared across the batch, N for a per-example decay constant in
    time (time stride 0), never a materialised copy."""
    assert scan._a_strides(torch.zeros(a_shape), torch.Size((B, L, N))) == want


@pytest.mark.parametrize("a_shape", [(2, 1, 1, N), (3, 1, N), (2, 3, L, N)],
                         ids=["first_of_two_batch_dims", "second_of_two_batch_dims",
                              "transposed_full"])
def test_kernel_reads_a_copy_where_no_batch_stride_fits(a_shape):
    """Where the leading dims of a cannot be read at one batch stride (a
    partial broadcast over two batch dims, or a full a that is not
    contiguous), the launchers read a contiguous broadcast copy at the
    strides of a full or a per-example decay, and the gradient still comes
    back at a's own shape (_sum_to)."""
    shape = torch.Size((2, 3, L, N))
    a = torch.zeros(a_shape)
    if a_shape == (2, 3, L, N):
        a = torch.zeros(3, 2, L, N).transpose(0, 1)
    assert scan._a_strides(a, shape) is None
    read, bstride, tstride = scan._a_layout((a,), shape, "test")
    time = a.shape[-2]
    assert read[0].shape == (2, 3, time, N) and read[0].is_contiguous()
    assert (bstride, tstride) == (time * N, N if time > 1 else 0)
    assert scan._sum_to(torch.ones(read[0].shape), a.shape).shape == a.shape


def test_expanded_decay_view_needs_no_copy():
    lam = torch.rand(N)
    assert scan._a_strides(lam.expand(L, N), torch.Size((B, L, N))) == (0, 0)
