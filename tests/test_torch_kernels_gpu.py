"""Card tests of the port's kernels against their plain versions.

This file imports neither JAX nor tlie_tpu, so it runs on the card machine,
where JAX is not installed; the repository's conftest imports JAX, so skip
it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the fixture decides, not the import).
Tolerance: 1e-5 of max|h| (and of max|d| for the backward), as for the CPU
tests and chip_smoke.py; ``da`` within 1e-5 of Σ (max|d|·|h_{t-1}| +
|d_t|·max|h|) over the axes it is summed along.  The fused head, the decay
attention and the flash attention hold each output element to a stated
fraction of the sum of its terms' magnitudes (see each section).
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
@pytest.mark.parametrize("shape, a_shape", [((2, 256, 128), (256, 128)), ((3, 77, 40), (40,)),
                                            ((32, 161, 48), (48,))],
                         ids=["lru_like", "ragged", "speech_commands_s5"])
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
@pytest.mark.parametrize("complex_mode, a_kind, reverse",
                         [(True, "per_example", False), (True, "per_example", True),
                          (False, "per_channel", True), (False, "per_example", True)],
                         ids=["complex_time_a", "complex_time_a_rev", "real_lambda_rev",
                              "real_time_a_rev"])
def test_forward_kernel_crosses_rounds_at_a_ragged_length(cuda_device, complex_mode, a_kind,
                                                          reverse):
    """L 1301 is five whole rounds of the kernel's 256 steps and a ragged
    sixth, N 40 two whole 16-channel blocks and a ragged third; a (B, L, N)
    decay varies in time, as a selective scan's does."""
    shape = (3, 1301, 40)
    a_shape = shape if a_kind == "per_example" else shape[-1:]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    r = 0.9 + 0.09 * torch.rand(a_shape, device=cuda_device, generator=g)
    th = 6.28 * torch.rand(a_shape, device=cuda_device, generator=g)
    if complex_mode:
        a = (r * torch.cos(th), r * torch.sin(th))
        b = tuple(torch.randn(shape, device=cuda_device, generator=g) for _ in range(2))
    else:
        a, b = r, torch.randn(shape, device=cuda_device, generator=g)
    before = LAUNCHES["diag_scan"]
    h = diag_scan_cuda(a, b, reverse=reverse)
    torch.cuda.synchronize()
    assert LAUNCHES["diag_scan"] == before + 1
    assert _close(h, diag_scan_plain(a, b, reverse=reverse))
    # no atomics, a fixed fold order: a second launch gives the same bits
    h2 = diag_scan_cuda(a, b, reverse=reverse)
    h, h2 = (x if isinstance(x, tuple) else (x,) for x in (h, h2))
    assert all(torch.equal(x, y) for x, y in zip(h, h2))


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
                                            ((3, 97, 96), (3, 97, 96)),
                                            ((8, 1024, 512), (512,)),
                                            ((3, 1001, 40), (40,)),
                                            ((32, 161, 48), (48,))],
                         ids=["lru_lambda", "per_step", "per_example", "lm_lambda",
                              "ragged_lambda", "speech_commands_s5"])
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
    # no atomics: a second launch gives the same bits
    da2, d2 = diag_scan_bwd_cuda(a, h, w, reverse=reverse)
    assert all(torch.equal(x, y) for x, y in zip(da + d, da2 + d2))


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("complex_mode", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("a_shape, shape",
                         [((3, 1, 40), (3, 1001, 40)), ((2, 3, 1, 40), (2, 3, 1001, 40)),
                          ((3, 1, 1, 40), (3, 2, 1001, 40))],
                         ids=["per_example", "per_example_two_batch_dims", "partial_broadcast"])
def test_per_example_decay_through_autograd_matches_plain(cuda_device, a_shape, shape,
                                                          complex_mode, reverse):
    """A decay that varies by example and is constant in time, read at batch
    stride N and time stride 0 (or, where no batch stride fits, from a
    broadcast copy), at a ragged L 1001: the forward against
    ``diag_scan_plain`` and the gradients of a and b against the plain
    scan's autograd on the same inputs, da at a's own shape."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    r = 0.9 + 0.09 * torch.rand(a_shape, device=cuda_device, generator=g)
    th = 6.28 * torch.rand(a_shape, device=cuda_device, generator=g)
    if complex_mode:
        a = (r * torch.cos(th), r * torch.sin(th))
        b = tuple(torch.randn(shape, device=cuda_device, generator=g) for _ in range(2))
    else:
        a, b = r, torch.randn(shape, device=cuda_device, generator=g)
    w = tuple(torch.randn(shape, device=cuda_device, generator=g) for _ in range(len(_pl(b))))
    leaves = [x.clone().requires_grad_() for x in _pl(a) + _pl(b)]
    k = len(_pl(a))
    args = (tuple(leaves[:k]), tuple(leaves[k:])) if complex_mode else (leaves[0], leaves[1])
    before = dict(LAUNCHES)
    h = diag_linear_scan(*args, reverse=reverse)
    sum(((x * y).sum() for x, y in zip(_pl(h), w))).backward()
    torch.cuda.synchronize()
    assert LAUNCHES["diag_scan"] == before["diag_scan"] + 1
    assert LAUNCHES["diag_scan_bwd"] == before["diag_scan_bwd"] + 1
    ref_leaves = [x.detach().clone().requires_grad_() for x in leaves]
    ref_args = ((tuple(ref_leaves[:k]), tuple(ref_leaves[k:])) if complex_mode
                else (ref_leaves[0], ref_leaves[1]))
    ref = diag_scan_plain(*ref_args, reverse=reverse)
    sum(((x * y).sum() for x, y in zip(_pl(ref), w))).backward()
    assert _close(tuple(x.detach() for x in _pl(h)), tuple(x.detach() for x in _pl(ref)))
    db, db_ref = tuple(x.grad for x in leaves[k:]), tuple(x.grad for x in ref_leaves[k:])
    assert _close(db, db_ref)
    # da sums d_t·conj(h_{t−1}) over time (and the broadcast batch dims):
    # within 1e-5 of Σ (max|d|·|h_{t−1}| + |d_t|·max|h|) over those axes
    d_abs = sum(x.abs() for x in db_ref)
    hs = tuple(x.detach() for x in _pl(ref))
    h_prev = sum(_shift(x, 1 if reverse else -1).abs() for x in hs)
    hmax = max(x.abs().max() for x in hs)
    tol = RTOL_OF_MAX * _sum_to(d_abs.max() * h_prev + d_abs * hmax, torch.Size(a_shape))
    for x, y in zip(leaves[:k], ref_leaves[:k]):
        assert x.grad.shape == a_shape and bool(((x.grad - y.grad).abs() <= tol).all())


def _pl(x):
    return x if isinstance(x, tuple) else (x,)


# -- the fused decoder + cross-entropy kernels ----------------------------------
# loss and lse within 1e-5 relative (float32 sums of D products, exp and log),
# each row's loss within 1e-5 of |lse| + |picked logit| (fx.loss_term_scales);
# each gradient element within (1e-5 + sqrt(D)·u·Z) of the sum of the
# magnitudes of its terms: dh sums V terms and dW M terms, so float32
# rounding grows with that sum, not with the element's own size; and each
# term's factor softmax - onehot carries the absolute rounding of its logit
# as a relative error, a sum of D products bounded by Z = max|h_m|·max|W_v|
# + max|b| (u = 2^-24), as chip_smoke.py states.  All three kernels run
# their products on the tensor cores (csrc/fused_xent.cu): d_max is the
# wrapper's largest D, which takes the backward's 32-row plan; lm_width has
# the LM's ragged last vocabulary tile (50257 = 392 * 128 + 81); ragged_d (D
# 100, not a multiple of 8) pads the depth with zeros; odd_d (D 97) also
# takes the 4-byte copies of rows that are not 16-byte aligned.  Every case
# has ignored labels (every 7th row).

XENT_RTOL = 1e-5


def _grad_rtol(h, w, b):
    z = (h.norm(dim=1).max() * w.norm(dim=0).max() + b.abs().max()).item()
    return XENT_RTOL + h.shape[1] ** 0.5 * 2.0 ** -24 * z


def _xent_inputs(device, M, D, V, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(M, D, device=device, generator=g)
    w = (torch.randn(V, D, device=device, generator=g) / D ** 0.5).t()  # nn.Linear layout
    b = 0.1 * torch.randn(V, device=device, generator=g)
    labels = torch.randint(0, V, (M,), device=device, generator=g)
    labels[::7] = -100
    return h, w, b, labels


@pytest.mark.gpu
@pytest.mark.parametrize("M, D, V", [(128, 32, 300), (1024, 64, 1000), (256, 512, 50257),
                                     (256, 1024, 3000), (384, 100, 2001), (256, 97, 1000)],
                         ids=["v_below_tile", "ragged_v", "lm_width", "d_max", "ragged_d",
                              "odd_d"])
def test_fused_xent_kernels_match_plain(cuda_device, M, D, V):
    from tlie_tpu_torch.ops import fused_xent as fx

    h, w, b, labels = _xent_inputs(cuda_device, M, D, V, seed=3)
    before = {k: LAUNCHES[k] for k in ("fused_xent_fwd", "fused_xent_dh", "fused_xent_dw")}
    loss, lse = fx.fused_xent_fwd_cuda(h, w, b, labels)
    ref_loss, ref_lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    gscale = torch.full((1,), 1.0 / int((labels != -100).sum()), device=cuda_device)
    dh = fx.fused_xent_dh_cuda(h, w, b, labels, ref_lse, gscale)
    dw, db = fx.fused_xent_dw_cuda(h, w, b, labels, ref_lse, gscale)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - n for k, n in before.items()} == dict.fromkeys(before, 1)
    ref = fx.fused_xent_bwd_plain(h, w, b, labels, ref_lse, gscale)
    scales = fx.grad_term_scales(h, w, b, labels, ref_lse, gscale)
    assert bool(((lse - ref_lse).abs() <= XENT_RTOL * ref_lse.abs()).all())
    assert float(loss.sum()) == pytest.approx(float(ref_loss.sum()), rel=XENT_RTOL)
    assert bool(((loss - ref_loss).abs()
                 <= XENT_RTOL * fx.loss_term_scales(ref_loss, ref_lse)).all())
    assert dw.shape == w.shape and dw.stride() == w.stride()
    rtol = _grad_rtol(h, w, b)
    for got, want, scale in zip((dh, dw, db), ref, scales):
        assert bool(((got - want).abs() <= rtol * scale + 1e-30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("M, D", [(200, 64), (40, 97)], ids=["ragged_rows", "below_a_tile"])
def test_fused_xent_forward_kernel_takes_a_ragged_row_tile(cuda_device, M, D):
    """The forward kernel tiles rows by 64; the wrapper takes M a multiple
    of 128 (the reference's rule), so rows past M are reached through the C
    entry itself, on an h of M rows and the LM's vocabulary."""
    from tlie_tpu_torch.ops import fused_xent as fx

    h, w, b, labels = _xent_inputs(cuda_device, M, D, 50257, seed=5)
    loss = torch.empty(M, device=cuda_device)
    lse = torch.empty(M, device=cuda_device)
    splits = fx.forward_splits(M, 50257, torch.cuda.get_device_properties(0).multi_processor_count)
    part = torch.empty(3, splits, M, device=cuda_device)
    err = fx.FUSED_XENT.fn("tlie_fused_xent_fwd_f32")(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), part.data_ptr(), M, D, 50257, splits,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    ref_loss, ref_lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    assert bool(((lse - ref_lse).abs() <= XENT_RTOL * ref_lse.abs()).all())
    assert bool(((loss - ref_loss).abs()
                 <= XENT_RTOL * fx.loss_term_scales(ref_loss, ref_lse)).all())


@pytest.mark.gpu
def test_fused_xent_autograd_goes_through_the_kernels(cuda_device):
    from tlie_tpu_torch.ops import fused_xent as fx

    h, w, b, labels = _xent_inputs(cuda_device, 256, 64, 700, seed=4)
    weight = w.t().contiguous().requires_grad_()
    hh, bb = h.clone().requires_grad_(), b.clone().requires_grad_()
    before = dict(LAUNCHES)
    fx.fused_softmax_xent(hh, weight.t(), bb, labels).backward()
    for k in ("fused_xent_fwd", "fused_xent_dh", "fused_xent_dw"):
        assert LAUNCHES[k] == before[k] + 1
    with pytest.raises(ValueError, match="transpose of a row-major"):
        fx.fused_softmax_xent(h, w.contiguous(), b, labels)
    with pytest.raises(TypeError, match="float32"):
        fx.fused_softmax_xent(h.bfloat16(), w, b, labels)


# -- the fused head on bfloat16 operands (csrc/fused_xent_bf16.cu) ---------------
# loss and lse as above (float32 sums of exact products); dh, dW and db are
# rounded to bfloat16, and so is t inside, from float32 sums in other orders:
# each element within the float32 tolerance above plus one bfloat16 step
# (2^-7) of (|value| + its term sums), and at least 99 % of each equal to the
# plain version's bit for bit (without the rounding of t the CPU tests find
# 63-77 % against tlie_tpu).  The same shapes as the float32 kernels': odd_d
# and ragged_d take the ordinary loads of tiles that 16-byte copies and the
# tensor memory accelerator cannot land (D % 8 != 0), d_max the dh and dW/db
# kernels' 32-row plan on mma.sync (the others their 64-row plan on wgmma);
# and once the LM head's own shape, (8192, 512, 50257).

BF16_STEP = 2.0 ** -7
BF16_EQUAL_SHARE = 0.99


def _xent_bf16_inputs(device, M, D, V, seed):
    h, w, b, labels = _xent_inputs(device, M, D, V, seed)
    return h.bfloat16(), w.t().bfloat16().t(), b.bfloat16(), labels


def _check_bf16_grads(fx, h, w, b, labels, lse, gscale, got):
    ref = fx.fused_xent_bwd_plain(h, w, b, labels, lse, gscale)
    scales = fx.grad_term_scales(h, w, b, labels, lse, gscale)
    rtol = _grad_rtol(h.float(), w.float(), b.float())
    for name, g, want, scale in zip(("dh", "dw", "db"), got, ref, scales):
        assert g.dtype == want.dtype == torch.bfloat16, name
        g, want = g.float(), want.float()
        tol = rtol * scale + BF16_STEP * (want.abs() + scale) + 1e-30
        assert bool(((g - want).abs() <= tol).all()), name
        assert (g == want).float().mean().item() >= BF16_EQUAL_SHARE, name


@pytest.mark.gpu
@pytest.mark.parametrize("M, D, V", [(128, 32, 100), (1024, 64, 1000), (256, 512, 50257),
                                     (256, 1024, 3000), (384, 100, 2001), (256, 97, 1000),
                                     (8192, 512, 50257)],
                         ids=["v_below_tile", "ragged_v", "lm_width", "d_max", "ragged_d",
                              "odd_d", "lm_shape"])
def test_fused_xent_bf16_kernels_match_plain(cuda_device, M, D, V):
    from tlie_tpu_torch.ops import fused_xent as fx

    h, w, b, labels = _xent_bf16_inputs(cuda_device, M, D, V, seed=3)
    before = dict(LAUNCHES)
    loss, lse = fx.fused_xent_fwd_cuda(h, w, b, labels)
    ref_loss, ref_lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    gscale = torch.full((1,), 1.0 / int((labels != -100).sum()), device=cuda_device)
    dh = fx.fused_xent_dh_cuda(h, w, b, labels, ref_lse, gscale)
    dw, db = fx.fused_xent_dw_cuda(h, w, b, labels, ref_lse, gscale)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]} == {
        "fused_xent_fwd_bf16": 1, "fused_xent_dh_bf16": 1, "fused_xent_dw_bf16": 1}
    assert loss.dtype == lse.dtype == torch.float32
    assert bool(((lse - ref_lse).abs() <= XENT_RTOL * ref_lse.abs()).all())
    assert float(loss.sum()) == pytest.approx(float(ref_loss.sum()), rel=XENT_RTOL)
    assert bool(((loss - ref_loss).abs()
                 <= XENT_RTOL * fx.loss_term_scales(ref_loss, ref_lse)).all())
    assert dw.shape == w.shape and dw.stride() == w.stride()
    _check_bf16_grads(fx, h, w, b, labels, ref_lse, gscale, (dh, dw, db))


@pytest.mark.gpu
@pytest.mark.parametrize("M, D", [(200, 64), (40, 97)], ids=["ragged_rows", "below_a_tile"])
def test_fused_xent_bf16_forward_kernel_takes_a_ragged_row_tile(cuda_device, M, D):
    """As the float32 forward's: rows past M through the C entry itself."""
    from tlie_tpu_torch.ops import fused_xent as fx

    h, w, b, labels = _xent_bf16_inputs(cuda_device, M, D, 50257, seed=5)
    loss = torch.empty(M, device=cuda_device)
    lse = torch.empty(M, device=cuda_device)
    splits = fx.forward_splits_bf16(
        M, D, 50257, torch.cuda.get_device_properties(0).multi_processor_count)
    part = torch.empty(3, splits, M, device=cuda_device)
    err = fx.FUSED_XENT_BF16.fn("tlie_fused_xent_fwd_bf16")(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), part.data_ptr(), M, D, 50257, splits,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    ref_loss, ref_lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    assert bool(((lse - ref_lse).abs() <= XENT_RTOL * ref_lse.abs()).all())
    assert bool(((loss - ref_loss).abs()
                 <= XENT_RTOL * fx.loss_term_scales(ref_loss, ref_lse)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("M, D, V, b_offset", [(200, 512, 777, 0), (200, 512, 777, 1),
                                               (40, 1024, 300, 1)],
                         ids=["ragged_rows", "ragged_rows_odd_bias", "d_max_ragged_rows"])
def test_fused_xent_bf16_backward_kernels_take_a_ragged_row_tile(cuda_device, M, D, V,
                                                                 b_offset):
    """dh and dW/db through their C entries (the wrapper takes multiples of
    128 rows) at a row count no multiple of 64, or of 32 for D > 512, with
    ignored rows (every 7th) and the bias ``b_offset`` elements into its
    storage (1: not 4-byte aligned, so dh reads each bias from the aligned
    word that holds it): held to the plain version as above."""
    from tlie_tpu_torch.ops import fused_xent as fx

    h, w, b, labels = _xent_bf16_inputs(cuda_device, M, D, V, seed=6)
    b = torch.cat([b.new_zeros(b_offset), b])[b_offset:]
    assert b.data_ptr() % 4 == 2 * b_offset
    _, lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    gscale = torch.full((1,), 1.0 / int((labels != -100).sum()), device=cuda_device)
    dh = torch.empty_like(h)
    dw_rows = torch.empty(V, D, device=cuda_device, dtype=torch.bfloat16)
    db = torch.empty(V, device=cuda_device, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    args = (h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            gscale.data_ptr())
    assert fx.FUSED_XENT_BF16.fn("tlie_fused_xent_dh_bf16")(
        *args, dh.data_ptr(), M, D, V, stream) == 0
    assert fx.FUSED_XENT_BF16.fn("tlie_fused_xent_dw_bf16")(
        *args, dw_rows.data_ptr(), db.data_ptr(), M, D, V, stream) == 0
    torch.cuda.synchronize()
    _check_bf16_grads(fx, h, w, b, labels, lse, gscale, (dh, dw_rows.t(), db))


@pytest.mark.gpu
def test_fused_xent_bf16_autograd_goes_through_the_kernels(cuda_device):
    """bfloat16 leaves: the three bfloat16 kernels once each, none of the
    float32 ones, gradients in bfloat16 and in the weight's layout."""
    from tlie_tpu_torch.ops import fused_xent as fx

    h, w, b, labels = _xent_bf16_inputs(cuda_device, 256, 64, 700, seed=4)
    weight = w.t().contiguous().requires_grad_()
    hh, bb = h.clone().requires_grad_(), b.clone().requires_grad_()
    before = dict(LAUNCHES)
    fx.fused_softmax_xent(hh, weight.t(), bb, labels).backward()
    assert {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]} == {
        "fused_xent_fwd_bf16": 1, "fused_xent_dh_bf16": 1, "fused_xent_dw_bf16": 1}
    assert hh.grad.dtype == weight.grad.dtype == bb.grad.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        fx.fused_softmax_xent(h.float(), w, b, labels)


# -- the decay attention of the SSD (csrc/decay_attention.cu) -------------------

SSD_RTOL_OF_TERMS = 1e-5  # each output within 1e-5 of the sum of its terms' magnitudes


def _decay_inputs(device, BG, Q, N, Hg, P, seed, pad=7, x_offset=0):
    """C as a row-strided view (the SSD's layout, ``pad`` floats more a row:
    7 or 5 leave its rows unaligned, so the tensor-core kernels copy C and B
    4 bytes at a time; 8 lets them copy 16), B, cs with |cs| in the
    hundreds, xdt and a cotangent, from a device generator.  xdt and dy
    start ``x_offset`` floats into their storage (1: not 16-byte aligned,
    so the kernels copy them 4 bytes at a time)."""
    g = torch.Generator(device=device).manual_seed(seed)
    C = torch.randn(BG, Q, N + pad, device=device, generator=g)[:, :, pad // 2:pad // 2 + N]
    B = torch.randn(BG, Q, N, device=device, generator=g)
    dt = 0.1 * torch.rand(BG, Hg, Q, device=device, generator=g)
    A = -1 - 15 * torch.rand(1, Hg, 1, device=device, generator=g)
    cs = torch.cumsum(dt * A, -1).contiguous()
    n = BG * Hg * Q * P
    x, dy = (torch.randn(n + x_offset, device=device, generator=g)[x_offset:].view(BG, Hg, Q, P)
             for _ in range(2))
    return C, B, cs, x, dy


@pytest.mark.gpu
@pytest.mark.parametrize("BG, Q, N, Hg, P, pad, x_offset", [
    (4, 512, 128, 1, 128, 7, 0), (2, 256, 64, 4, 64, 7, 0), (3, 77, 40, 3, 33, 7, 0),
    (2, 1024, 512, 8, 64, 8, 0), (3, 200, 64, 2, 64, 5, 0), (2, 256, 64, 1, 160, 8, 0),
    (2, 256, 128, 1, 128, 8, 1), (200, 512, 64, 4, 32, 7, 0), (24, 1024, 64, 4, 32, 7, 0)],
    ids=["mqar_like", "heads", "ragged", "wikitext_bg2", "c_stride_not_4", "p160_two_slices",
         "x_base_not_16_bytes", "listops_mamba2", "imdb_mamba2"])
def test_decay_attention_kernels_match_plain(cuda_device, BG, Q, N, Hg, P, pad, x_offset):
    """The WikiText Mamba-2 shape at a reduced batch (N 512 in four slices of
    bwd_j's dB and of bwd_i's dC, four slabs of two heads), C rows 16-byte
    aligned there and at P 160 (two 128-wide slices of P), unaligned in the
    other cases; the seventh case aligns C and starts xdt and dy one float
    past a 16-byte boundary (``x_offset`` 1), at the MQAR widths; the last
    two are the padded Mamba-2 classifiers' full shapes (4 heads of 32, N
    64): ListOps at batch 50 in four chunks of 512, IMDB at batch 6 in four
    of 1,024, P 32 filling a quarter of the 128-wide slab."""
    from tlie_tpu_torch.ops import decay_attention as da

    C, B, cs, x, dy = _decay_inputs(cuda_device, BG, Q, N, Hg, P, seed=Q, pad=pad,
                                    x_offset=x_offset)
    keys = ("decay_attention_fwd", "decay_attention_bwd_i", "decay_attention_bwd_j")
    before = {k: LAUNCHES[k] for k in keys}
    y = da.decay_attention_fwd_cuda(C, B, cs, x)
    dC, dcs_i = da.decay_attention_bwd_i_cuda(C, B, cs, x, dy)
    dB, dxdt, dcs_j = da.decay_attention_bwd_j_cuda(C, B, cs, x, dy)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - n for k, n in before.items()} == dict.fromkeys(keys, 1)
    want = (da.decay_attention_plain(C, B, cs, x),) + da.decay_attention_bwd_plain(C, B, cs, x, dy)
    got = (y, dC, dcs_i, dB, dxdt, dcs_j)
    for a, b, scale in zip(got, want, da.term_scales(C, B, cs, x, dy)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert bool(((a - b).abs() <= SSD_RTOL_OF_TERMS * scale + 1e-30).all())


@pytest.mark.gpu
def test_decay_attention_autograd_and_the_ssd_go_through_the_kernels(cuda_device):
    from tlie_tpu_torch.ops import decay_attention as da
    from tlie_tpu_torch.ops.ssd import ssd_chunked_scan

    C, B, cs, x, dy = _decay_inputs(cuda_device, 2, 128, 32, 2, 16, seed=5)
    t = [a.clone().requires_grad_() for a in (C, B, cs, x)]
    keys = ("decay_attention_fwd", "decay_attention_bwd_i", "decay_attention_bwd_j")
    before = {k: LAUNCHES[k] for k in keys}
    da.decay_attention(*t).backward(dy)
    assert {k: LAUNCHES[k] - n for k, n in before.items()} == dict.fromkeys(keys, 1)
    cpu = [a.detach().cpu().clone().requires_grad_() for a in (C, B, cs, x)]
    da.decay_attention(*cpu).backward(dy.cpu())
    scales = da.term_scales(C, B, cs, x, dy)
    dcs_scale = scales[2] + scales[5]
    for got, want, scale in zip(t, cpu, (scales[1], scales[3], dcs_scale, scales[4])):
        assert bool(((got.grad.cpu() - want.grad).abs()
                     <= SSD_RTOL_OF_TERMS * scale.cpu() + 1e-30).all())
    # the chunked scan on the card: one forward launch per chunk arm call
    g = torch.Generator(device=cuda_device).manual_seed(6)
    xs = torch.randn(2, 64, 4, 8, device=cuda_device, generator=g)
    dt = 0.1 * torch.rand(2, 64, 4, device=cuda_device, generator=g)
    Bm = torch.randn(2, 64, 2, 16, device=cuda_device, generator=g)
    Cm = torch.randn(2, 64, 2, 16, device=cuda_device, generator=g)
    A = -torch.rand(4, device=cuda_device, generator=g) - 0.5
    n = LAUNCHES["decay_attention_fwd"]
    y = ssd_chunked_scan(xs, dt, A, Bm, Cm, chunk_size=16)
    assert LAUNCHES["decay_attention_fwd"] == n + 1
    ref = ssd_chunked_scan(*(a.cpu() for a in (xs, dt, A, Bm, Cm)), chunk_size=16)
    torch.testing.assert_close(y.cpu(), ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    with pytest.raises(ValueError, match="contiguous"):
        da.decay_attention(C, B, cs, x.transpose(2, 3).contiguous().transpose(2, 3))


# bfloat16 operands: y, dC, dB and dxdt are rounded to bfloat16, and so are
# the scores and dCB inside; the kernel and the plain version sum in float32
# in other orders, so where a sum lands near a rounding midpoint the two may
# round it one bfloat16 step apart (at most 2^-7 of the value), and a score
# so rounded moves its terms by as much: each of those outputs within 2^-7
# of (|value| + the sum of its terms' magnitudes), plus the float32 tolerance
# above; dcs_i and dcs_j, float32 sums of float32 terms, within the float32
# tolerance alone.  That band is wider than leaving out the rounding of the
# score or of dCB would move an output, so at least BF16_EQUAL_SHARE of each
# bfloat16 output must equal the plain version's bit for bit (chip_smoke.py
# reads 0.9998-1.0000 on the card; the plain version without those two
# roundings gives 0.60-0.64 against itself with them).
BF16_STEP = 2.0 ** -7
BF16_EQUAL_SHARE = 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("BG, Q, N, Hg, P, pad, x_offset, route", [
    (4, 512, 128, 1, 128, 8, 0, None), (2, 1024, 512, 8, 64, 8, 0, None),
    (3, 77, 40, 3, 33, 7, 0, None), (3, 200, 64, 2, 64, 5, 1, None),
    (2, 130, 136, 1, 160, 8, 0, None),
    (2, 1024, 512, 8, 64, 16, 0, "cp.async16"), (2, 192, 65, 2, 64, 16, 0, "ordinary"),
    (2, 1000, 512, 8, 64, 16, 0, "cp.async16")],
    ids=["mqar_like", "wikitext_bg2", "ragged", "unaligned", "ragged_n136_p160",
         "wikitext_bg2_c_b_16_byte_views", "odd_n_ordinary_loads", "q1000_past_a_tile"])
def test_decay_attention_bf16_kernels_through_autograd_match_plain(
        cuda_device, BG, Q, N, Hg, P, pad, x_offset, route):
    """The bfloat16 kernels through ``decay_attention``'s autograd against the
    plain bfloat16 version (its forward and backward functions) on the card,
    on the same bfloat16 inputs (cs float32): at the MQAR and WikiText Mamba-2 widths, at ragged
    Q, N and P (Q 77 and 130 past a 64-row tile, N 40 and 136, P 33 and 160
    past a 128-wide slice), and with C, xdt and dy unaligned (the kernels
    then load them 2 bytes at a time).  Each launches once, counted under
    its ``_bf16`` name, and the float32 counts stay.  Where ``route`` is
    given the case pins how the three kernels land their tiles
    (``decay_attention.load_route``): C and B as 16-byte aligned strided
    views, as ``ops/ssd.py`` hands them over (``pad`` 16: 8 elements into
    rows of N + 16), by 16-byte ``cp.async``; an odd N by ordinary loads;
    and Q 1000, not a multiple of the 64-row tile.  Every case's launches
    are counted under the route ``load_route`` gives."""
    from tlie_tpu_torch.ops import decay_attention as da

    _, B, cs, _, _ = _decay_inputs(cuda_device, BG, Q, N, Hg, P, seed=Q + 1)
    g = torch.Generator(device=cuda_device).manual_seed(Q)
    C = torch.randn(BG, Q, N + pad, device=cuda_device, generator=g).bfloat16()
    C = C[:, :, pad // 2:pad // 2 + N]
    B = B.bfloat16()
    n = BG * Hg * Q * P
    x, dy = (torch.randn(n + x_offset, device=cuda_device, generator=g).bfloat16()[x_offset:]
             .view(BG, Hg, Q, P) for _ in range(2))
    names = [da.launch_name(k, d) for k in ("fwd", "bwd_i", "bwd_j")
             for d in (torch.float32, torch.bfloat16)]
    before = {k: LAUNCHES[k] for k in names}
    routes_before = dict(da.LOAD_ROUTES)
    # C and xdt reach the kernels as the views they are (their storage
    # differentiated through the view), B and cs as leaves
    c_base, x_base = (t._base.detach().clone().requires_grad_() for t in (C, x))
    c_in = c_base[:, :, pad // 2:pad // 2 + N]
    x_in = x_base[x_offset:].view(BG, Hg, Q, P)
    b_in, cs_in = (t.detach().clone().requires_grad_() for t in (B, cs))
    assert c_in.stride() == C.stride() and x_in.data_ptr() % 16 == x.data_ptr() % 16
    y = da.decay_attention(c_in, b_in, cs_in, x_in)
    y.backward(dy)
    torch.cuda.synchronize()
    want_counts = {k: int(k.endswith("_bf16")) for k in names}
    assert {k: LAUNCHES[k] - n for k, n in before.items()} == want_counts
    got_route = da.load_route(c_in, b_in, x_in, dy)
    assert route is None or got_route == route
    assert {k: n - routes_before.get(k, 0) for k, n in da.LOAD_ROUTES.items()
            if n != routes_before.get(k, 0)} == {
        f"decay_attention_{k}_bf16:{got_route}": 1 for k in ("fwd", "bwd_i", "bwd_j")}
    got = (y, c_base.grad[:, :, pad // 2:pad // 2 + N], cs_in.grad, b_in.grad,
           x_base.grad[x_offset:].view(BG, Hg, Q, P))
    assert [t.dtype for t in got] == [torch.bfloat16] * 2 + [torch.float32] + [torch.bfloat16] * 2
    # the plain version's forward and its backward functions (not autograd
    # through the plain forward, which would not round dCB)
    dC, dcs_i, dB, dxdt, dcs_j = da.decay_attention_bwd_plain(C, B, cs, x, dy)
    want = (da.decay_attention_plain(C, B, cs, x), dC, dcs_i + dcs_j, dB, dxdt)
    sc = da.term_scales(C, B, cs, x, dy)  # (y, dC, dcs_i, dB, dxdt, dcs_j)
    scales = (sc[0], sc[1], sc[2] + sc[5], sc[3], sc[4])
    for a, b, scale in zip(got, want, scales):
        assert a.dtype == b.dtype and a.shape == b.shape and bool(torch.isfinite(a).all())
        tol = SSD_RTOL_OF_TERMS * scale + 1e-30
        if b.dtype == torch.bfloat16:
            tol = tol + BF16_STEP * (b.float().abs() + scale)
            assert (a.detach() == b).float().mean().item() >= BF16_EQUAL_SHARE
        assert bool(((a.detach().float() - b.float()).abs() <= tol).all())


# -- the flash attention (csrc/flash_attention.cu) -------------------------------

ATTN_RTOL_OF_TERMS = 1e-5  # plus attention.logit_rtol, of the sum of the terms' magnitudes


def _attention_inputs(device, B, L, H, D, seed, pad=5, base=0):
    """q, k, v as head-strided views of one projection (MHA's Wqkv split,
    ``pad`` floats more a row: 5 leaves the rows unaligned, so the
    tensor-core kernels copy 4 bytes at a time, a multiple of 4 lets them
    copy 16; ``base`` floats before q, 1 leaves the rows' starts unaligned
    whatever ``pad`` is) and a contiguous cotangent, from a device
    generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, L, 3 * H * D + pad, device=device, generator=g)
    q, k, v = (qkv[..., base + i * H * D:base + (i + 1) * H * D].reshape(B, L, H, D)
               for i in range(3))
    return q, k, v, torch.randn(B, L, H, D, device=device, generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("B, L, H, D, pad, base", [(64, 512, 1, 128, 5, 0),
                                                   (4, 1024, 4, 64, 5, 0),
                                                   (3, 77, 3, 40, 5, 0),
                                                   (2, 200, 2, 100, 5, 0),
                                                   (3, 333, 2, 128, 8, 0),
                                                   (2, 130, 4, 64, 0, 0),
                                                   (4, 256, 1, 128, 8, 1)],
                         ids=["mqar", "heads", "ragged", "ragged_d100", "aligned_d128",
                              "aligned_d64", "base_not_16_bytes"])
def test_flash_attention_kernels_match_plain(cuda_device, B, L, H, D, pad, base):
    """The last case keeps the row strides multiples of 4 floats and starts
    q, k and v one float past a 16-byte boundary (``base`` 1)."""
    from tlie_tpu_torch.ops import attention as fa

    q, k, v, do = _attention_inputs(cuda_device, B, L, H, D, seed=L, pad=pad, base=base)
    scale = D ** -0.5
    keys = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    before = {key: LAUNCHES[key] for key in keys}
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    di = fa.attention_di(o_ref, do)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse_ref, di, scale)
    dq = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse_ref, di, scale)
    torch.cuda.synchronize()
    assert {key: LAUNCHES[key] - n for key, n in before.items()} == dict.fromkeys(keys, 1)
    rtol = ATTN_RTOL_OF_TERMS + fa.logit_rtol(q, k, scale)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse_ref, di, scale)
    want = (o_ref, fa.flash_attention_bwd_dq_plain(q, k, v, do, lse_ref, di, scale), dk_ref, dv_ref)
    scales = fa.term_scales(q, k, v, do, lse_ref, scale)
    assert bool(((lse - lse_ref).abs() <= rtol * lse_ref.abs().clamp_min(1.0)).all())
    for got, w, s in zip((o, dq, dk, dv), want, scales):
        assert got.shape == w.shape and bool(torch.isfinite(got).all())
        assert bool(((got - w).abs() <= rtol * s + 1e-30).all())


@pytest.mark.gpu
def test_flash_attention_autograd_goes_through_the_kernels(cuda_device):
    from tlie_tpu_torch.ops import attention as fa

    q, k, v, do = _attention_inputs(cuda_device, 2, 200, 2, 32, seed=9)
    t = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    keys = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    before = {key: LAUNCHES[key] for key in keys}
    o = fa.causal_softmax_attention(*t)
    o.backward(do)
    assert {key: LAUNCHES[key] - n for key, n in before.items()} == dict.fromkeys(keys, 1)
    cpu = [a.detach().cpu().clone().requires_grad_() for a in (q, k, v)]
    o_cpu = fa.causal_softmax_attention(*cpu)
    o_cpu.backward(do.cpu())
    _, lse = fa.flash_attention_plain(q, k, v, 32 ** -0.5)
    rtol = ATTN_RTOL_OF_TERMS + fa.logit_rtol(q, k, 32 ** -0.5)
    scales = fa.term_scales(q, k, v, do, lse, 32 ** -0.5)
    for got, want, s in zip([o] + [a.grad for a in t], [o_cpu] + [a.grad for a in cpu], scales):
        assert bool(((got.detach().cpu() - want.detach()).abs()
                     <= 2 * rtol * s.cpu() + 1e-30).all())
    with pytest.raises(TypeError, match="float32"):
        fa.causal_softmax_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 8, 1, 136, device=cuda_device)
        fa.causal_softmax_attention(big, big, big)


# -- linear and norm attention: no port kernel, the step on the card ------------
# one training step (sparse head, AdamW behind the global-norm clip) of the
# MQAR linear and norm attention transformers, cut to d_model 64, two heads,
# L 128, vocab 512, batch 8, at dropout 0, on the card and on the CPU from
# the same weights and batch: each gradient within 1e-4 of its leaf's max|g|
# (float32 sums in other orders), the parameters within 1e-6 where |g| is at
# least 1e-2 of its leaf's max and within the movement bound 2·lr + 1e-6
# everywhere; no port kernel launches.

@pytest.mark.gpu
@pytest.mark.parametrize("which", ["lin", "norm"])
def test_attention_family_step_on_the_card_matches_the_cpu(cuda_device, which):
    import numpy as np

    from tlie_tpu_torch.config import (
        MQAR_LIN_ATTENTION_FULL, MQAR_NORM_ATTENTION_CONV_FULL, train_fields,
    )
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.training import train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    torch.backends.cudnn.allow_tf32 = False
    full = MQAR_LIN_ATTENTION_FULL if which == "lin" else MQAR_NORM_ATTENTION_CONV_FULL
    cfg = dict(full["model"], hidden_dim=64, state_dim=64, num_heads=2, vocab_size=512,
               output_dim=512, seq_len=128, dropout=0.0,
               max_pos_embed=128 if full["model"]["max_pos_embed"] else 0)
    data = MQAR(input_seq_length=128, num_kv_pairs=16, vocab_size=512, num_train_examples=64,
                num_test_examples=16)
    (xs, ys), (_, ty) = data.split("train"), data.split("test")
    k = sparse_head_k_for(cfg, ys, ty)
    f = train_fields(full)
    x, y = torch.from_numpy(xs[:8]).long(), torch.from_numpy(ys[:8]).long()
    steps = []
    for device in (cuda_device, torch.device("cpu")):
        model, _, family = build_models(cfg, generator=torch.Generator().manual_seed(3),
                                        device=device)
        opt, clip = make_family_optimizer(model, family, cfg, full["train"], f)
        before = dict(LAUNCHES)
        train_step(model, opt, x.to(device), y.to(device), {"regular": f["lr"]}, k,
                   clip_norm=clip)
        assert LAUNCHES == before
        steps.append({n: (p.detach().cpu(), p.grad.cpu()) for n, p in model.named_parameters()})
    card, cpu = steps
    for name, (p_cpu, g_cpu) in cpu.items():
        p_card, g_card = card[name]
        g_max = g_cpu.abs().max().item()
        assert (g_card - g_cpu).abs().max().item() <= 1e-4 * g_max, name
        det = g_cpu.abs() >= 1e-2 * g_max
        err = (p_card - p_cpu).abs()
        if bool(det.any()):
            assert float(err[det].max()) <= 1e-6, name
        assert float(err.max()) <= 2 * f["lr"] + 1e-6, name
    assert np.isfinite(sum(float(g.abs().sum()) for _, g in card.values()))
