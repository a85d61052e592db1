"""The two CUDA kernels against their plain versions, on the card.

Marked `cuda`: without a CUDA device (and the CUDA toolkit to build the
kernels) every test here skips.  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

chip_smoke.py makes the same comparisons at the serving shapes and is the
check the port is held to on the card; these tests add small ragged shapes
and the launch counters.
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return (torch.rand(*shape, generator=gen) * 2 - 1) * scale


@pytest.mark.parametrize("activation", ["relu", "tanh", "none"])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("shape", [(1, 17, 400), (7, 33, 5), (130, 300, 6), (3, 5, 129)])
def test_fxp_dense_kernel_matches_plain(dev, shape, full, activation):
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.fxp_matmul.ref import ref_fxp_dense

    gen = torch.Generator().manual_seed(sum(shape))
    m, k, n = shape
    x, w, b = _rand(gen, m, k, scale=2).to(dev), _rand(gen, k, n, scale=k**-0.5).to(dev), _rand(gen, n).to(dev)
    before = fxp_dense_cuda.launches
    got = fxp_dense_cuda(x, w, b, full_precision=full, activation=activation)
    assert fxp_dense_cuda.launches == before + 1
    want = ref_fxp_dense(x, w, b, full_precision=full, activation=activation)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("case", ["off", "monitor", "quant"])
@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("dims", [(5, 33, 7), (17, 400, 300, 6)])
def test_fxp_mlp_fwd_kernel_matches_plain(dev, dims, batch, case):
    from repro_torch.core.fixedpoint import affine_params
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda, row_block
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward

    gen = torch.Generator().manual_seed(batch)
    ws = [_rand(gen, k, n, scale=k**-0.5).to(dev) for k, n in zip(dims[:-1], dims[1:])]
    bs = [_rand(gen, n, scale=0.1).to(dev) for n in dims[1:]]
    acts = ("relu",) * (len(ws) - 1) + ("tanh",)
    x = _rand(gen, batch, dims[0], scale=3).to(dev)
    deltas, zs = affine_params(torch.linspace(-1.0, -3.0, len(ws)), torch.linspace(1.5, 3.5, len(ws)), 16)
    deltas, zs = deltas.to(dev), zs.to(dev, torch.float32)
    qat, quant = case != "off", case == "quant"
    kw = dict(activations=acts, quant=quant, qat=qat, n_bits=16, fxp32_phase1=True)
    y, bmins, bmaxs = fxp_mlp_fwd_cuda(x, ws, bs, deltas if qat else None, zs if qat else None, **kw)
    y_ref, mins_ref, maxs_ref = ref_mlp_forward(x, ws, bs, deltas, zs, **kw)
    assert bmins.shape == (-(-batch // row_block(batch)), len(ws))
    torch.testing.assert_close(y, y_ref, **(dict(rtol=1e-3, atol=1e-3) if quant else TOL))
    torch.testing.assert_close(bmins.amin(0), mins_ref, **TOL)
    torch.testing.assert_close(bmaxs.amax(0), maxs_ref, **TOL)
    assert float(bmins.amin(0)[0]) == float(x.min()) and float(bmaxs.amax(0)[0]) == float(x.max())


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda

    x, w = torch.zeros(4, 3, device=dev), torch.zeros(3, 5, device=dev)
    with pytest.raises(TypeError, match="float32"):
        fxp_dense_cuda(x.double(), w, None, full_precision=True, activation="none")
    with pytest.raises(ValueError, match="contiguous"):
        fxp_dense_cuda(torch.zeros(3, 4, device=dev).t(), w, None, full_precision=True, activation="none")
    with pytest.raises(ValueError, match="w is"):
        fxp_dense_cuda(x, torch.zeros(4, 5, device=dev), None, full_precision=True, activation="none")
