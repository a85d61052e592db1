"""Port parity: `models.transformer.loss_fn` and its gradient
(`train.step.value_and_grad`, torch autograd) against the JAX reference's
`jax.value_and_grad(loss_fn)`, float32, on the attention family (qwen2,
gemma3: global, local and banded attention), QAT off, in the monitor phase
and in the quant phase (the frontends' archs: `test_torch_lm_train_cli.py`); the chunked cross-entropy
(`ce_chunk`) against the reference's chunked and the port's unchunked
loss.

Tolerances (`tests/_torch_lm_train.py`): loss 2e-5·|loss| + 2e-5; each
gradient leaf 1e-4·max|g_leaf| + 1e-6 (off, monitor) or 1e-3·max|g_leaf|
+ 1e-6 (quant: one affine code flip at a site); updated ranges rtol 1e-4 /
atol 5e-5, counts exact.
"""

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import _torch_lm_train as H  # noqa: E402

ARCHS = ("qwen2_0_5b", "gemma3_1b")


@pytest.mark.parametrize("mode", H.MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, mode):
    want_loss, want_grads, want_ranges = H.reference(arch, mode)
    loss, grads, ranges = H.port(arch, mode)
    H.assert_loss(loss, want_loss, f"{arch} {mode}")
    H.assert_grads(grads, want_grads, H.GRAD_TOL[mode], f"{arch} {mode}")
    if mode == "off":
        assert ranges is None
    else:
        H.assert_ranges(ranges, want_ranges, f"{arch} {mode}")


@pytest.mark.parametrize("mode", ["off", "quant"])
def test_chunked_cross_entropy_matches_both_sides(mode):
    """ce_chunk = 8 of S = 32: the port's chunked loss against the
    reference's chunked loss and against its own unchunked one."""
    want_loss, want_grads, want_ranges = H.reference("qwen2_0_5b", mode, ce_chunk=8)
    loss, grads, ranges = H.port("qwen2_0_5b", mode, ce_chunk=8)
    H.assert_loss(loss, want_loss, f"ce {mode}")
    H.assert_grads(grads, want_grads, H.GRAD_TOL[mode], f"ce {mode}")
    whole_loss, whole_grads, _ = H.port("qwen2_0_5b", mode)
    H.assert_loss(loss, whole_loss, f"ce against unchunked {mode}")
    H.assert_grads(grads, [(str(i), g.numpy()) for i, g in enumerate(whole_grads)], H.GRAD_TOL[mode],
                   f"ce against unchunked {mode}")
    if mode == "quant":
        H.assert_ranges(ranges, want_ranges, "ce quant")


def test_skip_head_is_the_head_sites_input():
    """forward(skip_head=True) returns the final norm through the head's
    QAT site; the head product of it is forward's logits, bitwise."""
    from repro_torch import convert
    from repro_torch.models import transformer as PT

    rc, pc, _, np_params, _ = H.setup("qwen2_0_5b")
    params = convert.lm_params_from_numpy(np_params, device="cpu")
    b = H.to_torch(H.batch(rc, 3))
    ranges = PT.init_ranges(pc, device="cpu")
    phase = torch.tensor(False)
    logits, ex = PT.forward(params, b, pc, ranges=ranges, quant_phase=phase)
    hidden, ex2 = PT.forward(params, b, pc, ranges=ranges, quant_phase=phase, skip_head=True)
    assert hidden.shape == (H.B, H.S, pc.d_model)
    assert torch.equal(hidden @ params["embed"]["embedding"].T.to(pc.compute_dtype), logits)
    assert torch.equal(ex2["ranges"]["head"]["head_in"].a_max, ex["ranges"]["head"]["head_in"].a_max)
