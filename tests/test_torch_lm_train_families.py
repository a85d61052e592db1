"""Port parity: `loss_fn` and its gradient against the JAX reference for the
other block families — MoE (moonshot: the dense dispatch and its balance
loss, `aux_coef`·aux / n_layers), RWKV-6 (the chunked WKV recurrence) and
RG-LRU (recurrentgemma: the doubling scan beside local attention), float32,
QAT off, in the monitor phase and in the quant phase.  Tolerances as
`tests/_torch_lm_train.py` states them: loss 2e-5·|loss| + 2e-5; each
gradient leaf 1e-4·max|g_leaf| + 1e-6 (off, monitor) or 1e-3·max|g_leaf| +
1e-6 (quant); updated ranges rtol 1e-4 / atol 5e-5, counts exact.

The recurrent blocks run a training forward from a fresh zero state: they
return their new state and write nothing (`layers.carry_state`), so the
backward reads the states the forward used; `torch.autograd.gradcheck`
holds their recurrence cores in float64, and a given state is still
written in place (the serving contract).
"""

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import _torch_lm_train as H  # noqa: E402

ARCHS = ("moonshot_v1_16b_a3b", "rwkv6_1_6b", "recurrentgemma_2b")


@pytest.mark.parametrize("mode", H.MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, mode):
    want_loss, want_grads, want_ranges = H.reference(arch, mode)
    loss, grads, ranges = H.port(arch, mode)
    H.assert_loss(loss, want_loss, f"{arch} {mode}")
    H.assert_grads(grads, want_grads, H.GRAD_TOL[mode], f"{arch} {mode}")
    if mode != "off":
        H.assert_ranges(ranges, want_ranges, f"{arch} {mode}")


def test_recurrence_cores_pass_gradcheck_in_float64():
    """`torch.autograd.gradcheck` (float64 central differences against the
    analytic Jacobian) on the recurrences' cores: two chained RWKV-6 WKV
    chunks, the second seeded by the first's state (the state a training
    forward carries between chunks), and the RG-LRU doubling scan.  The
    model runs them in float32; the cores follow their inputs' dtype."""
    from repro_torch.models import rglru, rwkv6

    g = torch.Generator().manual_seed(0)
    b, c, h, n = 1, 4, 2, 3
    r, k, v = (torch.randn(b, 2 * c, h, n, generator=g, dtype=torch.float64) for _ in range(3))
    logw = -torch.rand(b, 2 * c, h, n, generator=g, dtype=torch.float64) - 0.1
    u = torch.randn(h, n, generator=g, dtype=torch.float64)
    s0 = torch.randn(b, h, n, n, generator=g, dtype=torch.float64)

    def two_chunks(r, k, v, logw, u, s0):
        o1, s1 = rwkv6._wkv_chunk(r[:, :c], k[:, :c], v[:, :c], logw[:, :c], u, s0)
        o2, s2 = rwkv6._wkv_chunk(r[:, c:], k[:, c:], v[:, c:], logw[:, c:], u, s1)
        return torch.cat([o1, o2], 1), s2

    args = tuple(t.requires_grad_(True) for t in (r, k, v, logw, u, s0))
    assert torch.autograd.gradcheck(two_chunks, args)
    a = torch.rand(2, 7, 3, generator=g, dtype=torch.float64).requires_grad_(True)
    x = torch.randn(2, 7, 3, generator=g, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(rglru.linear_scan, (a, x))


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "recurrentgemma_2b"])
def test_training_forward_writes_no_state_and_serving_writes_the_given_one(arch, remat):
    """A fresh-state forward (no `states`) differentiates: the loss's
    backward runs (without remat autograd's saved-tensor check would refuse
    a state written in place after the chunks read it; with remat the
    recompute would hide it).  A prefill with a cache still writes the
    recurrent states into the cache's tensors, as serving needs."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.models import transformer as PT

    rc, pc, _, np_params, _ = H.setup(arch)
    pc = dataclasses.replace(pc, remat=remat)
    params = convert.lm_params_from_numpy(np_params, device="cpu")
    live = {k: v for k, v in params.items()}
    w = params["scan"][0]["ln1"]["scale"].clone().requires_grad_(True)
    live["scan"] = [dict(params["scan"][0], ln1=dict(params["scan"][0]["ln1"], scale=w))] + params["scan"][1:]
    loss, _ = PT.loss_fn(live, H.to_torch(H.batch(rc, 6)), pc)
    loss.backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all()) and float(w.grad.abs().max()) > 0
    cache = PT.init_cache(pc, H.B, 64, device="cpu")
    before = [t.clone() for slot in cache["scan"] for t in slot.values()]
    with torch.inference_mode():
        PT.prefill(params, {"tokens": H.to_torch(H.batch(rc, 6))["tokens"]}, pc, cache=cache)
    after = [t for slot in cache["scan"] for t in slot.values()]
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
