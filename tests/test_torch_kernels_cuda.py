"""The CUDA kernels against their plain versions, on the card.

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
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda, monitor_rows
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
    assert bmins.shape == (monitor_rows(batch, dims), len(ws))
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


def _net(gen, dev, dims):
    ws = [_rand(gen, k, n, scale=k**-0.5).to(dev) for k, n in zip(dims[:-1], dims[1:])]
    bs = [_rand(gen, n, scale=0.1).to(dev) for n in dims[1:]]
    return ws, bs


def _site_operands(dev, n_layers):
    from repro_torch.core.fixedpoint import affine_params

    deltas, zs = affine_params(torch.linspace(-1.0, -3.0, n_layers), torch.linspace(1.5, 3.5, n_layers), 16)
    return deltas.to(dev), zs.to(dev, torch.float32)


NETS = [((5, 33, 7), ("relu", "tanh")), ((17, 400, 300, 6), ("relu", "relu", "tanh")),
        ((23, 400, 300, 1), ("relu", "relu", "none"))]


@pytest.mark.parametrize("case", ["off", "monitor", "quant"])
@pytest.mark.parametrize("batch", [1, 7, 128])
@pytest.mark.parametrize("net", NETS, ids=["tiny", "actor", "critic"])
def test_fxp_mlp_fwd_residual_mode(dev, net, batch, case):
    """Residual mode: qs/hs as the plain version saves them, and y bitwise
    the same as without residuals."""
    from repro_torch.kernels.fxp_matmul.ref import limb_split
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward, site_project

    dims, acts = net
    gen = torch.Generator().manual_seed(batch + len(dims))
    ws, bs = _net(gen, dev, dims)
    x = _rand(gen, batch, dims[0], scale=3).to(dev)
    deltas, zs = _site_operands(dev, len(ws))
    qat, quant = case != "off", case == "quant"
    kw = dict(activations=acts, quant=quant, qat=qat, n_bits=16, fxp32_phase1=True)
    d, z = (deltas, zs) if qat else (None, None)
    y0, _, _ = fxp_mlp_fwd_cuda(x, ws, bs, d, z, **kw)
    y, bmins, bmaxs, qs, hs = fxp_mlp_fwd_cuda(x, ws, bs, d, z, save_residuals=True, **kw)
    assert torch.equal(y, y0)
    assert hs[-1] is y and len(qs) == len(hs) == len(ws)
    y_ref, _, _, qs_ref, hs_ref = ref_mlp_forward(x, ws, bs, deltas, zs, save_residuals=True, **kw)
    tol = dict(rtol=1e-3, atol=1e-3) if quant else TOL
    torch.testing.assert_close(y, y_ref, **tol)
    torch.testing.assert_close(qs[0], qs_ref[0], rtol=0, atol=0)
    for got, want in zip(hs[:-1], hs_ref[:-1]):
        torch.testing.assert_close(got, want, **tol)
    # quant phase: qs[l > 0] is the bf16 hi limb of a projected value; where
    # the previous layer's sum order flips one affine code, the limb can
    # round to the neighbouring bf16 value, one bf16 ulp (≤ 2⁻⁷ relative)
    q_tol = dict(rtol=2.0**-7, atol=1e-3) if quant else TOL
    for got, want in zip(qs[1:], qs_ref[1:]):
        torch.testing.assert_close(got, want, **q_tol)
    # ...but bitwise what the kernel's own layer inputs project to, as a bf16
    # hi limb in the quant phase: the one-ulp limit above cannot tell the limb
    # from the unrounded projection
    for i, (got, v) in enumerate(zip(qs, [x, *hs[:-1]])):
        if qat:
            v = site_project(v, quant, deltas[i], zs[i], n_bits=16, fxp32_phase1=True)
        want = limb_split(v, with_lo=False)[0] if quant else v
        assert torch.equal(got, want), i
        if quant:
            assert torch.equal(got, got.bfloat16().float()), i


@pytest.mark.parametrize("case", ["off", "monitor", "quant"])
@pytest.mark.parametrize("batch", [1, 7, 128, 200])
@pytest.mark.parametrize("net", NETS, ids=["tiny", "actor", "critic"])
def test_fxp_mlp_bwd_kernel_matches_plain(dev, net, batch, case):
    """Kernel 3 against `ref_mlp_backward` on the same residuals: the
    gradient contract of the reference (2e-4/2e-5 before the quant phase,
    5e-3/2e-2 in it), and two launches bitwise equal."""
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_bwd_cuda, fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_backward

    dims, acts = net
    gen = torch.Generator().manual_seed(3 * batch + len(dims))
    ws, bs = _net(gen, dev, dims)
    x = _rand(gen, batch, dims[0], scale=3).to(dev)
    deltas, zs = _site_operands(dev, len(ws))
    qat, quant = case != "off", case == "quant"
    kw = dict(activations=acts, quant=quant, qat=qat, n_bits=16, fxp32_phase1=True)
    d, z = (deltas, zs) if qat else (None, None)
    _, _, _, qs, hs = fxp_mlp_fwd_cuda(x, ws, bs, d, z, save_residuals=True, **kw)
    g = _rand(gen, batch, dims[-1]).to(dev)
    before = fxp_mlp_bwd_cuda.launches
    got = fxp_mlp_bwd_cuda(g, x, ws, qs, hs, d, z, **kw)
    again = fxp_mlp_bwd_cuda(g, x, ws, qs, hs, d, z, **kw)
    assert fxp_mlp_bwd_cuda.launches == before + 2
    want = ref_mlp_backward(g, x, ws, qs, hs, deltas, zs, **kw)
    tol = dict(rtol=5e-3, atol=2e-2) if quant else dict(rtol=2e-4, atol=2e-5)
    for a, b in zip([got[0], *got[1], *got[2]], [again[0], *again[1], *again[2]]):
        assert torch.equal(a, b)
    for a, b in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        torch.testing.assert_close(a, b, **tol)


BWD_NETS = dict(zip(("tiny", "actor", "critic"), NETS), streamed=((23, 800, 800, 1), ("relu", "relu", "none")),
                deep=((17,) + (64,) * 7 + (6,), ("relu",) * 7 + ("tanh",)),
                narrow_inside=((33, 300, 5, 129, 1), ("relu",) * 3 + ("none",)))
BWD_EDGES = (1, 7, 8, 9, 16, 17, 120, 121, 241, 511)
# the widest net kernel 3 takes, W streamed with 4-row blocks, at three batches
# (its residuals from the plain forward: kernel B takes widths up to 2421)
BWD_CASES = ([pytest.param(net, b, True, id=f"{name}-{b}") for name, net in BWD_NETS.items() for b in BWD_EDGES]
             + [pytest.param(((5, 3632, 3632, 3), ("relu", "tanh", "tanh")), b, False, id=f"streamed_4_rows-{b}")
                for b in (1, 9, 121)])


@pytest.mark.parametrize("case", ["off", "monitor", "quant"])
@pytest.mark.parametrize("net,batch,kernel_b", BWD_CASES)
def test_fxp_mlp_bwd_kernel_plan_edges_repeat_bitwise(dev, net, batch, kernel_b, case):
    """Kernel 3 on its launch plan's edges (`bwd_plan`: cluster widths, 8-
    and 16-row blocks, persistent clusters, the streamed-W instances with 8
    and 4 rows, eight layers, a K-split layer inside the net) against
    `ref_mlp_backward` at the gradient contract; two launches bitwise equal;
    a tanh layer's cotangent after the activation backward bitwise the
    plain version's g·(1 − h·h) (through the internal launch helper)."""
    from repro_torch.kernels.fxp_mlp.kernel import _fxp_mlp_bwd, bwd_plan, fxp_mlp_bwd_cuda, fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_backward, ref_mlp_forward

    dims, acts = net
    forward = fxp_mlp_fwd_cuda if kernel_b else ref_mlp_forward
    gen = torch.Generator().manual_seed(5 * batch + len(dims))
    ws, bs = _net(gen, dev, dims)
    x = _rand(gen, batch, dims[0], scale=3).to(dev)
    deltas, zs = _site_operands(dev, len(ws))
    qat, quant = case != "off", case == "quant"
    kw = dict(activations=acts, quant=quant, qat=qat, n_bits=16, fxp32_phase1=True)
    d, z = (deltas, zs) if qat else (None, None)
    _, _, _, qs, hs = forward(x, ws, bs, d, z, save_residuals=True, **kw)
    g = _rand(gen, batch, dims[-1]).to(dev)
    got, gs = _fxp_mlp_bwd(g, x, ws, qs, hs, d, z, **kw)
    again = fxp_mlp_bwd_cuda(g, x, ws, qs, hs, d, z, **kw)
    want = ref_mlp_backward(g, x, ws, qs, hs, deltas, zs, **kw)
    for a, b in zip([got[0], *got[1], *got[2]], [again[0], *again[1], *again[2]]):
        assert torch.equal(a, b)
    tol = dict(rtol=5e-3, atol=2e-2) if quant else dict(rtol=2e-4, atol=2e-5)
    for a, b in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        torch.testing.assert_close(a, b, **tol)
    if acts[-1] == "tanh":
        assert _bitwise(gs[-1], g * (1.0 - hs[-1] * hs[-1]))
    assert bwd_plan(batch, dims).resident == (max(dims) < 800)


def test_fxp_mlp_train_on_the_card_launches_both_kernels(dev):
    """One forward and backward of `fxp_mlp_train` on CUDA tensors: one
    kernel-B call with residuals, one kernel-3 call, gradients as on the
    CPU (plain versions)."""
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_bwd_cuda, fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ops import fxp_mlp_train

    dims, acts = NETS[0]
    gen = torch.Generator().manual_seed(0)
    ws, bs = _net(gen, torch.device("cpu"), dims)
    x = _rand(gen, 9, dims[0], scale=2)
    deltas, zs = _site_operands(torch.device("cpu"), len(ws))
    grads = {}
    for where in ("cpu", "cuda"):
        leaves = [t.detach().to(where).requires_grad_(True) for t in (x, *ws, *bs)]
        n = len(ws)
        b0, k0 = fxp_mlp_fwd_cuda.launches, fxp_mlp_bwd_cuda.launches
        y, _, _ = fxp_mlp_train(leaves[0], leaves[1 : 1 + n], leaves[1 + n :], deltas.to(where), zs.to(where),
                                activations=acts, quant_phase=False)
        (y * y).sum().backward()
        launched = (fxp_mlp_fwd_cuda.launches - b0, fxp_mlp_bwd_cuda.launches - k0)
        assert launched == ((1, 1) if where == "cuda" else (0, 0))
        grads[where] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# kernels 4 and 5 (the fused DDPG step) against their plain twins
# --------------------------------------------------------------------------

STEP_ACTS = (("relu", "relu", "tanh"), ("relu", "relu", "none"))
# the chain passes' plan edges (chip_smoke.py STEP_PLAN_BATCHES), a fifth
# of the rows masked
STEP_EDGES = [(b, b // 5) for b in (1, 8, 9, 16, 17, 120, 121, 241, 511)]


def _smoke():
    """chip_smoke.py, the card check, for the case builder of its standing
    fused-step case."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_operands(dev, batch, masked, dims=(17, 6, (400, 300))):
    """A seeded fused-step case on `dev`: batch, trees, site operands, hyper."""
    from repro_torch.core.fixedpoint import affine_params, project, FXP32
    from repro_torch.kernels.fxp_mlp.ops import _hyper
    from repro_torch.optim import adam

    obs, act, hid = dims
    gen = torch.Generator().manual_seed(batch + masked)
    a_dims, c_dims = (obs, *hid, act), (obs + act, *hid, 1)

    def tree(d, scale=None, moments=False):
        ws = [_rand(gen, k, n, scale=scale or k**-0.5) for k, n in zip(d[:-1], d[1:])]
        bs = [_rand(gen, n, scale=scale or k**-0.5) for k, n in zip(d[:-1], d[1:])]
        if moments:
            return [w.to(dev) for w in ws], [b.to(dev) for b in bs]
        return [project(w, FXP32).to(dev) for w in ws], [project(b, FXP32).to(dev) for b in bs]

    def vtree(m):
        return [t * t * 2 + 1e-10 for t in m[0]], [t * t * 2 + 1e-10 for t in m[1]]

    am, cm = tree(a_dims, 1e-3, True), tree(c_dims, 1e-3, True)
    case = {
        "obs": _rand(gen, batch, obs, scale=2).to(dev), "action": _rand(gen, batch, act).to(dev),
        "reward": _rand(gen, batch).to(dev), "done": (torch.rand(batch, generator=gen) < 0.1).float().to(dev),
        "next_obs": _rand(gen, batch, obs, scale=2).to(dev),
        "w": (torch.arange(batch) < batch - masked).float().to(dev),
        "actor": tree(a_dims), "actor_t": tree(a_dims), "actor_m": am, "actor_v": vtree(am),
        "critic": tree(c_dims), "critic_t": tree(c_dims), "critic_m": cm, "critic_v": vtree(cm),
    }
    n_sites = 2 * (len(hid) + 1)
    d, z = affine_params(-(torch.rand(n_sites, generator=gen) * 3 + 1), torch.rand(n_sites, generator=gen) * 3 + 1, 16)
    case["deltas"], case["zs"] = d.to(dev), z.to(torch.float32).to(dev)
    c = adam.step_constants(adam.AdamConfig(), torch.tensor(5, dtype=torch.int32, device=dev))
    case["hyper"] = _hyper(1.0 / torch.clamp(case["w"].sum(), min=1.0), 0.99, 0.005, c)
    return case


def _assert_step_close(got, want, c, name, phase, critic=None, scratch=None, edge=False):
    """A kernel-4/5 result against its twin's (`replay.check_step`: the
    trees at the monitor-phase contract of tests/test_torch_ddpg_step.py,
    mu and nu widened by how far the kernel's pass-2 operands, `scratch`,
    held to their float64 replay, lie from the twin's; extrema; loss
    partials); as many monitor rows as the plan says."""
    from repro_torch.kernels.fxp_mlp.kernel import step_monitor_rows
    from repro_torch.kernels.fxp_mlp.replay import check_step

    a_dims = [int(c["obs"].shape[1])] + [int(w.shape[1]) for w in c["actor"][0]]
    c_dims = [int(c["critic"][0][0].shape[0])] + [int(w.shape[1]) for w in c["critic"][0]]
    n_rows = step_monitor_rows(int(c["obs"].shape[0]), a_dims, c_dims, name)
    assert got[4].shape[0] == got[5].shape[0] == got[6].shape[0] == n_rows
    res = check_step(got, want, c, name, phase == "quant", *scratch, critic=critic, edge=edge)
    assert not res["failures"], res["failures"]


def _step_kernels_hold(c, phase, edge=False):
    """Kernels 4 and 5 on case c: two calls bitwise equal, each against its
    twin (kernel 5 through the twin's updated critic), one launch count a
    call.  `edge`: a plan-edge case (`replay.check_step`)."""
    from repro_torch.kernels.fxp_mlp.kernel import (_ddpg_actor_step, _ddpg_critic_step, ddpg_actor_step_cuda,
                                                    ddpg_critic_step_cuda)
    from repro_torch.kernels.fxp_mlp.ref import ref_ddpg_actor_step, ref_ddpg_critic_step

    dev = c["obs"].device
    quant = phase == "quant"
    phase_t = torch.tensor([int(quant)], dtype=torch.int32, device=dev)
    kw = c["kw"]
    c_args = (c["obs"], c["action"], c["reward"], c["done"], c["next_obs"], c["w"], c["actor_t"], c["critic"],
              c["critic_t"], c["critic_m"], c["critic_v"], c["deltas"], c["zs"], c["hyper"])
    before = (ddpg_critic_step_cuda.launches, ddpg_actor_step_cuda.launches)
    got_c, scratch_c = _ddpg_critic_step(*c_args, phase_t, **kw)  # with its pass-2 operands
    again_c = ddpg_critic_step_cuda(*c_args, phase_t, **kw)
    want_c = ref_ddpg_critic_step(*c_args, quant, **kw)
    a_args = (c["obs"], c["w"], c["actor"], c["actor_m"], c["actor_v"], c["actor_t"], want_c[0], c["deltas"],
              c["zs"], c["hyper"])
    got_a, scratch_a = _ddpg_actor_step(*a_args, phase_t, **kw)
    again_a = ddpg_actor_step_cuda(*a_args, phase_t, **kw)
    want_a = ref_ddpg_actor_step(*a_args, quant, **kw)
    torch.cuda.synchronize()
    assert (ddpg_critic_step_cuda.launches, ddpg_actor_step_cuda.launches) == (before[0] + 2, before[1] + 2)
    for got, again in ((got_c, again_c), (got_a, again_a)):
        flat = lambda out: [t for tr in out[:4] for half in tr for t in half] + list(out[4:])  # noqa: E731
        assert all(torch.equal(x, y) for x, y in zip(flat(got), flat(again)))
    _assert_step_close(got_c, want_c, c, "critic", phase, scratch=scratch_c, edge=edge)
    _assert_step_close(got_a, want_a, c, "actor", phase, want_c[0], scratch_a, edge=edge)


STEP_KW = dict(actor_acts=STEP_ACTS[0], critic_acts=STEP_ACTS[1], n_bits=16, qat=True, fxp32_phase1=True,
               fxp_weights=True)


@pytest.mark.parametrize("phase", ["monitor", "quant"])
@pytest.mark.parametrize("batch,masked", [(7, 0), (128, 0), (200, 30)] + STEP_EDGES)
def test_ddpg_step_kernels_match_twins_and_repeat_bitwise(dev, batch, masked, phase):
    """Kernels 4 and 5 at the training batch, a ragged multi-block batch
    and their plans' edges (row blocks of 8 and 16, clusters of 8 and 4,
    persistent clusters)."""
    c = _step_operands(dev, batch, masked)
    c["kw"] = STEP_KW
    _step_kernels_hold(c, phase, edge=(batch, masked) in STEP_EDGES)


# nets whose layers take the kernels' other paths: hidden layers that split
# K (N ≤ 8), an action wide enough to split columns, one and four layers
STEP_NET_SHAPES = {"cpu": (5, 2, (24, 16)), "narrow": (5, 2, (4, 3)), "wide_action": (11, 12, (64,)),
                   "one_layer": (17, 6, ()), "four_layers": (17, 6, (64, 64, 64))}


@pytest.mark.parametrize("phase", ["monitor", "quant"])
@pytest.mark.parametrize("shape", STEP_NET_SHAPES)
def test_ddpg_step_kernels_take_other_nets(dev, shape, phase):
    """Kernels 4 and 5 on nets off the paper's shape, at a ragged
    multi-block batch with masked rows."""
    dims = STEP_NET_SHAPES[shape]
    n_layers = len(dims[2]) + 1
    c = _step_operands(dev, 17, 3, dims)
    c["kw"] = dict(STEP_KW, actor_acts=("relu",) * (n_layers - 1) + ("tanh",),
                   critic_acts=("relu",) * (n_layers - 1) + ("none",))
    _step_kernels_hold(c, phase, edge=True)


@pytest.mark.parametrize("phase", ["monitor", "quant"])
def test_ddpg_step_kernels_hold_the_relu_flip_case(dev, phase):
    """The standing case of chip_smoke.py (`STEP_FLIP_STATE`): the inputs on
    which kernel 5's first moments once landed two quanta from its twin's,
    a ReLU decision at a pre-activation of −5.3e-7 going the other way."""
    import numpy as np

    smoke = _smoke()
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(np.fromfile(smoke.STEP_FLIP_STATE, dtype=np.uint8)))
    _step_kernels_hold(smoke._step_case(gen, dev, 200, 30), phase)


def test_ddpg_step_kernels_graph_replays_across_a_phase_flip(dev):
    """Kernels 4 and 5 (five CUDA launches, three of them clusters) captured
    in one CUDA graph and replayed with the QAT phase flipped between
    replays: each replay bitwise the eager calls of that phase."""
    from repro_torch.kernels.fxp_mlp.kernel import ddpg_actor_step_cuda, ddpg_critic_step_cuda

    c = _step_operands(dev, 128, 0)
    phase = torch.zeros((1,), dtype=torch.int32, device=dev)
    c_args = (c["obs"], c["action"], c["reward"], c["done"], c["next_obs"], c["w"], c["actor_t"], c["critic"],
              c["critic_t"], c["critic_m"], c["critic_v"], c["deltas"], c["zs"], c["hyper"])

    def step():
        out_c = ddpg_critic_step_cuda(*c_args, phase, **STEP_KW)
        out_a = ddpg_actor_step_cuda(c["obs"], c["w"], c["actor"], c["actor_m"], c["actor_v"], c["actor_t"],
                                     out_c[0], c["deltas"], c["zs"], c["hyper"], phase, **STEP_KW)
        return [t for out in (out_c, out_a) for tr in out[:4] for half in tr for t in half] + [
            t for out in (out_c, out_a) for t in out[4:]]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the eager launches before the capture set the kernels' attributes
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for p in (0, 1, 0, 1):
        phase.fill_(p)
        graph.replay()
        want = step()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), p


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("batch", [1, 7, 128])
def test_fxp_mlp_fwd_device_phase_matches_host_phase(dev, batch, quant):
    """Kernel B reading the phase from a device int32 gives bitwise what the
    host-phase instance gives."""
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda

    gen = torch.Generator().manual_seed(batch)
    dims, acts = NETS[1]
    ws, bs = _net(gen, dev, dims)
    deltas, zs = _site_operands(dev, len(ws))
    x = _rand(gen, batch, dims[0], scale=2).to(dev)
    kw = dict(activations=acts, qat=True, n_bits=16, fxp32_phase1=True)
    want = fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, quant=quant, **kw)
    phase = torch.full((1,), int(quant), dtype=torch.int32, device=dev)
    got = fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, quant=not quant, phase=phase, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bitwise(a, b) -> bool:
    """Equal bit patterns, a NaN matching any NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("ranges", [(-3.0, 3.5), (float("inf"), float("-inf"))], ids=["captured", "empty"])
@pytest.mark.parametrize("phase", [False, True])
@pytest.mark.parametrize("shape", [(64,), (7, 33), (3, 5, 17), (1, 1), (512, 400), (1000003,)])
def test_monitor_quant_kernel_matches_plain_bitwise_and_repeats(dev, shape, phase, ranges):
    """Kernel 6 against its plain version: y and both extrema bitwise, in
    both phases, N a multiple of the block and not; two calls bitwise."""
    from repro_torch.kernels.quantize import monitor_quant, ref_monitor_quant
    from repro_torch.kernels.quantize.kernel import monitor_quant_cuda

    gen = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(*shape, generator=gen) * 4).to(dev)
    before = monitor_quant_cuda.launches
    got = monitor_quant(x, *ranges, phase)
    again = monitor_quant(x, *ranges, phase)
    want = ref_monitor_quant(x, *ranges, phase)
    torch.cuda.synchronize()
    assert monitor_quant_cuda.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert _bitwise(g, w) and _bitwise(g, a)


@pytest.mark.parametrize("phase", [False, True])
def test_monitor_quant_kernel_propagates_nan(dev, phase):
    from repro_torch.kernels.quantize import monitor_quant, ref_monitor_quant

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(70001, generator=gen).to(dev)
    x[12345] = float("nan")
    phase_t = torch.tensor(phase, device=dev)
    got = monitor_quant(x, torch.tensor(-3.0, device=dev), torch.tensor(3.5, device=dev), phase_t)
    want = ref_monitor_quant(x, -3.0, 3.5, phase)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _bitwise(g, w)
    assert bool(got[1].isnan()) != phase and bool(got[2].isnan()) != phase


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("phase", [False, True])
def test_monitor_quant_kernel_takes_an_unaligned_view_bitwise(dev, phase, offset):
    """x[offset:] of a flat tensor (not 16-byte aligned: the scalar path),
    a NaN inside: bitwise the plain version's."""
    from repro_torch.kernels.quantize import monitor_quant, ref_monitor_quant

    gen = torch.Generator().manual_seed(11 + offset)
    x = (torch.randn(204801, generator=gen) * 4).to(dev)[offset:]
    x[999] = float("nan")
    assert x.data_ptr() % 16 != 0
    got = monitor_quant(x, -3.0, 3.5, phase)
    want = ref_monitor_quant(x, -3.0, 3.5, phase)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _bitwise(g, w)


def test_monitor_quant_kernel_is_one_cuda_launch_and_replays_in_a_graph(dev):
    """One CUDA launch a call (a profiler trace), and a captured call's
    replays across new inputs and a phase flip bitwise the eager call's
    (`chip_smoke._mq_cuda_launches`, `_mq_graph_replays`)."""
    smoke = _smoke()
    assert smoke._mq_cuda_launches(dev) == 1
    assert smoke._mq_graph_replays(torch.Generator().manual_seed(7), dev) == 4


# --------------------------------------------------------------------------
# kernels A and B on their launch plans' edges: split-K clusters, cluster
# widths, row blocks; two calls bitwise equal; kernel B inside a CUDA graph
# --------------------------------------------------------------------------


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("shape", [(9, 400, 300), (16, 17, 400), (17, 300, 6), (511, 400, 300), (1, 300, 6),
                                   (120, 301, 70), (121, 257, 300), (33, 400, 300), (512, 301, 70)])
def test_fxp_dense_kernel_plan_edges_repeat_bitwise(dev, shape, full):
    """Kernel A where its plan changes body, tile or split (K no multiple of
    the split, N no multiple of 4): within the contract, two calls bitwise
    equal (the split-K sum is a fixed-order cluster reduction)."""
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.fxp_matmul.ref import ref_fxp_dense

    gen = torch.Generator().manual_seed(sum(shape) + full)
    m, k, n = shape
    x, w, b = _rand(gen, m, k, scale=2).to(dev), _rand(gen, k, n, scale=k**-0.5).to(dev), _rand(gen, n).to(dev)
    got = fxp_dense_cuda(x, w, b, full_precision=full, activation="relu")
    again = fxp_dense_cuda(x, w, b, full_precision=full, activation="relu")
    want = ref_fxp_dense(x, w, b, full_precision=full, activation="relu")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("case", ["off", "monitor", "quant"])
@pytest.mark.parametrize("batch", [9, 16, 17, 120, 121, 511])
@pytest.mark.parametrize("net", NETS, ids=["tiny", "actor", "critic"])
def test_fxp_mlp_fwd_kernel_plan_edges_repeat_bitwise(dev, net, batch, case):
    """Kernel B across its row-block and cluster-width edges (one wave of
    clusters of 8 up to 120 rows, clusters of 4 beyond): y and extrema
    against the plain version, as many monitor rows as `monitor_rows`
    says, two calls bitwise equal."""
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda, monitor_rows
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward

    dims, acts = net
    gen = torch.Generator().manual_seed(batch + 7 * len(dims))
    ws, bs = _net(gen, dev, dims)
    x = _rand(gen, batch, dims[0], scale=3).to(dev)
    deltas, zs = _site_operands(dev, len(ws))
    qat, quant = case != "off", case == "quant"
    kw = dict(activations=acts, quant=quant, qat=qat, n_bits=16, fxp32_phase1=True)
    d, z = (deltas, zs) if qat else (None, None)
    got = fxp_mlp_fwd_cuda(x, ws, bs, d, z, **kw)
    again = fxp_mlp_fwd_cuda(x, ws, bs, d, z, **kw)
    y_ref, mins_ref, maxs_ref = ref_mlp_forward(x, ws, bs, deltas, zs, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    y, bmins, bmaxs = got
    assert bmins.shape == (monitor_rows(batch, dims), len(ws))
    torch.testing.assert_close(y, y_ref, **(dict(rtol=1e-3, atol=1e-3) if quant else TOL))
    torch.testing.assert_close(bmins.amin(0), mins_ref, **TOL)
    torch.testing.assert_close(bmaxs.amax(0), maxs_ref, **TOL)
    assert float(bmins.amin(0)[0]) == float(x.min()) and float(bmaxs.amax(0)[0]) == float(x.max())


@pytest.mark.parametrize("net", NETS[1:], ids=["actor", "critic"])
def test_fxp_mlp_fwd_device_phase_graph_replays_across_a_phase_flip(dev, net):
    """Kernel B's device-phase instance captured in a CUDA graph (a cluster
    launch) and replayed with the phase flipped between replays: each replay
    bitwise the host-phase instance of that phase."""
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda

    dims, acts = net
    gen = torch.Generator().manual_seed(11)
    ws, bs = _net(gen, dev, dims)
    deltas, zs = _site_operands(dev, len(ws))
    x = _rand(gen, 1, dims[0], scale=2).to(dev)
    phase = torch.zeros((1,), dtype=torch.int32, device=dev)
    kw = dict(activations=acts, qat=True, n_bits=16, fxp32_phase1=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the eager launch before the capture sets the kernel's attributes
        fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, quant=False, phase=phase, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, quant=False, phase=phase, **kw)
    for p in (0, 1, 0, 1):
        phase.fill_(p)
        graph.replay()
        want = fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, quant=bool(p), **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), p
