"""The port's synthetic LM stream (`repro_torch.data.synthetic`): the
reference's `tests/test_data.py` properties on the port, and the stream's
semantics (shifted labels, the n-gram backbone, decode shapes, the device
rule).  `jax.random` and `torch.Generator` never agree, so the port's draws
are its own: properties are held, not the reference's values.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.synthetic import DataConfig, DataIterator, make_batch  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

SHAPE = ShapeConfig("t", "train", 32, 4)


def _batch(arch, step=0, seed=0, shape=SHAPE):
    return make_batch(DataConfig(seed=seed), registry.get_smoke(arch), shape, step, device="cpu")


def test_deterministic_across_restart():
    a, b = _batch("qwen2_0_5b", 5, seed=1), _batch("qwen2_0_5b", 5, seed=1)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], _batch("qwen2_0_5b", 6, seed=1)["tokens"])
    assert not torch.equal(a["tokens"], _batch("qwen2_0_5b", 5, seed=2)["tokens"])


def test_labels_are_shifted_tokens():
    cfg = registry.get_smoke("qwen2_0_5b")
    b = _batch("qwen2_0_5b")
    assert b["labels"].shape == b["tokens"].shape == (4, 32)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < cfg.vocab_size
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_iterator_skip_to():
    cfg = registry.get_smoke("qwen2_0_5b")
    it = DataIterator(DataConfig(seed=2), cfg, SHAPE, device="cpu")
    batches = [next(it) for _ in range(4)]
    it2 = DataIterator(DataConfig(seed=2), cfg, SHAPE, device="cpu")
    it2.skip_to(3)
    assert torch.equal(next(it2)["tokens"], batches[3]["tokens"]) and it2.step == 4
    it3 = DataIterator(DataConfig(seed=2), cfg, SHAPE, start_step=2, device="cpu")
    assert torch.equal(next(it3)["tokens"], batches[2]["tokens"])


def test_vision_batch_masks_image_prefix():
    cfg = registry.get_smoke("phi3_vision_4_2b")
    b = _batch("phi3_vision_4_2b")
    assert b["frontend"].shape == (4, cfg.frontend_len, cfg.frontend_dim) and b["frontend"].dtype == torch.float32
    assert bool((b["labels"][:, :cfg.frontend_len] == -100).all())
    assert bool((b["labels"][:, cfg.frontend_len:] >= 0).all())


def test_audio_batch_has_masked_targets():
    cfg = registry.get_smoke("hubert_xlarge")
    b = _batch("hubert_xlarge", shape=ShapeConfig("t", "train", 256, 8))
    assert "tokens" not in b and b["frontend"].shape == (8, 256, cfg.frontend_dim)
    frac = float((b["labels"] >= 0).float().mean())
    assert 0.0 < frac < 0.3
    assert bool(((b["labels"] == -100) | ((b["labels"] >= 0) & (b["labels"] < cfg.vocab_size))).all())


def test_structure_repeats_every_period_and_decode_takes_one_token():
    """Every `structure_period`-th token repeats the one before it (the
    learnable n-gram backbone); decode shapes get the first token only."""
    cfg = registry.get_smoke("qwen2_0_5b")
    shape = ShapeConfig("t", "train", 64, 4)
    b = make_batch(DataConfig(seed=3), cfg, shape, 0, device="cpu")
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], 1)  # positions 0..S
    for p in range(8, 65, 8):
        assert torch.equal(toks[:, p], toks[:, p - 1])
    dec = make_batch(DataConfig(seed=3), cfg, ShapeConfig("d", "decode", 64, 4), 0, device="cpu")
    assert list(dec) == ["tokens"] and torch.equal(dec["tokens"], b["tokens"][:, :1])


def test_stream_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = registry.get_smoke("qwen2_0_5b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(DataConfig(), cfg, SHAPE, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataIterator(DataConfig(), cfg, SHAPE)
