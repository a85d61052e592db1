"""The LM step's frozen operation and byte counts (`bench/lm_counts.py`)
against hand counts at the shapes of `lm_train.moonlight.s8k.quant`:
2 × 8,192 tokens, d 2,048, 16 heads of qk 128 + 64 and v 128, latent 512,
one dense layer of width 11,264 and 12 MoE layers (router 64, 2 shared
experts of 1,408, 8 held experts of 1,408), a head over 20,480 ids."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from bench import lm_counts

ROWS = 16_384 * 6 // 64 * 8 * 12  # the held experts' rows a step at an even load: 1,536 an expert a layer


def _cell():
    return (json.loads((ROOT / "bench" / "configs" / "moonlight_16b_a3b.json").read_text()),
            json.loads((ROOT / "bench" / "traffic" / "lm8k.quant.json").read_text()))


def test_step_operations_hand_count():
    # per token: W_q 2,048·16·192 = 6,291,456; W_kv_a 2,048·576 = 1,179,648; W_kv_b 512·16·256 = 2,097,152;
    # W_o 16·128·2,048 = 4,194,304: 13,762,560 a layer, 13 layers.  The dense SwiGLU 3·2,048·11,264 =
    # 69,206,016; a MoE layer's router 2,048·64 = 131,072 and shared SwiGLU 3·2,048·2,816 = 17,301,504,
    # 12 layers; the head 2,048·20,480 = 41,943,040.  499,253,248 MACs a token.
    per_token = 13 * 13_762_560 + 69_206_016 + 12 * (131_072 + 17_301_504) + 41_943_040
    assert per_token == 499_253_248
    # causal attention: 2·16·8,192²/2 score and value MACs of width 192 + 128, 13 layers
    attention = 13 * 2 * 16 * 33_554_432 * 320
    assert attention == 4_466_765_987_840
    experts = 3 * ROWS * 2_048 * 1_408  # gate, up and down over the rows held
    assert experts == 1_275_605_286_912
    c = lm_counts.step_counts(*_cell(), ROWS)
    assert c["step_ops"] == 6 * (16_384 * per_token + attention + experts) == 83_532_818_939_904
    assert c["tokens"] == 16_384
    assert round(c["step_ops"] / c["tokens"] / 1e9, 2) == 5.10  # GFLOP a trained token


def test_attention_counts_and_bound():
    c = lm_counts.step_counts(*_cell(), ROWS)
    assert c["attn_ops"] == 6 * 4_466_765_987_840
    # a layer: forward q, k, v read, o written (bf16) and the float32 log-sum-exp 4·2·16·8,192;
    # backward q, k, v, o, dO and the log-sum-exp read, dq, dk, dv written
    lse = 4 * 2 * 16 * 8_192
    fwd = 2 * 16_384 * 16 * (2 * 192 + 2 * 128) + lse
    bwd = 2 * 16_384 * 16 * (2 * 192 + 3 * 128) + lse + 2 * 16_384 * 16 * (2 * 192 + 128)
    assert c["attn_bytes"] == 13 * (fwd + bwd) == 13_113_491_456
    assert c["attn_bound_s"] == pytest.approx(c["attn_ops"] / 989.4e12)  # bound by its operations


def test_expert_counts_follow_the_rows_held():
    c = lm_counts.step_counts(*_cell(), ROWS)
    assert c["experts_ops"] == 6 * 1_275_605_286_912
    # 8 experts' three (2,048 × 1,408) weights read twice and their gradients written once in 12
    # layers; each row's input and output in the forward, three row vectors in the backward
    weights = 3 * 8 * 2_048 * 1_408
    assert c["experts_bytes"] == 2 * (3 * weights * 12 + 5 * ROWS * 2_048) == 8_002_732_032
    assert c["experts_bound_s"] == pytest.approx(c["experts_ops"] / 989.4e12)
    half = lm_counts.step_counts(*_cell(), ROWS / 2)
    assert half["experts_ops"] == c["experts_ops"] / 2
    assert half["attn_ops"] == c["attn_ops"]


def test_peaks_are_the_h100_data_sheet():
    assert lm_counts.PEAKS["bf16_flops"] == 989.4e12
    assert lm_counts.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert lm_counts.PEAKS["power_limit_w"] == 700.0
