"""The frozen operation and byte counts and the card's peaks, against hand
counts at the paper's shapes."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from bench import yardstick


def _files(config: str, traffic: str) -> tuple[dict, dict]:
    return (json.loads((ROOT / "bench" / "configs" / f"{config}.json").read_text()),
            json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json").read_text()))


def test_update_halfcheetah_b128_hand_count():
    # per row: kernel 4's products 128,600 + 129,500 + 129,500 + 129,500 + 120,300,
    # kernel 5's 128,600 + 129,500 + 122,700 + 128,600 + 121,800; 23 operations
    # over the 129,306 + 130,201 parameters
    ops = yardstick.update_ops(17, 6, [400, 300], 128)
    assert ops == 2 * 128 * 1_268_600 + 23 * (129_306 + 130_201) == 330_730_261
    assert round(ops / 1e6, 1) == 330.7


def test_update_hopper_b512_hand_count():
    ops = yardstick.update_ops(11, 3, [400, 300], 512)
    assert ops == 2 * 512 * 1_242_200 + 23 * (126_003 + 126_601) == 1_277_822_692


def test_act_forward_at_4096_rows():
    assert yardstick.act_ops(17, 6, [400, 300], 4096) == 2 * 4096 * 128_600 == 1_053_491_200


def test_update_bytes_read_once_written_once():
    # params, two moments and targets of both nets, read and written; the batch read
    nbytes = yardstick.update_bytes(17, 6, [400, 300], 128)
    assert nbytes == 4 * 8 * (129_306 + 130_201) + 128 * (4 * (2 * 17 + 6 + 1) + 1)


@pytest.mark.parametrize("config, monitor, quant", [("fixar_hopper", "b512.monitor", "b512.quant")])
def test_phases_count_the_same_operations(config, monitor, quant):
    c, tm = _files(config, monitor)
    _, tq = _files(config, quant)
    assert tm["phase"] == "monitor" and tq["phase"] == "quant"
    assert yardstick.timestep(c, tm) == yardstick.timestep(c, tq)


def test_bounds_and_what_sets_them():
    c, t = _files("fixar_halfcheetah", "b128.quant")
    counts = yardstick.timestep(c, t)
    assert counts["update_bound_by"] == "operations"
    assert counts["update_bound_s"] == pytest.approx(330_730_261 / 67e12)
    assert counts["act_bound_by"] == "bytes"  # one row: the actor's weights dominate
    c, t = _files("fixar_halfcheetah", "fleet4096.monitor")
    assert yardstick.timestep(c, t)["act_bound_by"] == "operations"


def test_peaks_are_the_h100_data_sheet():
    assert yardstick.PEAKS["f32_flops"] == 67e12
    assert yardstick.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert yardstick.PEAKS["power_limit_w"] == 700.0
