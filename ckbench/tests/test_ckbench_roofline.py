"""The yardstick: the frozen bound functions give the port's recorded bounds
at paper shape (2,560 beam rows of 512 images, captions of 8-22 words:
15 attendable positions an image on average), and the model FLOPs of a
caption follow from the widths."""

import pytest

from ckbench import archs, roofline

PAPER = dict(E=1024, H=1024, A=512, F=2048, R=36, T=22)
N, B = 2560, 512


@pytest.mark.parametrize("name,ms,by", [
    ("att_cell", 0.0706, "operations"),
    ("lang_cell", 0.1249, "operations"),
    ("dcnet_cell", 0.0706, "operations"),
    ("dcnet_score", 0.00585, "bytes"),
])
def test_cell_bounds_at_paper_shape(name, ms, by):
    b = roofline.cell_bound(name, N, B, t_valid=B * 15, **PAPER)
    assert b["bound_ms"] == pytest.approx(ms, rel=3e-3)
    assert b["bound_by"] == by


@pytest.mark.parametrize("kw,ms", [
    (dict(), 0.0503), (dict(int8=True), 0.0251), (dict(fp32=True), 0.743)])
def test_head_bound_at_paper_shape(kw, ms):
    b = roofline.head_bound(N, 1024, 9490, 5, **kw)
    assert b["bound_ms"] == pytest.approx(ms, rel=3e-3)


@pytest.mark.parametrize("fn,args,ms", [
    (roofline.lstm_bound, (512, 2048, 1024, False), 0.0130),
    (roofline.lstm_bound, (512, 3072, 1024, True), 0.0228),
    (roofline.wholestep_bound, (N, 1024, 2048, 9490, 5), 0.1752),
])
def test_other_bounds_at_paper_shape(fn, args, ms):
    assert fn(*args)["bound_ms"] == pytest.approx(ms, rel=3e-3)


def test_roofline_leaves_out_the_unpublished_tanh_peak():
    b = roofline.score_stage_bound(N, B, 512, [(36, B * 36, False),
                                               (22, B * 15, True)])
    assert b["bound_unit"] == "special-function unit"
    assert b["roofline_unit"] in roofline.BOUND_UNITS
    assert b["roofline_ms"] < b["bound_ms"]


def test_caption_flops_match_the_kernel_bounds():
    """EditNet: 22 steps of the att_cell, lang_cell and head products at
    2,560 rows (PERF's 69.8 + 123.5 + 49.8 GFLOP a 512-image step) are
    10.45 GFLOP a caption before the encode and the attention reads;
    DCNet's step is about half."""
    m = dict(emb_dim=1024, hidden_dim=1024, att_dim=512, feat_dim=2048,
             num_regions=36, vocab_size=9490)
    editnet, dcnet = archs.get("editnet"), archs.get("dcnet")
    ed = editnet.caption_flops(m, beam=5, steps=22, t=22)
    dc = dcnet.caption_flops(m, beam=5, steps=22, t=22)
    assert 10.45e9 < ed < 11.2e9
    assert 5.2e9 < dc < 5.8e9
    step = editnet.step_flops(m, 22)
    assert step * 22 * N == pytest.approx(22 * (69.8 + 123.5 + 49.8) * 1e9,
                                          rel=0.02)
