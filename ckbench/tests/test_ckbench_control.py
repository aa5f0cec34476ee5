"""The comparison that decides ``correct`` fails what it must, at a size a
test run holds (the CPU, tiny widths, the kernels' plain versions): the
program's own int8 path (``--control int8``) and the float8 reference in
the program's place (``--control fp8``) come out not correct, and so does
each fault that a decode can have, planted underneath the timed path: a
step that returns its state unchanged, half of the batch left
undecoded, a token altered where the beam produces it; and so does a run
in which a number with a limit goes unread (the head's calls not caught).
The harness runs whole but for its look for a card. The limits are set
for these widths from the sound runs' readings (``TINY_LIMITS``); the
chip's are in the configuration files."""

import pytest

from ckbench import instrument, run, verify

TINY = {"model.vocab_size": 60, "model.emb_dim": 16,
        "model.hidden_dim": 16, "model.att_dim": 8, "model.feat_dim": 32,
        "model.num_regions": 4}
# sound runs here read score_err 1.2e-4 to 3.0e-4 and head_err 1.0e-4 to
# 1.6e-4; the int8 head 5e-4 and more, the float8 reference 1.3e-3 and more
TINY_LIMITS = {"limits.score_err": 8e-4, "limits.head_err": 4e-4}
TRAFFIC = ["--traffic-set", "images=40", "--traffic-set", "batch_size=16",
           "--traffic-set", "sample=24"]
CELLS = ["editnet_offline_b1024", "dcnet_offline_b1024"]


def _run(workload, *extra, seed=2147483999):
    return run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", "1", "--trace", "0", *TRAFFIC, *extra],
                    device="cpu", config_set={**TINY, **TINY_LIMITS})


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("control", ["int8", "fp8"])
@pytest.mark.parametrize("workload", CELLS)
def test_the_controls_are_not_correct(workload, control):
    result = _run(workload, "--control", control)
    assert not result["correct"], result["checks"]


def _beam_fault(monkeypatch, change):
    import captionkit_torch.decode.driver as driver

    beam = driver.beam_search

    def faulty(*args, **kw):
        out = beam(*args, **kw)
        return out._replace(tokens=change(out.tokens))

    monkeypatch.setattr(driver, "beam_search", faulty)


def _state_unchanged(monkeypatch):
    import captionkit_torch.models.dcnet as dcnet
    import captionkit_torch.models.editnet as editnet

    monkeypatch.setattr(editnet, "fused_step_hidden",
                        lambda pack, ha, ca, hl, cl, emb: (ha, ca, hl, cl))
    monkeypatch.setattr(dcnet, "dcnet_fused_step_hidden",
                        lambda pack, h, c, emb: (h, c))


def _half_left_out(monkeypatch):
    def change(t):  # the second half of the rows never decoded
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        return t

    _beam_fault(monkeypatch, change)


def _token_altered(monkeypatch):
    def change(t):
        t = t.clone()
        t[:, 3] = (t[:, 3] + 1) % TINY["model.vocab_size"]
        return t

    _beam_fault(monkeypatch, change)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "token_altered": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_planted_faults_are_not_correct(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["checks"]


def test_a_head_call_not_caught_is_not_correct(monkeypatch):
    # the head dispatch moved where the tap does not look: head_err goes
    # unread, and the run must not pass on the other numbers alone
    monkeypatch.setattr(instrument.HeadTap, "SITES", ())
    result = _run("editnet_offline_b1024")
    assert not result["correct"], result["checks"]
    assert result["checks"]["head_err"]["value"] is None


def test_a_limit_without_a_reading_fails_unless_absent():
    limits = {"topk_gap": 1.0, "head_err": 1.0}
    assert verify.verdict({"topk_gap": 0.5, "head_err": 0.5}, limits, 0)[0]
    ok, checks = verify.verdict({"topk_gap": 0.5}, limits, 0)
    assert not ok and checks["head_err"] == {"value": None, "limit": 1.0}
    assert verify.verdict({"topk_gap": 0.5}, limits, 0, ("head_err",))[0]
    assert not verify.verdict({"topk_gap": 0.5}, limits, 1, ("head_err",))[0]
