"""A whole run on the CPU at a tiny size, as in `test_bench_run.py`, with
the attention broken underneath the timed path: paged decode short of its
newest page, flash prefill short of the prompt's last page or at half its
softmax scale.  Each comes out not correct, through the layer that it
broke."""

import functools

import pytest

import control
from test_bench_run import CLOSED, LIMITS, OPEN, execute, tiny  # noqa: F401


@pytest.mark.parametrize("fault,number", [
    ("decode_page", "attn_decode_err"),
    ("prefill_page", "attn_prefill_row_err"),
    ("prefill_scale", "attn_prefill_err")])
@pytest.mark.parametrize("arch,mix", [("internlm2-20b", CLOSED),
                                      ("starcoder2-7b", OPEN)])
def test_broken_attention_is_not_correct(tiny, monkeypatch, arch, mix,
                                         fault, number):
    res = execute(tiny(arch), mix, fault=functools.partial(
        control.FAULTS[fault], patch=monkeypatch.setattr))
    assert not res["correct"]
    assert res["check"][number]["value"] > LIMITS[number]


class Captured:
    """Stands in for the card's `CapturedStep` (its step function under
    ``fn``), which the CPU engine does not wrap its steps in."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def test_the_taps_reach_the_step_under_a_capture_and_a_fault(tiny):
    def fault(engine):
        for name in ("_prefill", "_prefill_tail", "_decode"):
            setattr(engine, name, Captured(getattr(engine, name)))
        control.alter_tokens(engine)

    res = execute(tiny("internlm2-20b"), CLOSED, fault=fault)
    assert not res["correct"]
    # the eager step ran unaltered under both wrappers, every layer read
    assert res["check"]["replay_mismatch"]["value"] > 0
    assert res["check"]["attn_decode_err"]["value"] <= \
        LIMITS["attn_decode_err"]
