"""The frozen counts against hand counts at both configurations' shapes."""

import pytest

from harness import manifest
from reference.masters import dims
from roofline import counts

MAN = manifest.load()
INTERN = dims(manifest.as_run(manifest.config(MAN, "internlm2-20b")))
STAR = dims(manifest.as_run(manifest.config(MAN, "starcoder2-7b")))


def test_projection_shapes():
    assert counts.projections(INTERN) == [
        (6144, 6144), (6144, 1024), (6144, 1024), (6144, 6144),
        (6144, 16384), (6144, 16384), (16384, 6144)]
    assert counts.projections(STAR) == [
        (4608, 4608), (4608, 512), (4608, 512), (4608, 4608),
        (4608, 18432), (18432, 4608)]


@pytest.mark.parametrize("M,K,N", [(64, 6144, 16384), (1, 16384, 6144),
                                   (1024, 4608, 18432), (8, 4608, 512)])
def test_w4a4_gemm_by_hand(M, K, N):
    ops, byts = counts.w4a4_gemm(M, K, N)
    assert ops == 2 * M * K * N
    # bf16 rows in, int4 codes and f32 scales, bf16 rows out
    assert byts == 2 * M * K + K * N // 2 + 4 * N + 2 * M * N


def test_layer_bound_is_the_sum_of_call_bounds():
    t, ops = counts.layer_gemms(INTERN, 64)
    p = counts.PEAKS
    want = sum(max(2 * 64 * K * N / p["int8_op_per_s"],
                   (2 * 64 * K + K * N / 2 + 4 * N + 2 * 64 * N)
                   / p["hbm_byte_per_s"])
               for K, N in counts.projections(INTERN))
    assert t == pytest.approx(want)
    assert ops == 2 * 64 * sum(K * N for K, N in counts.projections(INTERN))
    # decode at 64 rows moves bytes: the weights' nibbles bound it
    assert t == pytest.approx(sum(
        (2 * 64 * K + K * N / 2 + 4 * N + 2 * 64 * N) / p["hbm_byte_per_s"]
        for K, N in counts.projections(INTERN)))


def test_paged_decode_by_hand():
    ops, byts = counts.paged_decode(STAR, rows=3, ctx_sum=300)
    # QK and PV: 2 flops a multiply-add, 36 heads of 128, 300 keys
    assert ops == 4 * 36 * 128 * 300
    # queries and outputs of 3 rows, every key and value of 4 KV heads once
    assert byts == 2 * 3 * 36 * 128 * 2 + 2 * 300 * 4 * 128 * 2
    assert counts.paged_decode(STAR, 3, 300, "int8")[1] == \
        2 * 3 * 36 * 128 * 2 + 2 * 300 * 4 * 128


def test_flash_prefill_by_hand():
    ops, byts = counts.flash_prefill(INTERN, 4)
    # causal: query i sees i + 1 keys, 1 + 2 + 3 + 4 pairs
    assert ops == 4 * 48 * 128 * 10
    assert byts == (2 * 4 * 48 * 128 + 2 * 4 * 8 * 128) * 2
    assert counts.flash_prefill(INTERN, 2, past=3)[0] == 4 * 48 * 128 * (6 + 3)


def test_step_at_peak():
    p = counts.PEAKS
    want = 48 * (2 * 5 * sum(K * N for K, N in counts.projections(INTERN))
                 / p["int8_op_per_s"]
                 + 4 * 48 * 128 * 700 / p["bf16_flop_per_s"]) \
        + 2 * 5 * 6144 * 92544 / p["bf16_flop_per_s"]
    assert counts.decode_step_at_peak(INTERN, 5, 700) == pytest.approx(want)
    assert counts.prefill_at_peak(STAR, 100) > counts.prefill_at_peak(STAR, 10)
