"""The trace reader on a made-up trace: each device operation lands in the
step and call that launched it, busy time is the union, idle gaps are named
by the host range open when they begin."""

import dataclasses
from types import SimpleNamespace

from harness import readers, trace


@dataclasses.dataclass
class Ev:
    n: str
    kind: str
    a: int
    b: int

    def name(self):
        return self.n

    def device_type(self):
        return "DeviceType.CPU" if self.kind == "host" else "DeviceType.CUDA"

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a


def made_up():
    host = [Ev("submit", "host", 0, 10),
            Ev("step with prefill", "host", 20, 200),
            Ev("prefill call", "host", 25, 40),
            Ev("decode call", "host", 120, 130),
            Ev("collect", "host", 200, 205),
            Ev("decode-only step", "host", 210, 300),
            Ev("decode call", "host", 215, 220),
            Ev("aten::add", "host", 30, 31)]
    dev = [Ev("w4a4_mma_kernel<64>", "kernel", 45, 80),
           Ev("flash_prefill_kernel", "kernel", 70, 100),
           Ev("Memcpy DtoH", "gpu_memcpy", 100, 110),
           Ev("w4a4_mma_kernel<8>", "kernel", 135, 150),
           Ev("paged_decode_kernel", "kernel", 150, 160),
           Ev("w4a4_mma_kernel<8>", "kernel", 225, 240),
           Ev("paged_decode_kernel", "kernel", 260, 270)]
    recs = [SimpleNamespace(prefills=[30], decode_rows=2, decode_ctx=80,
                            has_prefill=True),
            SimpleNamespace(prefills=[], decode_rows=3, decode_ctx=90,
                            has_prefill=False)]
    return trace.read(host + dev, recs), recs


def test_ops_land_in_their_step_and_call():
    tr, recs = made_up()
    assert (tr.start, tr.end) == (20, 300)
    where = [(op.name[:6], op.step, op.call) for op in tr.ops]
    assert where == [("w4a4_m", 0, 0), ("flash_", 0, 0), ("Memcpy", 0, 0),
                     ("w4a4_m", 0, 1), ("paged_", 0, 1), ("w4a4_m", 1, 0),
                     ("paged_", 1, 0)]
    assert tr.steps[1].record is recs[1]


def test_busy_idle_and_names():
    tr, _ = made_up()
    # union: 45-110, 135-160, 225-240, 260-270
    assert tr.busy_s == (65 + 25 + 15 + 10) / 1e9
    assert tr.window_s == 280 / 1e9
    assert trace.top_gaps(tr, 10) == [
        ["step with prefill", 65 / 1e9], ["decode-only step", 30 / 1e9],
        ["step with prefill", 25 / 1e9], ["step with prefill", 25 / 1e9],
        ["decode-only step", 20 / 1e9]]
    assert tr.host_at(122) == "decode call" and tr.host_at(5) == "submit"
    assert tr.host_at(207) == "harness loop"
    top = trace.top_ops(tr, 2)
    assert top[0] == ["w4a4_mma_kernel<64>", 35 / 1e9]


def test_calls_give_each_prefill_its_size():
    tr, _ = made_up()
    ctx = SimpleNamespace(trace=tr)
    pre = list(readers.prefill_calls(ctx))
    assert [(n, ns) for n, ns, _ in pre] == [(30, 95)]
    assert readers.device_s(pre[0][2], "flash_prefill") == 30 / 1e9
    dec = list(readers.decode_calls(ctx))
    assert [(r, c) for r, c, _, _ in dec] == [(2, 80), (3, 90)]
    assert readers.device_s(dec[1][3], "w4a4") == 15 / 1e9


def test_mismatched_steps_read_nothing():
    host = [Ev("decode-only step", "host", 0, 10)]
    assert trace.read(host, []) is None
