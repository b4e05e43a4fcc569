"""devtrace's reading of a trace, on events made by hand."""

import pytest

from devtrace import Event, Trace


def _trace():
    device = [Event("gram_bf16_wgmma_kernel", 1.0, 2.0),
              Event("sum_chunks_kernel", 2.0, 2.5),
              Event("rhs_bf16_wgmma_kernel", 2.25, 3.0),
              Event("sum_chunks_kernel", 3.0, 3.25),
              Event("Memcpy HtoD", 6.0, 7.0)]
    host = [Event("span.ingest", 0.0, 1.0), Event("span.engine", 1.0, 9.0),
            Event("aten::copy_", 4.0, 5.5)]
    return Trace(device, host, 0.0, 10.0)


def test_busy_is_the_union():
    t = _trace()
    # [1, 3.25) and [6, 7): 3.25 s of 10
    assert t.busy_s() == pytest.approx(3.25)
    assert t.window_s == 10.0


def test_helpers_count_with_the_kernel_before_them():
    t = _trace()
    assert t.seconds(("gram_",)) == pytest.approx(1.5)
    assert t.seconds(("rhs_",)) == pytest.approx(1.0)
    assert t.seconds(("bucket_cg",)) == 0.0


def test_breakdown():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["gram_bf16_wgmma_kernel", 1.0]
    gaps = dict(b["idle_gaps"])
    # [0, 1) in ingest; [3.25, 6) mid 4.625 in copy_; [7, 10) mid 8.5 in
    # the engine's span
    assert gaps == pytest.approx({"span.ingest": 1.0, "aten::copy_": 2.75,
                                  "span.engine": 3.0})
