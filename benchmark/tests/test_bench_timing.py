"""The window's arithmetic on synthetic stamps and intervals."""

import statistics

import numpy as np
import pytest

import timing


def steady(n=100, dt=0.010, t0=5.0):
    return t0, [t0 + dt * (i + 1) for i in range(n)]


def device_tail(t0, stamps):
    """The device tail of frames that end on the device at the stamps."""
    return timing.frame_device_p95_ms(
        timing.frame_intervals(t0, stamps) * 1e3)


def test_steady_window():
    t0, stamps = steady()
    assert timing.frame_ms(t0, stamps) == pytest.approx(10.0)
    assert device_tail(t0, stamps) == pytest.approx(10.0)


def test_one_stall_moves_the_frame_time_and_the_tail():
    t0, stamps = steady(n=10)
    stalled = stamps[:5] + [s + 0.050 for s in stamps[5:]]
    assert timing.frame_ms(t0, stalled) == pytest.approx(15.0)
    # Nine 10 ms intervals and one of 60 ms: linear interpolation puts
    # the 95th percentile 55% of the way from 10 to 60.
    assert device_tail(t0, stalled) == pytest.approx(37.5)


def test_the_tail_is_over_every_interval_of_a_long_window():
    t0, stamps = steady(n=100)
    one = stamps[:50] + [s + 0.5 for s in stamps[50:]]
    assert timing.frame_ms(t0, one) == pytest.approx(15.0)
    assert device_tail(t0, one) == pytest.approx(10.0)
    six = list(stamps)
    for k in range(6):
        six = [s + (0.1 if i >= 15 * k + 10 else 0.0)
               for i, s in enumerate(six)]
    assert timing.frame_ms(t0, six) == pytest.approx(16.0)
    assert device_tail(t0, six) == pytest.approx(110.0)


def test_the_device_tail_of_a_single_frame_is_its_interval():
    assert timing.frame_device_p95_ms([6.2]) == pytest.approx(6.2)


def test_the_device_tail_of_a_short_window_interpolates():
    # Five intervals: the 95th percentile lies 80% of the way from the
    # fourth (sorted) to the fifth.
    assert timing.frame_device_p95_ms([6.0, 6.1, 6.0, 9.0, 6.2]) == \
        pytest.approx(6.2 + 0.8 * (9.0 - 6.2))


@pytest.mark.parametrize("intervals", [None, []])
def test_the_device_tail_reader_reads_nothing_without_device_stamps(
        intervals):
    import harness
    run = harness.Run("w", {}, {}, {}, 1.0, 0.0, [1.0], 2**30,
                      device_intervals=intervals)
    assert harness.load_reader("frame_device_p95_ms")(run) is None
    run.device_intervals = [6.0, 6.1, 6.2]
    assert harness.load_reader("frame_device_p95_ms")(run) == \
        pytest.approx(6.19)


def test_intervals_start_at_the_window():
    t0, stamps = 1.0, [1.5, 1.6]
    assert np.allclose(timing.frame_intervals(t0, stamps), [0.5, 0.1])


def test_busy_and_idle():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 6.5)]
    assert timing.busy_time(spans) == pytest.approx(3.5)
    assert timing.busy_intervals(spans) == [(0.0, 2.0), (3.0, 4.0),
                                            (6.0, 6.5)]
    assert timing.idle_gaps(spans) == [(2.0, 3.0), (4.0, 6.0)]
    # idle share of a stretch of 10 s: 100 (1 - 3.5 / 10)
    assert 100 * (1 - timing.busy_time(spans) / 10.0) == pytest.approx(65.0)


def test_spread_uses_statistics_quartiles():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert timing.spread(values) == pytest.approx(
        (q3 - q1) / statistics.median(values))


def test_idle_reader_on_a_trace():
    import harness
    trace = harness.Trace(frames=2, window_s=10.0, host=[], device=[
        ("k", 0.0, 1.0), ("k", 0.5, 2.0), ("copy", 3.0, 4.0)])
    run = harness.Run("w", {}, {}, {}, 1.0, 0.0, [1.0], 0, [0.002, 0.004],
                      trace)
    assert harness.load_reader("device.idle_pct")(run) == pytest.approx(70.0)
    assert harness.load_reader("frame_loop.launches")(run) == 1.5
    assert harness.load_reader("frame_loop.dispatch_ms")(run) == \
        pytest.approx(3.0)
    assert harness.load_reader("glue.device_ms")(run) == pytest.approx(1750.0)
