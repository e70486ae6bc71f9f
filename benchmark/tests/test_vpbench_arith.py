"""The benchmark's arithmetic: FLOP counts, bounds, percentiles, the
closed loop's window, the live schedule and the clip cycle."""

import math
import statistics

import numpy as np
import pytest

from benchmark import flops, stats
from benchmark.traffic import clips, sessions


@pytest.mark.parametrize("ngf,batch,size", [(64, 32, 512), (64, 16, 512),
                                            (8, 2, 256)])
def test_generator_flops_match_layer_count(ngf, batch, size):
    assert flops.generator_flops(ngf, batch, size) == pytest.approx(
        flops.generator_layer_flops(ngf, batch, size), rel=0, abs=0)


def test_generator_flops_per_frame_at_512():
    # 35.8 GFLOP a frame: 2 x MACs of the 16 convs and deconvs of G
    per_frame = flops.generator_flops(64, 1, 512)
    assert per_frame == 35_769_024_512


def test_train_step_counts_forward_and_backward():
    # a step runs G once forward and once backward (about twice the
    # forward), so it counts more than three G forwards at its batch
    step = flops.train_step_flops(8, 8, 2, 256)
    assert step > 3 * flops.generator_flops(8, 2, 256)


def test_percentile_interpolates_like_numpy():
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (0, 25, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_closed_window_ends_with_first_call_past_the_mark():
    ends = [100.4, 101.1, 102.3, 103.0]
    assert stats.closed_window(100.0, ends, 2.0) == (3, pytest.approx(2.3))
    assert stats.closed_window(100.0, ends, 3.0) == (4, pytest.approx(3.0))
    assert stats.closed_window(100.0, ends, 5.0) is None


def test_spread_and_bound_on_a_fixed_case():
    runs = [200.0, 202.0, 198.0, 201.0, 199.0, 204.0]
    q1, _, q3 = statistics.quantiles(runs, n=4)
    assert stats.spread(runs) == pytest.approx((q3 - q1) / 200.5)
    assert stats.bound([0.004, 0.006]) == pytest.approx(0.03)
    assert stats.bound([0.0005]) == 0.01          # never under 1%
    assert stats.bound([0.2]) == 0.25             # never over 25%


def test_session_due_times():
    due = sessions.due_times(3, 0.6, 0.2, 1.0, seed=5)
    offs = sorted(sessions.offsets(3, 0.6, 5))
    assert offs == pytest.approx([0.1, 0.3, 0.5])
    # the same offsets for every seed, in another order
    assert sorted(sessions.offsets(3, 0.6, 6)) == pytest.approx(offs)
    assert [d for d, _, _ in due] == sorted(d for d, _, _ in due)
    assert all(d < 1.0 for d, _, _ in due)
    for s in range(3):
        mine = [(d, j) for d, ss, j in due if ss == s]
        assert [j for _, j in mine] == list(range(len(mine)))
        assert all(math.isclose(b - a, 0.2) for (a, _), (b, _) in
                   zip(mine, mine[1:]))
    assert len(due) == 12        # 5 + 4 + 3 feeds before 1 s


def test_clip_cycle_for_a_seed():
    spec = {"count": 12, "min_frames": 50, "max_frames": 400}
    a = clips.cycle_frames(spec, 2 ** 31 + 11)
    b = clips.cycle_frames(spec, 2 ** 31 + 12)
    assert sorted(a) == sorted(b)                 # the same set of sizes
    assert a == clips.cycle_frames(spec, 2 ** 31 + 11)
    assert sorted(a) == [55, 65, 77, 92, 109, 130, 154, 183, 218, 259, 308,
                         367]
    pcm = clips.cycle(dict(spec, count=2, min_frames=50, max_frames=60), 3)
    frames = clips.cycle_frames(dict(spec, count=2, min_frames=50,
                                     max_frames=60), 3)
    for p, t in zip(pcm, frames):
        assert int(1 + p.shape[0] / 640) == t
        assert p.dtype == np.float32 and np.abs(p).max() <= 0.3 + 1e-6
