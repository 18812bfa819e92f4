"""The port's ``FleetWatchdog`` (``repro_torch.runtime.straggler``) call for
call against the JAX package's, on the cases of ``tests/test_straggler.py``
(zero samples, a median of one, dead replicas left out of the median, a
reset on rejoin, an injected step delay) and on seeded random feeds: every
``record`` returns the same flag, and ``ema``, ``stragglers()`` (all
replicas and a live subset) and each feed's ``n`` and ``events`` agree
after every call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ServeConfig as JaxServe  # noqa: E402
from repro.launch.serve import build_engine as jax_build  # noqa: E402
from repro.runtime import straggler as JW  # noqa: E402
from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.runtime import straggler as TW  # noqa: E402

torch.set_num_threads(1)


class _Both:
    """One FleetWatchdog of each package, driven by the same calls."""

    def __init__(self, n, **kw):
        self.n = n
        self.j = JW.FleetWatchdog(n, **kw)
        self.t = TW.FleetWatchdog(n, **kw)

    def record(self, r, step, dt):
        want = self.j.record(r, step, dt)
        assert self.t.record(r, step, dt) == want
        self.check()
        return want

    def reset(self, r):
        self.j.reset(r)
        self.t.reset(r)
        self.check()

    def check(self, live=None):
        assert self.t.stragglers(live) == self.j.stragglers(live)
        for r in range(self.n):
            assert self.t.ema(r) == self.j.ema(r)
            assert self.t.feeds[r].n == self.j.feeds[r].n
            assert self.t.feeds[r].events == self.j.feeds[r].events
            assert self.t.feeds[r].deadline == self.j.feeds[r].deadline


def test_fleet_zero_samples_no_stragglers():
    b = _Both(3)
    b.check()
    assert b.t.stragglers() == [] and b.t.ema(0) == 0.0


def test_fleet_median_of_one_replica():
    b = _Both(1)
    for s in range(5):
        b.record(0, s, 1.0)
    assert b.t.stragglers() == []
    assert b.record(0, 5, 100.0)          # its own deadline blown
    assert b.t.stragglers() == [0]


def test_fleet_median_excludes_dead_replicas():
    b = _Both(3)
    for s in range(3):
        b.record(0, s, 1.0)
        b.record(1, s, 1.0)
        b.record(2, s, 10.0)
    assert b.t.stragglers() == [2]
    b.check(live=[2])
    assert b.t.stragglers(live=[2]) == []


def test_fleet_reset_discards_stale_ema_on_rejoin():
    b = _Both(2)
    for s in range(4):
        b.record(0, s, 1.0)
        b.record(1, s, 10.0)
    assert b.t.ema(1) > 5.0
    b.reset(1)
    assert b.t.ema(1) == 0.0 and b.t.feeds[1].n == 0
    assert not b.record(1, 5, 1.0)
    assert b.t.ema(1) == 1.0


@pytest.mark.parametrize("seed", range(4))
def test_fleet_watchdog_seeded_feeds(seed):
    """Random step times with spikes, resets and live subsets: the two
    watchdogs agree after every call."""
    rng = np.random.RandomState(seed)
    n = 2 + seed % 3
    b = _Both(n, factor=2.0 + seed * 0.5, ema_decay=0.8)
    for step in range(60):
        r = int(rng.randint(n))
        dt = float(rng.lognormal(-3.0, 0.3))
        if rng.rand() < 0.15:
            dt *= float(rng.uniform(3, 40))    # a straggling turn
        b.record(r, step, dt)
        if rng.rand() < 0.05:
            b.reset(int(rng.randint(n)))
        live = sorted(set(rng.randint(n, size=int(rng.randint(1, n + 1)))))
        b.check(live=[int(x) for x in live])


def test_fleet_ema_under_injected_delay():
    """The engines add an injected delay to their recorded step time; both
    watchdogs see the inflated samples and flag the same replica."""
    kw = dict(max_batch=2, prefill_batch=1, bucket_edges=(8,),
              max_new_tokens=2)
    jeng = jax_build("tinyllama-1.1b", reduced=True, mesh_shape=(2, 2),
                     serve=JaxServe(**kw))
    teng = build_engine("tinyllama-1.1b", reduced=True, mesh_shape=(2, 2),
                        serve=ServeConfig(**kw), device="cpu")
    for eng in (jeng, teng):
        eng.submit(tuple(range(1, 6)))
        eng.step()
        eng.inject_step_delay(30.0)
        eng.step()
        assert eng.step_times[-1] >= 30.0
    # the same samples into both feeds: the port engine's times
    b = _Both(3)
    b.record(0, 0, teng.step_times[-2])
    b.record(1, 0, teng.step_times[-1])
    b.record(2, 0, teng.step_times[-2])
    assert b.t.ema(1) >= 30.0
    assert b.t.stragglers() == [1]
    assert teng.step_kinds == jeng.step_kinds


def test_step_timer_measures_elapsed():
    with TW.StepTimer() as t:
        sum(range(1000))
    assert t.dt >= 0.0
