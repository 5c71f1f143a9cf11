"""The scripted continuous-serving stream, shared by
``tests/test_torch_continuous_serving.py`` and ``chip_smoke.py`` phase 5d
(b).  It imports numpy only, so the smoke script can use it without the
JAX package.

A stream's policy decisions depend on the clock and on the measured wave
walls, and measured walls never agree between two programs or two
devices.  So both are scripted: a :class:`FakeClock` per server, and each
engine's ``finish_wave`` wrapped (:func:`script_walls`) to overwrite the
wave's launch-to-ready wall with a value per bucket and advance the clock
by it.  Two servers fed the same stream (:func:`stream`) then make the
same decisions at the same times.
"""
import numpy as np

N_STREAM = 18                     # requests of the scripted stream
STREAM_SIZES, STREAM_SEED = (20, 40, 100), 21     # random_requests'
# the server knobs of the scripted stream, and its three shed policies
SERVER_KW = dict(cold_start_wall=0.004, max_wait=0.05, batch_patience=1.5)
POLICIES = {"never": dict(shed="never", pressure_threshold=0.01),
            "predicted-miss": dict(shed="predicted-miss",
                                   pressure_threshold=0.02),
            "capacity": dict(shed="capacity", max_pending=3)}


class FakeClock:
    """Deterministic monotonic clock; tests advance it explicitly."""

    def __init__(self, t: float = 0.0, jitter_rng=None,
                 jitter: float = 0.0):
        self.t = t
        self.jitter_rng = jitter_rng
        self.jitter = jitter

    def __call__(self) -> float:
        if self.jitter_rng is not None and self.jitter > 0.0:
            # monotonic jitter: every read advances by a random hair
            self.t += float(self.jitter_rng.random()) * self.jitter
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def stream_clock() -> FakeClock:
    """The scripted stream's clock: every read advances by a hair drawn
    from seed 9, so two servers' clock reads must line up."""
    return FakeClock(jitter_rng=np.random.default_rng(9), jitter=1e-4)


def script_walls(eng, clk) -> None:
    """Overwrite each finished wave's launch-to-ready wall (in the
    engine's bucket, wave and group-size records) with a scripted one (per
    bucket, cycling over three values) and advance the clock by it, so servers on different engines see the same walls and the same
    time.  ``del eng.finish_wave`` takes the wrapper off."""
    real = eng.finish_wave
    count = {}

    def finish_wave(inflight):
        out = real(inflight)
        k = count[inflight.bucket] = count.get(inflight.bucket, -1) + 1
        wall = inflight.bucket * 1.25e-4 * (1.0 + 0.25 * (k % 3))
        eng.bucket_walls[inflight.bucket][-1] = wall
        eng.wave_walls[-1] = wall
        eng.group_walls[inflight.pending.lanes][-1] = wall
        clk.advance(wall)
        return out

    eng.finish_wave = finish_wave


def stream(srv, clk, reqs, rng):
    """Submit ``reqs`` with drawn deadlines, classes and gaps, polling in
    between, then drain; returns (tickets, results)."""
    tickets, done = [], []
    for r in reqs:
        u = rng.random()
        deadline = (None if u < 0.2 else clk.t + float(rng.uniform(0.0, 0.02))
                    if u < 0.55 else clk.t + float(rng.uniform(0.02, 0.3)))
        tickets.append(srv.submit(r, deadline=deadline,
                                  priority=int(rng.integers(0, 3)),
                                  tenant=str(rng.integers(0, 2))))
        if rng.random() < 0.5:
            clk.advance(float(rng.uniform(0.0, 0.006)))
            done += srv.poll()
    clk.advance(0.002)
    done += srv.poll()
    return tickets, done + srv.drain()
