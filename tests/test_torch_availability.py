"""The port's availability models, traces and dispatch simulator
(``repro_torch.core.availability``) against the JAX package's, on the CPU.

Fates are pure functions of (seed, client, k) and the simulator is
numpy and ``heapq``, so the two packages must agree exactly: the same
floats (compared with ``==``) and the same event order.

  * every built-in's ``fate``, ``available`` and ``next_available`` over a
    seeded grid of (client, k, t), with dropout and duty cycles;
  * 200 ``fill``/``pop`` events of the simulator under stragglers with
    dropout and under duty-cycle windows (the ``advance_to_available``
    path), from samplers on the same seed;
  * a trace recorded by either package replays in the other, and its JSON
    is the same text;
  * ``ClientSampler.sample_available`` over the whole population draws
    exactly as ``sample()``; a partial pool draws as the reference's; an
    empty pool consumes nothing;
  * the simulator's ``restore`` resumes the same events.
"""
import numpy as np
import pytest

from repro.core import availability as J
from repro.core.sampling import ClientSampler as JSampler
from repro_torch.core import availability as T
from repro_torch.core.sampling import ClientSampler as TSampler

N = 30
# (name, kwargs): every built-in but trace, with dropout, a heavy tail and
# duty-cycle windows among them
MODELS = [
    ("always_on", {}),
    ("uniform", dict(seed=2, lo=0.25, hi=2.0, dropout=0.1)),
    ("uniform", dict(seed=5, duty=0.4, period=8.0)),
    ("lognormal", dict(seed=1, sigma=1.5, dropout=0.2)),
    ("lognormal", dict(seed=3, median=2.0, sigma=0.5, client_sigma=1.0,
                       duty=0.6, period=5.0, dropout=0.05)),
]
IDS = [f"{name}-{i}" for i, (name, _) in enumerate(MODELS)]


def _builtin_names(mod):
    """The names ``mod`` registers at import: those whose factory is
    defined in ``mod`` itself. A test of the JAX package registers
    ``"_test_avail"`` in the reference's live registry at run time
    (``tests/test_availability.py``), which a worker that runs both files
    still holds here."""
    return tuple(n for n in mod.availability_names()
                 if mod._AVAILABILITY[n].__module__ == mod.__name__)


def test_registry_names_match():
    builtin = _builtin_names(J)
    assert builtin == ("always_on", "lognormal", "trace", "uniform")
    assert T.availability_names() == _builtin_names(T) == builtin
    with pytest.raises(KeyError, match="unknown availability model"):
        T.make_availability("psychic")


@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_fates_and_windows_are_the_reference(name, kw):
    tm, jm = T.make_availability(name, **kw), J.make_availability(name, **kw)
    for client in range(N):
        for k in range(6):
            assert tm.fate(client, k) == jm.fate(client, k), (client, k)
    ids = np.arange(N)
    for t in np.linspace(0.0, 40.0, 57):
        got, want = tm.available(ids, t), jm.available(ids, t)
        assert got.dtype == want.dtype and np.array_equal(got, want), t
        for sub in (ids, ids[::7], ids[3:4], ids[:0]):
            assert tm.next_available(sub, t) == jm.next_available(sub, t)


def _events(mod, model_kw, max_inflight, n_events=200, seed=4):
    """The simulator's first ``n_events`` events: ("fill", dispatches) and
    ("pop", dispatch), with the clock after each."""
    name, kw = model_kw
    model = mod.make_availability(name, **kw)
    sampler = (TSampler if mod is T else JSampler)(N, 5, seed)
    sim = mod.DispatchSimulator(model, sampler, N, max_inflight)
    out = []
    while len(out) < n_events:
        if sim.should_fill():
            got = sim.fill()
            if got:
                out.append(("fill", tuple(tuple(d) for d in got), sim.clock))
        if not sim.pending():
            sim.advance_to_available()
            out.append(("advance", sim.clock))
            continue
        out.append(("pop", tuple(sim.pop()), sim.clock))
    return out, sim


@pytest.mark.parametrize("model_kw,max_inflight",
                         [(MODELS[3], 6), (MODELS[4], 4), (MODELS[2], 3),
                          (MODELS[0], 5)], ids=["straggler", "duty", "uniform",
                                                "always_on"])
def test_dispatch_events_are_the_reference(model_kw, max_inflight):
    got, tsim = _events(T, model_kw, max_inflight)
    want, jsim = _events(J, model_kw, max_inflight)
    assert got == want
    assert np.array_equal(tsim.dispatch_k, jsim.dispatch_k)
    assert tsim.inflight_clients() == jsim.inflight_clients()


def test_simulator_restore_resumes_the_same_events():
    model_kw = MODELS[3]
    full, _ = _events(T, model_kw, 6, n_events=120)
    part, sim = _events(T, model_kw, 6, n_events=60)
    inflight = [d for _, _, d in sorted(sim._heap)]
    twin = T.DispatchSimulator(T.make_availability(model_kw[0],
                                                   **model_kw[1]),
                               sim.sampler, N, 6)
    twin.restore(sim.clock, sim.seq, sim.dispatch_k, inflight)
    rest = []
    while len(part) + len(rest) < 120:
        if twin.should_fill():
            got = twin.fill()
            if got:
                rest.append(("fill", tuple(tuple(d) for d in got),
                             twin.clock))
        if not twin.pending():
            twin.advance_to_available()
            rest.append(("advance", twin.clock))
            continue
        rest.append(("pop", tuple(twin.pop()), twin.clock))
    assert part + rest == full


@pytest.mark.parametrize("recorder", ["port", "reference"])
def test_traces_replay_across_packages(recorder, tmp_path):
    rec_mod, play_mod = (T, J) if recorder == "port" else (J, T)
    rec = rec_mod.record_trace(rec_mod.make_availability(MODELS[3][0],
                                                         **MODELS[3][1]))
    events, _ = _events_with(rec_mod, rec, 6)
    text = rec.trace.to_json()
    other = (J if rec_mod is T else T).AvailabilityTrace.from_json(text)
    assert other.to_json() == text and len(other) == len(rec.trace) > 0
    path = str(tmp_path / "trace.json")
    rec.trace.save(path)
    replayed, _ = _events_with(play_mod,
                               play_mod.make_availability("trace",
                                                          trace=path), 6)
    assert replayed == events
    with pytest.raises(KeyError, match="diverged"):
        play_mod.TraceAvailability(other).fate(N + 1, 0)


def _events_with(mod, model, max_inflight, n_events=120, seed=4):
    sampler = (TSampler if mod is T else JSampler)(N, 5, seed)
    sim = mod.DispatchSimulator(model, sampler, N, max_inflight)
    out = []
    while len(out) < n_events:
        if sim.should_fill():
            out.extend(tuple(d) for d in sim.fill())
        out.append(tuple(sim.pop()))
    return out, sim


@pytest.mark.parametrize("n,s,seed", [(30, 5, 0), (50, 10, 7), (8, 8, 3)])
def test_sample_available_draws_as_sample(n, s, seed):
    a, b, ref = TSampler(n, s, seed), TSampler(n, s, seed), JSampler(n, s,
                                                                     seed)
    for _ in range(5):
        want = a.sample()
        assert np.array_equal(b.sample_available(np.arange(n), s), want)
        assert np.array_equal(ref.sample_available(np.arange(n), s), want)
    assert a.get_state() == b.get_state() == ref.get_state()
    # a partial pool, and fewer available than asked: the reference's draws
    pool = np.arange(n)[::3]
    for size in (2, len(pool) + 4):
        assert np.array_equal(b.sample_available(pool, size),
                              ref.sample_available(pool, size))
    # an empty pool or size <= 0 consumes nothing
    state = b.get_state()
    assert b.sample_available(np.arange(0), s).size == 0
    assert b.sample_available(pool, 0).size == 0
    assert b.get_state() == state
