"""The readers of the program's hand-off counters and spans
(pinned_alloc_s, pinned_free_s, pinned_gib, d2h_gib, handoff_alloc_s,
lpt_device_s) on synthetic records: a counter is a process total, so a
rate is the last record's total less the first's over the records between
them; a program without the counters or spans reads None, never raises."""

import pytest

from benchmark import harness

GIB = 2 ** 30
COUNTERS = {"pinned_alloc_s": ("pinned_alloc_seconds_total", 1),
            "pinned_free_s": ("pinned_free_seconds_total", 1),
            "pinned_gib": ("pinned_alloc_bytes_total", GIB),
            "d2h_gib": ("d2h_bytes_total", GIB)}
NEW = tuple(COUNTERS) + ("handoff_alloc_s", "lpt_device_s")


def _reader(name):
    return harness.Cell(harness.load_spec(), "lcdm512.dense").reader(name)


def _run(timings, engine="dense"):
    return dict(engine=engine, records=[dict(timings=t) for t in timings])


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_counter_rate_between_first_and_last(name):
    key, scale = COUNTERS[name]
    totals = [7.0 * scale, 9.5 * scale, 10.0 * scale, 13.0 * scale]
    run = _run([{key: v} for v in totals])
    assert _reader(name)(run) == pytest.approx(2.0)
    assert _reader(name)(_run([{key: totals[0]}])) is None
    # a record between them need not hold the total
    assert _reader(name)(_run([{key: 1.0 * scale}, {},
                               {key: 3.0 * scale}])) == 1.0


def test_handoff_alloc_s_mean():
    run = _run([dict(handoff_alloc_s=0.5), dict(handoff_alloc_s=1.5)],
               engine="ooc")
    assert _reader("handoff_alloc_s")(run) == 1.0


def test_lpt_device_s_reads_the_dense_engine_alone():
    t = [dict(lpt=0.1, handoff_alloc_s=0.9), dict(lpt=0.3,
                                                  handoff_alloc_s=1.0)]
    read = _reader("lpt_device_s")
    assert read(_run(t)) == pytest.approx(0.2)
    assert read(_run(t, engine="ooc")) is None
    # a program that stamps lpt at the enqueue (no handoff_alloc_s)
    assert read(_run([dict(lpt=0.01), dict(lpt=0.02)])) is None


@pytest.mark.parametrize("engine", ["dense", "ooc"])
@pytest.mark.parametrize("name", NEW)
def test_a_program_without_them_reads_none(name, engine):
    """The timings of a program from before these counters and spans."""
    old = dict(fmax_loop=0.27, lpt=0.004, handoff_return=1.46,
               handoff_last=1.21)
    assert _reader(name)(_run([old, dict(old), dict(old)], engine)) is None


def test_the_spec_lists_them():
    spec = harness.load_spec()
    cells = [w["name"] for w in spec["workloads"]]
    by = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = by[name]
        want = [c for c in cells if c.endswith(".dense")] if (
            name == "lpt_device_s") else cells
        assert m["workloads"] == want
        assert m["moves"] == ("sweep_start_s" if name == "handoff_alloc_s"
                              else "realization_s")
