"""The reader of pinned_reuse_share on synthetic records: the reused
bytes' growth over the reused and allocated bytes' growth, from the first
record to the last; a program without the pool's counter reads None,
never raises; the spec lists it in every cell."""

import pytest

from benchmark import harness

GIB = 2 ** 30


def _read(run):
    return harness.Cell(harness.load_spec(), "lcdm512.dense").reader(
        "pinned_reuse_share")(run)


def _run(timings, engine="dense"):
    return dict(engine=engine, records=[dict(timings=t) for t in timings])


def _t(reused, allocated):
    return dict(pinned_reuse_bytes_total=reused * GIB,
                pinned_alloc_bytes_total=allocated * GIB)


@pytest.mark.parametrize("engine", ["dense", "ooc"])
def test_the_share_between_first_and_last(engine):
    # the first record's totals hold the warm realization's allocation
    run = _run([_t(4.5, 4.6), _t(4.5, 9.2), _t(9.0, 9.2), _t(13.5, 9.2)],
               engine)
    assert _read(run) == pytest.approx(9.0 / 13.6)
    # a record between them need not hold the totals
    assert _read(_run([_t(1.0, 1.0), {}, _t(4.0, 2.0)])) == pytest.approx(
        0.75)
    assert _read(_run([_t(2.0, 1.0), _t(5.0, 1.0)])) == 1.0


def test_none_without_it():
    assert _read(_run([_t(1.0, 1.0)])) is None
    assert _read(_run([_t(1.0, 1.0), _t(1.0, 1.0)])) is None  # none handed out
    # a program from before the pool: the allocation counter alone
    old = [dict(pinned_alloc_bytes_total=v * GIB) for v in (4.6, 9.2, 13.8)]
    assert _read(_run(old)) is None
    assert _read(_run([dict(fmax_loop=0.27), dict(fmax_loop=0.26)])) is None


def test_the_spec_lists_it():
    spec = harness.load_spec()
    m = {m["name"]: m for m in spec["per_layer"]}["pinned_reuse_share"]
    assert m["workloads"] == [w["name"] for w in spec["workloads"]]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "ratio", "higher", "program_counter", "hand-off", "realization_s")
