"""The reader of fft_direct_share on synthetic records: the transforms
through the program's own plans over all of them, summed over the window;
a program without the counts reads None, never raises; the spec lists it
in the dense cells alone."""

import pytest

from benchmark import harness


def _read(run):
    return harness.Cell(harness.load_spec(), "lcdm512.dense").reader(
        "fft_direct_share")(run)


def _run(timings):
    return dict(engine="dense", records=[dict(timings=t) for t in timings])


def test_the_share_over_the_window():
    assert _read(_run([dict(fft_direct=12, fft_torch=0)] * 3)) == 1.0
    assert _read(_run([dict(fft_direct=9, fft_torch=3),
                       dict(fft_direct=0, fft_torch=12)])) == pytest.approx(
        9 / 24)
    # a record between them need not hold the counts
    assert _read(_run([dict(fft_direct=6, fft_torch=2), {},
                       dict(fft_direct=2, fft_torch=0)])) == pytest.approx(
        0.8)


def test_none_without_it():
    assert _read(_run([])) is None
    assert _read(_run([dict(fmax_loop=0.27), dict(fmax_loop=0.26)])) is None
    assert _read(_run([dict(fft_direct=0, fft_torch=0)])) is None
    assert _read(_run([dict(fft_direct=3)])) is None


def test_the_spec_lists_it():
    spec = harness.load_spec()
    m = {m["name"]: m for m in spec["per_layer"]}["fft_direct_share"]
    assert m["workloads"] == ["lcdm512.dense", "fr5_512.dense"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "ratio", "higher", "program_counter", "collapse cycle",
        "realization_s")
    for cell in m["workloads"]:
        assert "fft_direct_share" in [
            p["name"] for p in harness.Cell(spec, cell).per_layer]
