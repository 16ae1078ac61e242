"""A run with the timed path broken underneath reads not correct: the
harness driven on the CPU at a small size (its look for a card skipped),
once for each fault a cell can have.  A realization's cells are its batch,
its products its answers; one card, so no exchange between chips, and no
training state."""

import pytest

from bench_small import run_small, small_cell
from pinocchio_tpu_torch.ops import collapse, compact, derivatives


def _half_the_cells(monkeypatch):
    """Half of the needed cells left out of the hand-off."""
    real = compact.needed_order

    def half(Fmax, Flast):
        idx = real(Fmax, Flast)
        return idx[:idx.numel() // 2]
    monkeypatch.setattr(compact, "needed_order", half)


def _rows_altered(monkeypatch):
    """The displacements altered where they are produced (1 %)."""
    for name in ("first_derivatives", "first_derivatives_tab",
                 "ooc_gradient", "ooc_gradient_tab"):
        real = getattr(derivatives, name)

        def scaled(*a, _real=real, **k):
            return _real(*a, **k) * 1.01
        monkeypatch.setattr(derivatives, name, scaled)


def _F_altered(monkeypatch):
    """The collapse times altered where they are produced (0.1 %)."""
    real = collapse.collapse_F
    monkeypatch.setattr(collapse, "collapse_F",
                        lambda d, pack: real(d, pack) * 1.001)


def _hist_miscounted(monkeypatch):
    """The FmaxPDF counts altered where they are produced: 1 % of the
    fullest bin counted in the next one."""
    real = compact.pdf_hist

    def moved(Fmax):
        h = real(Fmax).clone()
        b = int(h[:-1].argmax())
        k = max(1, int(h[b]) // 100)
        h[b] -= k
        h[b + 1] += k
        return h
    monkeypatch.setattr(compact, "pdf_hist", moved)


def _hist_count_lost(monkeypatch):
    """One count of the FmaxPDF lost."""
    real = compact.pdf_hist

    def lost(Fmax):
        h = real(Fmax).clone()
        h[int(h.argmax())] -= 1
        return h
    monkeypatch.setattr(compact, "pdf_hist", lost)


@pytest.mark.parametrize("fault", [_half_the_cells, _rows_altered,
                                   _F_altered, _hist_miscounted,
                                   _hist_count_lost])
@pytest.mark.parametrize("name", ["lcdm512.dense", "lcdm512.ooc"])
def test_fault_reads_not_correct(name, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = run_small(small_cell(name), tmp_path)
    assert res["correct"] is False, res["compared"]
