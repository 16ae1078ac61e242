"""Adversarial F for the FmaxPDF histogram (K6b), shared by the CPU test
against JAX and the card test against the plain version."""

import numpy as np
import torch

NAMES = ("one bin", "bin 0", "nan", "specials", "edges", "20.9-21.0",
         "4k+1", "4k+2", "4k+3", "tiny", "offset 1", "offset 2", "offset 3",
         "offset 1, 4k+2", "offset 3, 2 cells")


def adversarial_F(device, n: int = 1 << 20) -> dict:
    """{name: float32 tensor on device}, n a multiple of 4: every cell in
    one bin (3.14; -10, bin 0; NaN); NaN, +-inf, -0.0, +-1e30, 20.9, 21.0
    among ordinary cells; every bin edge 0.1 k with its float neighbours;
    F from 20.9 to 21.0; lengths 4k + 1, 4k + 2, 4k + 3 and 3; and views
    1-3 elements past a 16-byte boundary (sliced on the device)."""
    rng = np.random.default_rng(5)
    base = rng.choice(np.arange(-10.0, 30.0, 0.1, dtype=np.float32),
                      n).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -1e30,
                        20.9, 21.0, 0.1, 20.95], np.float32)
    mixed = base.copy()
    mixed[rng.integers(0, n, n // 256)] = rng.choice(special, n // 256)
    edges = (np.arange(-5, 216) * np.float32(0.1)).astype(np.float32)
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                            np.nextafter(edges, np.float32(np.inf))])
    cases = {"one bin": np.full(n, 3.14, np.float32),
             "bin 0": np.full(n, -10.0, np.float32),
             "nan": np.full(n // 4 + 3, np.nan, np.float32),
             "specials": mixed, "edges": np.tile(edges, max(1, n >> 14)),
             "20.9-21.0": np.linspace(20.9, 21.0, n // 16,
                                      dtype=np.float32),
             "4k+1": base[:n // 4 + 1], "4k+2": base[:n // 4 + 2],
             "4k+3": base[:n // 4 + 3], "tiny": base[:3]}
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in cases.items()}
    for k in (1, 2, 3):
        out[f"offset {k}"] = out["specials"][k:]
    out["offset 1, 4k+2"] = out["specials"][1:n // 4 + 3]
    out["offset 3, 2 cells"] = out["specials"][3:5]
    assert tuple(out) == NAMES
    return out
