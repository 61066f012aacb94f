"""Rank calibration of the nested-rank draft (counterpart of
``repro/core/compress.py::calibrate_ranks``, a copy in plain numpy).  The
rest of the reference's compression module — Algorithm 2 and the other
structures' fits — is not ported yet (ROADMAP A10)."""

from __future__ import annotations

import numpy as np


def calibrate_ranks(spectra: dict[str, np.ndarray], frac: float,
                    *, min_rank: int = 1) -> dict[str, int]:
    """Per-linear draft ranks from factor energy spectra.

    ``spectra`` maps a linear's name to its ``structures.rank_spectrum``
    (a length-r energy vector); ``frac`` is the global rank-budget fraction
    the draft keeps.  Each component's energy is normalized to a share of
    its own linear's total, all shares are pooled, and the globally largest
    shares are kept until ~``frac`` of the total rank budget is used — so
    flat-spectrum linears keep more of their rank and spiky ones donate
    theirs.  Returns name → r' with every r' in [min_rank, r]; ``frac >= 1``
    keeps everything (truncation becomes the identity)."""
    shares: dict[str, np.ndarray] = {}
    sizes: dict[str, int] = {}
    for name, e in spectra.items():
        e = np.asarray(e, np.float64).reshape(-1)
        tot = float(e.sum())
        shares[name] = e / tot if tot > 0 else np.full(e.shape, 1.0 / e.size)
        sizes[name] = int(e.size)
    total = sum(sizes.values())
    keep = int(round(min(max(float(frac), 0.0), 1.0) * total))
    keep = max(keep, min_rank * len(spectra))
    if keep >= total:
        return dict(sizes)
    pool = np.sort(np.concatenate(list(shares.values())))[::-1]
    tau = pool[keep - 1]
    return {name: int(min(max(int((s >= tau).sum()), min_rank), sizes[name]))
            for name, s in shares.items()}
