"""Compression of dense weights into any structure (paper §4.2), in PyTorch
(counterpart of ``repro/core/compress.py``):

  * ``blast``      — Algorithm 2 (``core/factorize.py``)
  * ``low_rank``   — truncated SVD (optimal in Frobenius norm)
  * ``block_diag`` — the diagonal blocks (optimal in Frobenius norm)
  * ``monarch``, ``pixelfly`` — an Adam fit of the Frobenius loss (no closed
    form for either support)

``compress_linear`` handles one weight, ``compress_tree`` a dict of named
weights with their target specs (a leading layer axis with
``layer_axis``).  fp32 inside, on the weight's device.  The reference draws
its starts from JAX keys, which cannot be reproduced here: the fits take a
start, or draw one from a ``torch.Generator``.

``calibrate_ranks`` picks the nested-rank draft's per-linear ranks for
self-speculative decoding (plain numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import factorize as fct
from repro_torch.core.structures import LinearSpec

Params = dict[str, torch.Tensor]


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


def _svd_low_rank(w: torch.Tensor, t: int) -> Params:
    """w (d_in, d_out) → {w_down (d_in, t), w_up (t, d_out)}, the singular
    values split evenly between the two."""
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    t = min(t, s.shape[0])
    root = torch.sqrt(s[:t])
    return {"w_down": (u[:, :t] * root).to(w.dtype),
            "w_up": (root[:, None] * vt[:t]).to(w.dtype)}


def _block_diag_extract(w: torch.Tensor, b: int) -> Params:
    """The best block-diagonal approximation of w (d_in, d_out): its
    diagonal blocks, (b, q, p)."""
    d_in, d_out = w.shape
    blocks = w.reshape(b, d_in // b, b, d_out // b)
    return {"w": torch.diagonal(blocks, dim1=0, dim2=2).permute(2, 0, 1)
            .contiguous()}


def _adam_fit(w: torch.Tensor, spec: LinearSpec, *, steps: int = 300,
              lr: float = 3e-3, start: Params | None = None,
              generator: torch.Generator | None = None) -> Params:
    """min ‖w − W(params)‖² (mean over entries) by Adam, through autograd
    on ``spec.apply(params, I)``, with the reference's bias-corrected
    moments (β 0.9, 0.999, eps 1e-8).  ``start``: the first params (else
    ``spec.init`` from ``generator``)."""
    w = w.float()
    eye = torch.eye(w.shape[0], device=w.device)
    if start is None:
        start = spec.init(generator or torch.Generator().manual_seed(0),
                          dtype=torch.float32, device=w.device)
    params = {k: v.detach().to(device=w.device, dtype=torch.float32).clone()
              for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    for k in range(steps):
        leaves = {n: p.requires_grad_() for n, p in params.items()}
        loss = torch.mean((spec.apply(leaves, eye) - w) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        t = k + 1
        with torch.no_grad():
            for n in params:
                g = grads[n]
                m[n] = 0.9 * m[n] + 0.1 * g
                v2[n] = 0.999 * v2[n] + 0.001 * g * g
                mh = m[n] / (1 - 0.9 ** t)
                vh = v2[n] / (1 - 0.999 ** t)
                params[n] = params[n].detach() - lr * mh / (torch.sqrt(vh)
                                                            + 1e-8)
    return params


def compress_linear(w: torch.Tensor, spec: LinearSpec, *, steps: int = 300,
                    start=None,
                    generator: torch.Generator | None = None) -> Params:
    """Compress a dense weight ``w`` (d_in, d_out) into the structure of
    ``spec``, in w's type.  ``start``: BLAST's (U0, S0, V0), or the first
    params of a Monarch or Pixelfly fit; unused by the closed forms."""
    kind = spec.kind
    if kind == "dense":
        return {"w": w}
    if kind == "blast":
        return fct.factorize_weight(w, spec.meta["b"], spec.meta["r"],
                                    steps=steps, start=start,
                                    generator=generator)
    if kind == "low_rank":
        return _svd_low_rank(w, spec.meta["rank"])
    if kind == "block_diag":
        return _block_diag_extract(w, spec.meta["b"])
    if kind in ("monarch", "pixelfly"):
        out = _adam_fit(w, spec, steps=steps, start=start,
                        generator=generator)
        return {k: v.to(w.dtype) for k, v in out.items()}
    raise ValueError(kind)


def reconstruction_error(w: torch.Tensor, spec: LinearSpec,
                         params: Params) -> float:
    """‖w − Ŵ‖_F / ‖w‖_F for any structure (Ŵ the linear applied to I, in
    fp32)."""
    eye = torch.eye(w.shape[0], device=w.device)
    with torch.no_grad():
        approx = spec.apply({k: v.float() for k, v in params.items()}, eye)
    w = w.float()
    return float(torch.linalg.norm(approx - w) / torch.linalg.norm(w))


def compress_tree(dense_weights: dict[str, torch.Tensor],
                  specs: dict[str, LinearSpec], *, steps: int = 300,
                  layer_axis: bool = False,
                  generator: torch.Generator | None = None
                  ) -> dict[str, Params]:
    """Compress every named weight into its spec's structure, in name order
    (the reference's), each fit drawing its start from ``generator`` in
    turn.  With ``layer_axis`` each weight is stacked over a leading layer
    axis, compressed layer by layer, and its params come back stacked the
    same way."""
    out: dict[str, Params] = {}
    for name in sorted(dense_weights):
        w, spec = dense_weights[name], specs[name]
        if not layer_axis:
            out[name] = compress_linear(w, spec, steps=steps,
                                        generator=generator)
            continue
        layers = [compress_linear(w[i], spec, steps=steps, generator=generator)
                  for i in range(w.shape[0])]
        out[name] = {k: torch.stack([p[k] for p in layers])
                     for k in layers[0]}
    return out
