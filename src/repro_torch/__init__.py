"""PyTorch + CUDA port of the BLAST serving and training stack (the JAX
package ``repro`` stays the reference it is held against).

Module names mirror ``repro``: ``configs``, ``core``, ``kernels``, ``quant``,
``models``, ``serve``, ``optim``, ``train``, ``data``, ``checkpoint``,
``launch``, plus ``weights`` (the bridge that carries JAX parameters and
``checkpoint/store.py`` directories across) and ``tree`` (nested-dict
parameter trees).

The package imports ``torch``, numpy and the standard library only.  Every
entry point runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU present and no explicit CPU request it raises instead of quietly
running on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``.  A CUDA request on a machine without a GPU raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
