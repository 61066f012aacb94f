"""Architecture registry of the port: the archs whose serving path has been
ported (``smollm-135m``); the others follow with their slices."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, StructureConfig  # noqa: F401
from repro_torch.configs.smollm_135m import CONFIG as smollm_135m

ARCHS: dict[str, ArchConfig] = {
    "smollm-135m": smollm_135m,
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (have {sorted(ARCHS)})")
    return ARCHS[name]
