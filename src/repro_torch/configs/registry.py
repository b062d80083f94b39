"""Architecture registry — ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import (
    qwen2_5_32b, granite_8b, mixtral_8x7b, arctic_480b, smollm_135m,
    gemma2_9b, zamba2_2_7b, mamba2_130m, musicgen_medium, paligemma_3b,
)

ARCHITECTURES: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen2_5_32b.CONFIG,
        granite_8b.CONFIG,
        mixtral_8x7b.CONFIG,
        arctic_480b.CONFIG,
        smollm_135m.CONFIG,
        gemma2_9b.CONFIG,
        zamba2_2_7b.CONFIG,
        mamba2_130m.CONFIG,
        musicgen_medium.CONFIG,
        paligemma_3b.CONFIG,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name.endswith('-reduced'):
        return get_arch(name[: -len('-reduced')]).reduced()
    if name not in ARCHITECTURES:
        raise KeyError(
            f'unknown arch {name!r}; available: {sorted(ARCHITECTURES)}')
    return ARCHITECTURES[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in INPUT_SHAPES:
        raise KeyError(
            f'unknown input shape {name!r}; available: {sorted(INPUT_SHAPES)}')
    return INPUT_SHAPES[name]


def applicable(arch: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is in scope, with the DESIGN.md §long_500k rule."""
    if shape.name == 'long_500k' and not arch.subquadratic:
        return False, (
            'skipped: pure full-attention arch; long_500k requires '
            'sub-quadratic attention (DESIGN.md §Arch-applicability)')
    return True, ''


def all_pairs():
    for aname, arch in ARCHITECTURES.items():
        for sname, shape in INPUT_SHAPES.items():
            yield aname, sname, arch, shape
