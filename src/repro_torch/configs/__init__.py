from repro_torch.configs.base import (  # noqa: F401
    FLConfig, INPUT_SHAPES, ModelConfig, ShapeConfig,
)
