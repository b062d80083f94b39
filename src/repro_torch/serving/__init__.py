from repro_torch.serving.engine import generate  # noqa: F401
