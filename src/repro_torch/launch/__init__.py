# Launchers of the port: ``train`` (the LLM-scale FL host loop and fused
# rounds), ``serve``, the production meshes and their sharding rules, the
# dry run on the meta device (``python -m repro_torch.launch.dryrun``).
from repro_torch.launch.mesh import make_production_mesh  # noqa: F401
