from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition, iid_partition, stack_client_data,
)
from repro_torch.data.synthetic import (  # noqa: F401
    load_image_dataset, synth_cifar, synth_tokens,
)
