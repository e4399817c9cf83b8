from batch_shipyard_tpu_torch.substrate.base import (  # noqa: F401
    ComputeSubstrate,
    NodeInfo,
    create_substrate,
)
