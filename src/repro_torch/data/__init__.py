from repro_torch.data.synthetic import ImageData, make_image_data  # noqa: F401
from repro_torch.data.federated import (PARTITIONERS,  # noqa: F401
                                        get_partitioner, partition_dirichlet,
                                        partition_iid, partition_zipf,
                                        register_partitioner)
