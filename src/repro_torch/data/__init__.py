from repro_torch.data.synthetic import (ImageData, lm_examples,  # noqa: F401
                                        make_char_data, make_image_data)
from repro_torch.data.federated import (PARTITIONERS,  # noqa: F401
                                        get_partitioner, partition_dirichlet,
                                        partition_iid, partition_zipf,
                                        register_partitioner)
