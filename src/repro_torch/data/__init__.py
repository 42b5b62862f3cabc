from repro_torch.data.synthetic import (ImageData,  # noqa: F401
                                        batch_iterator, lm_examples,
                                        make_char_data, make_image_data)
from repro_torch.data.federated import (PARTITIONERS,  # noqa: F401
                                        client_datasets_images,
                                        client_datasets_lm, get_partitioner,
                                        partition_dirichlet, partition_iid,
                                        partition_zipf, register_partitioner)
