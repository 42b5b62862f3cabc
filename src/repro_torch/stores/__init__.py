from repro_torch.stores.store import (CodedStore, FullStore,  # noqa: F401
                                      ParameterStore, RoundPayload, STORES,
                                      StoreStats, UncodedShardStore,
                                      make_store, register_store, tree_bytes)
