"""Launch drivers of the port (``repro.launch``): ``serve`` (prefill and
batched decode).  The reference's mesh, sharding, dry-run and training
drivers plan a mesh of TPU devices and are not ported yet."""
