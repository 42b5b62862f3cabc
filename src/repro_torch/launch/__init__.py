"""Launch entry points of the port (``repro.launch``): ``train`` (the
production FedAvg, central and calibration steps, sharded over a device
mesh under a ``ShardCtx`` or on one card, and a demo), ``inputs``
(``meta``-tensor specs of every model input), ``serve`` (prefill and
batched decode), ``mesh`` (the reference's production and debug meshes as
``torch.distributed`` ``DeviceMesh``es, the process worlds under them:
NCCL on the card, gloo on the CPU, a fake world for the dry run),
``shardings`` (the reference's sharding policy: the placements of
parameters, optimizer state, batches and caches on a mesh) and ``dryrun``
(bytes against each card's 80 GB, on one card or each device of a mesh,
the roofline terms and a sharded step's collectives)."""
from repro_torch.launch.mesh import (  # noqa: F401
    make_debug_mesh, make_production_mesh)
