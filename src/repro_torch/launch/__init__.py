"""Launch entry points of the port (``repro.launch``): ``train`` (the
production FedAvg, central and calibration steps, and a demo), ``inputs``
(``meta``-tensor specs of every model input), ``serve`` (prefill and
batched decode) and ``dryrun`` (the one-card dry run: bytes against the
card's 80 GB and the roofline terms of every architecture x shape).
The reference's ``mesh.py`` and ``shardings.py`` lay out a TPU pod's
16 x 16 (or 2 x 16 x 16) device mesh and the GSPMD shardings of
parameters, optimizer state, batches and caches over it; one card has no
mesh and shards nothing, so they have no counterpart here."""
