"""Roofline terms and tables of the one-card dry run
(``repro.roofline``): ``analysis`` (the card's peaks, ``model_flops``, the
analytic step bytes and terms, a sharded step's collectives and local
FLOPs) and ``report`` (tables over the dry run's JSON).  The reference's
HLO cost model has no counterpart beyond those (see ``analysis``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    CARD, HBM_BW, HBM_BYTES, PEAK_FLOPS, PEAK_FLOPS_BF16, PEAK_FLOPS_TF32X3,
    POWER_LIMIT_W, model_flops, peak_flops, step_bytes, step_terms)
