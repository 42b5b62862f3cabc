"""Serving: prefill + batched decode of the (unlearned) model
(``repro.launch.serve``).

``make_prefill_step`` / ``make_decode_step`` are the serving steps;
``serve_demo`` runs a serving loop on a reduced config: prefill a batch of
prompts, then decode tokens greedily.  Run it as
``python -m repro_torch.launch.serve --arch rwkv6-3b [--device cpu]``; it
runs on the CUDA card unless ``--device cpu`` is given.  Both steps take
the reference's ``ctx``; prefill and decode across the ranks of a mesh
(``launch.shardings.cache_shardings`` live, sequence-parallel prefill) are
not run yet.  A decode step
writes the cache in place (the reference donates its cache to the jitted
step), so the loop hands each step the cache the last one returned.
"""
from __future__ import annotations

from repro_torch.models import decode_fn, prefill_fn


# The reference's serving steps wrap the model functions for its jit and
# donation, which the port has no counterpart for; here they are the model
# functions themselves (with the reference's signatures), kept under the
# serving module's public names.
make_prefill_step = prefill_fn   # (cfg, ctx=NULL_CTX, max_len=None) -> step
make_decode_step = decode_fn     # (cfg, ctx=NULL_CTX) -> step


def serve_demo(argv=None, init_fn=None):
    """The reference's demo with its flags, plus ``--device`` (the card by
    default).  ``init_fn(cfg)``, when given, returns the parameter tree to
    serve (moved to the device), e.g. the reference's weights through
    ``from_numpy_params``; else ``init_params(cfg, 0)``.  Returns the
    generated token ids (B, gen) as numpy."""
    import argparse

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import resolve_device
    from repro_torch.models import init_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduce_for_smoke(get_config(args.arch))
    dev = resolve_device(args.device)
    params = (tree_map(lambda v: v.to(dev), init_fn(cfg)) if init_fn
              else init_params(cfg, 0, device=dev))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (args.batch, args.prompt_len))
                            .astype(np.int32)).to(dev)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((args.batch, cfg.vision_tokens,
                                        cfg.d_model), device=dev)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((args.batch, 64, cfg.d_model),
                                      device=dev)

    prefill = make_prefill_step(cfg, max_len=args.prompt_len + args.gen)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, batch)
    out = []
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    for _ in range(args.gen):
        out.append(tok[:, 0])
        logits, cache = decode(params, tok, cache)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
    gen = torch.stack(out, 1).cpu().numpy()
    print(f"arch={cfg.name} served batch={args.batch} gen={args.gen} tokens")
    print("generated token ids (first row):", gen[0].tolist())
    return gen


if __name__ == "__main__":
    serve_demo()
