"""End-to-end serving example on the PyTorch port: serve a small model with
batched requests — prefill a batch of prompts, decode autoregressively with
the KV/state cache — on the CUDA card unless ``--device cpu`` is given.
Runs each architecture family's reduced config to show the uniform serve
API (attention KV ring buffers, mamba states, rwkv states); prefill runs
the ``window_attention``, ``ssm_scan`` and ``wkv`` kernels where a config
has a local layer past its window, a mamba layer or an rwkv layer.  Prints
the lines of ``examples/serve_batched.py``.

    PYTHONPATH=src python examples/serve_batched_torch.py \
        [--arch rwkv6-3b] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.tree import tree_map
from repro_torch.kernels import resolve_device
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.models import init_params

ARCHS = ("olmo-1b", "granite-moe-1b-a400m", "rwkv6-3b",
         "jamba-1.5-large-398b", "whisper-tiny", "internvl2-2b")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def run(arch: str, batch: int = 8, prompt_len: int = 48, gen: int = 32,
        device=None, init_fn=None) -> dict:
    """Serve ``reduce_for_smoke(get_config(arch))``: prefill seeded prompts
    with a cache of ``prompt_len + gen`` positions, then ``gen - 1`` greedy
    decode steps.  ``init_fn(cfg)`` gives the weights (e.g. the
    reference's, through ``from_numpy_params``), else ``init_params(cfg,
    0)``.  Returns the prefill's last-token logits, the ``gen`` greedy
    tokens (B, gen) and the walls."""
    dev = resolve_device(device)
    cfg = reduce_for_smoke(get_config(arch))
    params = (tree_map(lambda v: v.to(dev), init_fn(cfg)) if init_fn
              else init_params(cfg, 0, device=dev))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (batch, prompt_len))
                            .astype(np.int32)).to(dev)
    b = {"tokens": toks}
    if cfg.family == "vlm":
        b["patches"] = torch.zeros((batch, cfg.vision_tokens, cfg.d_model),
                                   device=dev)
    if cfg.family == "audio":
        b["frames"] = torch.zeros((batch, 64, cfg.d_model), device=dev)

    prefill = make_prefill_step(cfg, max_len=prompt_len + gen)
    decode = make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, b)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    first = logits[:, -1].clone()

    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    out = [tok[:, 0]]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, tok, cache)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        out.append(tok[:, 0])
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return {"arch": arch, "prefill_logits": first.float().cpu(),
            "tokens": torch.stack(out, 1).cpu().numpy(),
            "prefill_s": t_prefill,
            "decode_s_per_token": t_dec / max(gen - 1, 1),
            "batch": batch, "prompt_len": prompt_len, "gen": gen}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    outs = []
    for a in [args.arch] if args.arch else ARCHS:
        o = run(a, device=args.device)
        print(f"{a:24s} prefill({o['batch']}x{o['prompt_len']})="
              f"{o['prefill_s'] * 1e3:7.1f}ms  decode {o['gen']} toks: "
              f"{o['decode_s_per_token'] * 1e3:6.1f} ms/tok  "
              f"sample={o['tokens'][0][:8].tolist()}")
        outs.append(o)
    return outs


if __name__ == "__main__":
    main()
