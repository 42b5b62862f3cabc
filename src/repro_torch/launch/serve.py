"""Serving: prefill + batched decode of the (unlearned) model
(``repro.launch.serve``).

``make_prefill_step`` / ``make_decode_step`` are the serving steps;
``serve_demo`` runs a serving loop on a reduced config: prefill a batch of
prompts, then decode tokens greedily.  Run it as
``python -m repro_torch.launch.serve --arch rwkv6-3b [--device cpu]``; it
runs on the CUDA card unless ``--device cpu`` is given.  A decode step
writes the cache in place (the reference donates its cache to the jitted
step), so the loop hands each step the cache the last one returned.

Both steps take the reference's ``ctx`` and then run sharded over a
(data, model) ``DeviceMesh``, as the reference's dry run lowers them
(``build_lowered``'s prefill and decode branches): ``MeshServer`` gives
prefill the rules of the strategy ``resolve_strategy`` picks
(sequence-parallel for the attention-only archs whose heads do not divide
the model dim, tensor-parallel otherwise) and decode its own rules, under
which the KV cache's slots are split (``launch.shardings.cache_shardings``);
the cache prefill leaves is laid out again for decode
(``distribute_tree``), and a decode step returns every leaf in the
placements it was given, as the reference pins its output cache.
``serve_on_mesh`` runs cases so on one rank of a world (through
``launch.mesh.spawn``), for checks against the unsharded steps.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models import decode_fn, prefill_fn


# The reference's serving steps wrap the model functions for its jit and
# donation, which the port has no counterpart for; here they are the model
# functions themselves (with the reference's signatures), kept under the
# serving module's public names.
make_prefill_step = prefill_fn   # (cfg, ctx=NULL_CTX, max_len=None) -> step
make_decode_step = decode_fn     # (cfg, ctx=NULL_CTX) -> step


class MeshServer:
    """Serving of ``cfg`` (``published`` cut to size, or itself) on a
    (data, model) ``mesh`` ("DxM" of the running world, or a
    ``DeviceMesh``) on ``device`` (the card unless the caller passes
    ``"cpu"``) under the rules of ``published``: prefill under the
    strategy ``resolve_strategy`` picks from ``strategy`` ("auto", "tp"
    or "seq_parallel"; under ``seq_parallel`` prefill's config takes
    ``attn_block_q=0`` and no block skipping, as the reference's dry run
    sets them), decode under its own rules.  ``place(params)`` lays the
    weights out for each side; ``prefill(params, batch)`` returns the
    logits and the cache already laid out for decode (``handover``);
    ``decode(params, tokens, cache)`` is one step, the cache's leaves
    keeping their placements.  Batches and tokens are plain tensors, the
    same on every rank; logits come back as DTensors (vocab-sharded where
    the rules split it)."""

    def __init__(self, published, cfg, mesh, device=None,
                 strategy: str = "auto", max_len=None):
        from repro_torch.kernels import resolve_device
        from repro_torch.launch import shardings as sh
        from repro_torch.launch.train import mesh_context
        self.device = resolve_device(device)
        sides = {}
        for kind in ("prefill", "decode"):
            strat = sh.resolve_strategy(published, kind, strategy)
            kcfg = cfg
            if strat == "seq_parallel":
                kcfg = dataclasses.replace(cfg, attn_block_q=0,
                                           attn_block_skip=False)
            ctx, place = mesh_context(published, mesh, self.device, kind,
                                      strat)
            mesh = ctx.mesh
            psh = sh.param_shardings(cfg, mesh, sh.param_rules(
                published, kind, False, strat))
            sides[kind] = (kcfg, ctx, place, strat, psh)
        self.prefill_cfg, self.prefill_ctx, self._pplace, self.strategy, \
            self._psh = sides["prefill"]
        self.decode_cfg, self.decode_ctx, self._dplace, _, self._dsh = \
            sides["decode"]
        self.mesh = mesh
        self._prefill = make_prefill_step(self.prefill_cfg, self.prefill_ctx,
                                          max_len)
        self._decode = make_decode_step(self.decode_cfg, self.decode_ctx)

    def place(self, params):
        """(prefill's weights, decode's weights) laid out on the mesh: one
        tree for both where the two sides' placements agree (under
        ``tp``, every arch that is not sequence-parallel).  ``params`` is
        a tree of tensors, or of numpy arrays, which are built on the
        mesh a leaf at a time (``from_numpy_params``)."""
        import numpy as np

        from repro_torch.core.tree import tree_leaves
        from repro_torch.models import from_numpy_params
        from repro_torch.models.params import distribute_tree

        def lay(shardings):
            if isinstance(tree_leaves(params)[0], np.ndarray):
                return from_numpy_params(params, self.device, self.mesh,
                                         shardings)
            return distribute_tree(params, shardings, self.mesh)
        pre = lay(self._psh)
        return pre, (pre if self._dsh == self._psh else lay(self._dsh))

    def handover(self, cache):
        """A cache in prefill's layout laid out by decode's
        ``cache_shardings``."""
        from repro_torch.launch import shardings as sh
        ctx = self.decode_ctx
        return sh.distribute_tree(cache, sh.cache_shardings(
            cache, ctx.mesh, ctx.rules), ctx.mesh)

    def prefill(self, params, batch, keep=None):
        """(logits, cache in decode's layout); ``keep``, when given, is
        called with prefill's own cache before the handover."""
        logits, cache = self._prefill(params, self._pplace(
            batch, self.prefill_cfg, batch=True, client_leading=False))
        if keep is not None:
            keep(cache)
        return logits, self.handover(cache)

    def decode(self, params, tokens, cache):
        tok = self._dplace({"tokens": tokens}, self.decode_cfg, batch=True,
                           client_leading=False)["tokens"]
        return self._decode(params, tok, cache)


def placements_of(tree) -> dict:
    """Each DTensor leaf's placements as strings, by "/"-joined path."""
    from repro_torch.core.tree import leaves_with_paths
    return {"/".join(p): [str(pl) for pl in t.placements]
            for p, t in leaves_with_paths(tree) if hasattr(t, "placements")}


def _host(logits):
    """A DTensor's gathered logits as numpy (bf16 widened to float32,
    exactly)."""
    import torch
    t = logits.full_tensor().detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def serve_on_mesh(rank: int, world_size: int, cases, mesh_spec: str,
                  device=None) -> list:
    """Each case served sharded (``MeshServer``) on this rank of a (data,
    model) mesh ``mesh_spec``, for checks against the unsharded steps.  A
    case is a dict: ``arch``, ``changes`` (to the published config and to
    ``reduce_for_smoke``'s, which is served), ``strategy`` ("auto" by
    default), ``weights`` and ``batch`` (numpy trees), ``feed`` (B, N)
    the tokens of N teacher-forced decode steps, ``max_len`` the cache's
    length (None: the prompt's).  Returns, as numpy on every rank, a dict
    a case: ``logits`` (prefill's, then each step's, gathered; bf16 ones
    widened to float32),
    ``caches`` (gathered: prefill's, then after each step),
    ``placements`` (each cache leaf's: prefill's own, then decode's
    after the handover and after each step), ``strategy`` (prefill's)
    and ``shared_weights`` (whether both sides serve one placed tree).
    ``device`` is the card unless the caller passes ``"cpu"``.  Run it
    through ``launch.mesh.spawn``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import resolve_device
    from repro_torch.launch.mesh import make_debug_mesh, parse_mesh
    from repro_torch.models import to_numpy_params

    def snap(cache):      # a copy: decode writes the cache in place
        return tree_map(np.copy, to_numpy_params(cache))
    device = resolve_device(device)
    d, m = parse_mesh(mesh_spec).shape
    mesh = make_debug_mesh(d, m, device_type=torch.device(device).type)
    out = []
    for case in cases:
        changes = case.get("changes", {})
        published = dataclasses.replace(get_config(case["arch"]), **changes)
        cfg = dataclasses.replace(reduce_for_smoke(get_config(case["arch"])),
                                  **changes)
        server = MeshServer(published, cfg, mesh, device,
                            case.get("strategy", "auto"),
                            case.get("max_len"))
        pparams, dparams = server.place(case["weights"])
        batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in case["batch"].items()}
        placements = []
        logits, cache = server.prefill(
            pparams, batch, keep=lambda c: placements.append(
                placements_of(c)))
        res = {"logits": [_host(logits)],
               "caches": [snap(cache)],
               "placements": placements, "strategy": server.strategy,
               "shared_weights": pparams is dparams}
        placements.append(placements_of(cache))
        feed = np.asarray(case["feed"])
        for i in range(feed.shape[1]):
            logits, cache = server.decode(
                dparams, torch.from_numpy(feed[:, i:i + 1]).to(device),
                cache)
            res["logits"].append(_host(logits))
            res["caches"].append(snap(cache))
            placements.append(placements_of(cache))
        out.append(res)
    return out


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
