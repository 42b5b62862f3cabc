#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failed check raises, and the script exits non-zero):

1. device  — require CUDA; print the card's name and power limit and the
   TF32 switches (both off for the port's fp32 math).
2. build   — compile the hand-written kernels under
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a and load them.
3. kernels — hold each kernel against its plain PyTorch version at the main
   path's shapes and at ragged small ones (fp32: |k - r| <= 1e-5 + 1e-5|r|;
   bf16: within one bf16 ulp), and time kernel, plain version and one
   library call (device time from the CUPTI trace of torch.profiler; CUDA
   events where it records nothing) beside the kernel's bound at 3.35 TB/s
   and 67 TFLOP/s fp32 (H100 SXM data-sheet peaks).
4. small   — a tiny scenario on the card and on the CPU (plain versions):
   StoreStats equal, models within rtol 1e-3 / atol 1e-4.
5. main    — the paper CNN at full width (conv 16/32, fc 128, 28x28x1) in
   the paper's federation (100 clients, 20 per stage, S=4, L=10, G=30,
   100 samples per client): one stage on the fused engine with the coded
   store, one SE request, one batched SE request over two shards, one stage
   on the stage engine.  Launch counts are zeroed just before and read just
   after; every kernel must have launched.  Then the checks: decoded round-0
   locals average to the stored round-1 global, a decode from another
   S-subset agrees, untouched shards are bit-identical, the ensemble is
   above chance.  Last, one fused shard round is profiled: wall time,
   device-busy time, idle share and the kernels that take the time.
6. report  — one JSON line listing the kernels, the card's name and power
   limit, and the final line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores


def log(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Median per-call time of ``fn`` between two CUDA events, after two
    warm-up calls.  For a call of a few microseconds this is the host's
    enqueue time (Python checks, the launch), not the device's."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def trace_device(fn):
    """{kernel name: device ms} of the GPU work ``fn`` launches, from the
    CUPTI trace of torch.profiler; None when the profiler cannot trace the
    card here or records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:
        log("profiler", unavailable=str(e)[:200])
        return None
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    return by_name or None


def device_ms(fn, iters: int):
    """Device time per call of ``fn``: the CUPTI durations of every kernel,
    copy and fill it launches over ``iters`` calls, divided by ``iters``.
    Returns ``(ms, "cupti")``, or the CUDA-event median and ``"events"``
    when the profiler records no device activity."""
    fn()

    def many():
        for _ in range(iters):
            fn()
    by_name = trace_device(many)
    if by_name is None:
        return time_ms(fn, iters), "events"
    return sum(by_name.values()) / iters, "cupti"


def timed(fn, iters: int) -> dict:
    ms, timer = device_ms(fn, iters)
    return {"ms": ms, "timer": timer, "event_ms": time_ms(fn, iters)}


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, ref, name: str) -> dict:
    """Max abs/rel error and the pass test: fp32 |k-r| <= 1e-5 + 1e-5|r|,
    bf16 within one bf16 ulp of the larger magnitude."""
    import torch
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype} "
                             f"{tuple(got.shape)}, plain version {ref.dtype} "
                             f"{tuple(ref.shape)}")
    k, r = got.float(), ref.float()
    diff = (k - r).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / r.abs().clamp_min(1e-30)).max())
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(k.abs(), r.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ok = bool((diff <= ulp).all())
        tol = "1 bf16 ulp"
    else:
        ok = bool((diff <= 1e-5 + 1e-5 * r.abs()).all())
        tol = "1e-5 + 1e-5*|ref|"
    del diff, k, r
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs {max_abs}, max rel "
                             f"{max_rel}, tolerance {tol})")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "tol": tol}


def times(kernel, plain, library, iters: int) -> dict:
    """Device times of a kernel, its plain version and one library call
    (None where there is none), plus the kernel's per-call event time."""
    k = timed(kernel, iters)
    return {"ms": k["ms"], "timer": k["timer"], "event_ms": k["event_ms"],
            "plain_ms": device_ms(plain, iters)[0],
            "library_ms": device_ms(library, iters)[0] if library else None}


def check_kernels(torch, K):
    """Phase 3: every kernel against its plain version, and timed."""
    from repro_torch.core import coding, unlearning
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.calibrate.ops import calibrate_update
    from repro_torch.kernels.calibrate.ref import calibrate_update_ref
    from repro_torch.kernels.coded_matmul.ops import (coded_matmul,
                                                      coded_matmul_rounds)
    from repro_torch.kernels.coded_matmul.ref import (coded_matmul_ref,
                                                      coded_matmul_rounds_ref)
    from repro_torch.models import init_params
    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p_client = 206_922                      # cnn-paper parameters
    p_shard = 5 * p_client                  # M = 5 clients per shard
    heads = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # coded_matmul: stage encode (G=30 rounds concatenated), fp32 and bf16;
    # the erasure decode (4,4)@(4, M*P); ragged shapes
    cm_cases = [("encode", 20, 4, 30 * p_shard, torch.float32, 20),
                ("encode_bf16", 20, 4, 30 * p_shard, torch.bfloat16, 20),
                ("decode", 4, 4, p_shard, torch.float32, 100),
                ("ragged_p", 20, 4, 1029, torch.float32, 50),
                ("c1_s1", 1, 1, 7, torch.float32, 50),
                ("c33_s16", 33, 16, 4099, torch.bfloat16, 50)]
    for label, c, s, p, dt, iters in cm_cases:
        coeff, w = randn(c, s), randn(s, p)
        err = compare(coded_matmul(coeff, w, out_dtype=dt),
                      coded_matmul_ref(coeff, w, dt), f"coded_matmul/{label}")
        ob = 2 if dt == torch.bfloat16 else 4
        b_ms, b_by = bound(4 * (c * s + s * p) + ob * c * p, 2 * c * s * p)
        row = times(lambda: coded_matmul(coeff, w, out_dtype=dt),
                    lambda: coded_matmul_ref(coeff, w, dt),
                    (lambda: torch.matmul(coeff, w))
                    if dt == torch.float32 else None, iters)
        row.update(kernel="coded_matmul", case=label, shape=[c, s, p],
                   out_dtype=str(dt), **err, bound_ms=b_ms, bound_by=b_by,
                   roofline_share=b_ms / row["ms"])
        log("kernel", **row)
        if label == "encode":
            heads["coded_matmul"] = row
            # the non-kernel copy around it: encode_batched's concatenate
            mats = list(w.reshape(s, 30, p_shard).unbind(1))
            mats = [m.contiguous() for m in mats]
            sch = coding.CodingScheme(4, 20)
            log("copy", what="encode_batched concatenate (30 rounds)",
                concat=timed(lambda: torch.cat(mats, dim=1), iters),
                encode_batched=timed(
                    lambda: coding.encode_batched(sch, mats), iters))
        del coeff, w

    # coded_matmul_rounds: the stage engine's encode of the (G,S,M*P) history
    for label, c, s, g, p, iters in [("stage_encode", 20, 4, 30, p_shard, 20),
                                     ("ragged", 3, 2, 2, 5, 50)]:
        coeff, w = randn(c, s), randn(g, s, p)
        err = compare(coded_matmul_rounds(coeff, w),
                      coded_matmul_rounds_ref(coeff, w),
                      f"coded_matmul_rounds/{label}")
        b_ms, b_by = bound(4 * (c * s + g * s * p + g * c * p),
                           2 * g * c * s * p)
        row = times(lambda: coded_matmul_rounds(coeff, w),
                    lambda: coded_matmul_rounds_ref(coeff, w),
                    lambda: torch.matmul(coeff, w), iters)
        row.update(kernel="coded_matmul_rounds", case=label,
                   shape=[c, s, g, p], **err, bound_ms=b_ms, bound_by=b_by,
                   roofline_share=b_ms / row["ms"])
        log("kernel", **row)
        if label == "stage_encode":
            heads["coded_matmul_rounds"] = row
        del coeff, w

    # calibrate: M' = 4 retained clients of the CNN; ragged shapes
    for label, m, p, iters in [("se_round", 4, p_client, 500),
                               ("m1_ragged", 1, 7, 200),
                               ("m9", 9, 4097, 200)]:
        w, d, cf = randn(p), randn(m, p), randn(m)
        err = compare(calibrate_update(w, d, cf),
                      calibrate_update_ref(w, d, cf), f"calibrate/{label}")
        b_ms, b_by = bound(4 * (p + m * p + m + p), 2 * m * p)
        row = times(lambda: calibrate_update(w, d, cf),
                    lambda: calibrate_update_ref(w, d, cf),
                    lambda: torch.addmv(w, d.t(), cf), iters)
        row.update(kernel="calibrate", case=label, shape=[m, p], **err,
                   bound_ms=b_ms, bound_by=b_by,
                   roofline_share=b_ms / row["ms"])
        log("kernel", **row)
        if label == "se_round":
            heads["calibrate"] = row
            # calibrate_stacked around the kernel: norms, coefficients,
            # flatten copies of the model and the deltas, unflatten
            model = init_params(get_config("cnn-paper"), 0, dev)
            deltas = tree_map(lambda v: v.unsqueeze(0).expand(
                m, *v.shape).contiguous(), model)
            norms = torch.ones(m, device=dev)
            log("copy", what="calibrate_stacked (norms + flatten + kernel "
                "+ unflatten) at M'=4", **timed(
                    lambda: unlearning.calibrate_stacked(model, deltas,
                                                         norms), iters))
        del w, d, cf
    torch.cuda.empty_cache()
    return heads


def check_small(torch):
    """Phase 4: a tiny scenario on the card against the same run on the
    CPU through the kernels' plain versions."""
    from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                           UnlearnRequest, build_session)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = ScenarioConfig(num_clients=8, clients_per_round=4,
                             num_shards=2, local_epochs=2, global_rounds=2,
                             samples_per_client=20, image_size=8,
                             local_batch=10, schedule=RequestSchedule(
                                 [UnlearnRequest(lambda plan: [
                                     plan.shard_clients[0][0]])]))
        session, _ = build_session(cfg, device=dev)
        rep = session.run(1, schedule=cfg.schedule)
        res = rep.stages[0].unlearn[0]
        out[dev] = (rep.store_stats.to_dict(), res.cost_units,
                    {s: {k: v.cpu() for k, v in m.items()}
                     for s, m in res.models.items()})
    (gs, gc, gm), (cs, cc, cm) = out["cuda"], out["cpu"]
    if gs != cs or gc != cc:
        raise AssertionError(f"small run: StoreStats/cost differ on the card "
                             f"({gs}, {gc}) and the CPU ({cs}, {cc})")
    worst = 0.0
    for s in cm:
        for k in cm[s]:
            torch.testing.assert_close(gm[s][k], cm[s][k], rtol=1e-3,
                                       atol=1e-4)
            worst = max(worst, float((gm[s][k] - cm[s][k]).abs().max()))
    log("small", store_stats_equal=True, cost_units=gc,
        max_abs_diff_vs_cpu=worst, tol="rtol 1e-3, atol 1e-4")


def rel_err(a: dict, b: dict) -> float:
    num = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    den = max(float(b[k].float().abs().max()) for k in b)
    return num / den


def main_path(torch, K, model_cfg, fl, scen, local_batch=20):
    """Phase 5: the paper's pipeline through the port's entry points at
    ``model_cfg`` / ``fl`` with ``scen``'s data fields; launch counts are
    read around the driving."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core import unlearning
    from repro_torch.data.federated import get_partitioner
    from repro_torch.fl import FLSimulator
    from repro_torch.fl.experiment import FederatedSession, UnlearnRequest
    from repro_torch.fl.tasks import ClassificationTask

    task = ClassificationTask()
    clients, (tx, ty) = task.build_data(scen, model_cfg,
                                        get_partitioner("iid"))

    def simulator():
        return FLSimulator(model_cfg, fl, clients, task,
                           opt_cfg=OptimizerConfig(name="sgd", lr=0.05,
                                                   grad_clip=0.0),
                           local_batch=local_batch, seed=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    walls = {}
    fused = FederatedSession(simulator(), store_kind="coded", engine="fused")
    t0 = time.perf_counter()
    rec = fused.run_stage()
    torch.cuda.synchronize()
    walls["train_fused_s"] = time.perf_counter() - t0
    plan = rec.plan
    before = {s: {k: v.clone() for k, v in m.items()}
              for s, m in rec.shard_models.items()}
    victim = plan.shard_clients[0][0]
    t0 = time.perf_counter()
    se = fused.unlearn(UnlearnRequest([victim], request_id="se-1"))[0]
    walls["unlearn_se_s"] = time.perf_counter() - t0
    pair = [plan.shard_clients[1][0], plan.shard_clients[2][0]]
    t0 = time.perf_counter()
    batched = fused.unlearn(UnlearnRequest(pair, request_id="se-2"))[0]
    walls["unlearn_batched_se_s"] = time.perf_counter() - t0
    staged = FederatedSession(simulator(), store_kind="coded", engine="stage")
    t0 = time.perf_counter()
    srec = staged.run_stage()
    torch.cuda.synchronize()
    walls["train_stage_engine_s"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("main", launches=launches, peak_mem_bytes=peak, **walls)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # -- checks -----------------------------------------------------------
    sch = rec.store.scheme
    other = [i for i in range(sch.num_clients)
             if i not in set(sch.quorum().tolist())]
    for name, r in (("fused", rec), ("stage", srec)):
        for s, cs in r.plan.shard_clients.items():
            stored0 = r.store.get_shard(0, s)
            stacked = {k: torch.stack([stored0[c][k] for c in cs])
                       for k in stored0[cs[0]]}
            fedavg = unlearning.stacked_mean(stacked)
            e = rel_err(fedavg, r.round_globals[s][1])
            alt = r.store.get_shard(0, s, available=other)
            e_alt = max(rel_err(alt[c], stored0[c]) for c in cs)
            log("check", engine=name, shard=s,
                decoded_fedavg_vs_round1_rel_err=e,
                other_subset_decode_rel_err=e_alt)
            if not (e <= 1e-4 and e_alt <= 1e-4):
                raise AssertionError(f"{name} shard {s}: decode check "
                                     f"failed ({e}, {e_alt})")
    slice_diff = max(
        float((srec.store._slices[g].float()
               - rec.store._slices[g].float()).abs().max())
        / float(rec.store._slices[g].float().abs().max())
        for g in (0, fl.global_rounds - 1))
    log("check", stage_vs_fused_slices_rel_diff=slice_diff)

    for res, hit in ((se, [0]), (batched, [1, 2])):
        if res.impacted_shards != hit:
            raise AssertionError(f"impacted {res.impacted_shards} != {hit}")
        for s, m in res.models.items():
            for k, v in m.items():
                if not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"non-finite unlearned model {s}/{k}")
            if s not in hit:
                for k in m:
                    if not torch.equal(m[k], before[s][k]):
                        raise AssertionError(f"untouched shard {s} changed")
    acc = {"trained": fused.sim.evaluate(rec.shard_models, tx, ty),
           "se": fused.sim.evaluate(se.models, tx, ty),
           "batched_se": fused.sim.evaluate(batched.models, tx, ty),
           "stage_engine": staged.sim.evaluate(srec.shard_models, tx, ty)}
    log("check", ensemble=acc, se_cost_units=se.cost_units,
        batched_se_cost_units=batched.cost_units,
        store_stats=rec.store.stats.to_dict())
    for name, m in acc.items():
        if not m["acc"] > 0.1:
            raise AssertionError(f"{name} ensemble at or below chance: {m}")
    profile_round(torch, fused.sim, plan)
    return launches


def profile_round(torch, sim, plan):
    """Where a stage's time goes: one fused ``shard_round`` (M clients, L
    epochs) timed on the host clock, then traced for its device time."""
    clients = plan.shard_clients[sorted(plan.shard_clients)[0]]
    xs, ys = sim._stack_client_data(clients)
    w = {k: v.unsqueeze(0) for k, v in sim.init_model(0).items()}

    def run():
        sim.shard_round(w, xs[None], ys[None], sim.fl.local_epochs, "flat")
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = trace_device(run) or {}
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    steps = sim.fl.local_epochs * (xs.shape[1] // sim.local_batch)
    log("profile", what=f"one fused shard_round: {len(clients)} clients, "
        f"{steps} SGD steps", wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=(max(0.0, 1 - busy_ms / wall_ms) if by_name
                           else None),
        top_ms=[[n[:80], ms] for n, ms in top])


def main() -> int:
    root = Path(__file__).resolve().parent
    src = root / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import kernels as K

    t_start = time.perf_counter()
    smi = nvidia_smi()
    K.resolve_device("cuda")
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    K.load_library()
    ptxas = [ln.strip() for ln in K.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", build_s=K.BUILD_INFO["build_s"], ptxas=ptxas)

    heads = check_kernels(torch, K)
    check_small(torch)
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.fl.experiment import ScenarioConfig
    launches = main_path(
        torch, K, get_config("cnn-paper"),
        FLConfig(num_clients=100, clients_per_round=20, num_shards=4,
                 local_epochs=10, global_rounds=30, retrain_ratio=2),
        ScenarioConfig.paper_full(noise=0.25))

    sources = {"coded_matmul": ("src/repro_torch/kernels/csrc/coded_matmul.cu",
                                "src/repro/kernels/coded_matmul/kernel.py:47"),
               "coded_matmul_rounds": (
                   "src/repro_torch/kernels/csrc/coded_matmul.cu",
                   "src/repro/kernels/coded_matmul/kernel.py:82"),
               "calibrate": ("src/repro_torch/kernels/csrc/calibrate.cu",
                             "src/repro/kernels/calibrate/kernel.py:28")}
    rows = []
    for name, (source, replaces) in sources.items():
        h = heads[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                     "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                     "bound_by": h["bound_by"],
                     "library_ms": h["library_ms"]})
    log("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
