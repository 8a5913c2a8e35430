#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — the card, its capability, CUDA version and power limit;
   exits 1 before anything else when CUDA is not available.
2. build   — compiles ``apex_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
3. kernels — LayerNorm forward, flash forward and decode attention
   against their plain PyTorch versions on the card at the serving
   path's shapes, fp32 and bf16 (scale-aware error max|a-b|/(max|b|+1)
   <= 2e-5 fp32, <= 2e-2 bf16), each timed as the median device time
   of 50 launches between CUDA events beside its plain version, one
   PyTorch library call computing the same function (a yardstick the
   port never calls) and its bound (the larger of bytes over 3.35 TB/s
   and FLOPs over the peak for the operand type).
4. serve   — ``InferenceServer`` on GPT-2 small at full width (seeded
   random weights), 8 decode slots, 16-token blocks, flash prefill,
   16 prompts of 4..255 tokens, 32 new tokens each:
   (a) fp32 cache, TF32 off: tokens against greedy full recompute on
       the card (the port's model with plain attention and plain
       LayerNorm: it launches none of the three kernels); a mismatch is
       allowed only where the oracle's top-2 logit gap is < 1e-3, and
       ends that request's comparison;
   (b) the default bf16 cache, timed: tokens/s (median of 3 passes),
       occupancy, preemptions.
   Both check that every kernel's launch count rose by exactly its
   per-prefill and per-decode-step count, and that ``stats()`` reports
   the same counts.  (c) repeats (b) under
   ``torch.profiler``: device time by kernel class and the device's
   idle share of the wall time.

The line before the last is ``{"kernels": [...]}``; before it, the
card's name and power limit as nvidia-smi prints them; the last line is
``{"ok": true, "device": {...}}``.  Longer records go to
``chiprun_out/chip_smoke/``.
"""

import functools
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # fp32 on the CUDA cores
              "bfloat16": 989e12}  # dense bf16 tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NEAR_TIE_GAP = 1e-3
TIMED_LAUNCHES = 50
TIMED_SERVE_PASSES = 3
SPIN_CYCLES = 2_000_000   # ~1 ms at the H100's clock


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def scale_aware_err(a, b):
    a = a.float()
    b = b.float()
    max_abs = (a - b).abs().max().item()
    return max_abs / (b.abs().max().item() + 1.0), max_abs


def median_ms(fn, iters=TIMED_LAUNCHES, warmup=5):
    """Median device time of ``fn`` over ``iters`` launches, each between
    two CUDA events.  A ~1 ms spin kernel is queued before each start
    event, so the host has enqueued all of ``fn``'s work before the
    device reaches it: the events bracket device time, not the host's
    launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, dtype):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# -- phases ------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", name=name,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi_line)
    # fp32 matmuls in full fp32 wherever parity is checked
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi_line


def phase_build():
    from apex_tpu_torch._kernels import build_library, library
    t0 = time.perf_counter()
    lib = build_library()
    library()
    secs = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "build.log").write_text(log)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(secs, 3), library=str(lib.relative_to(REPO)),
         ptxas=ptxas[:24])


def _check(name, dtype, got, want):
    rel, max_abs = scale_aware_err(got, want)
    if not rel <= TOL[dtype]:
        raise AssertionError(f"{name} [{dtype}]: scale-aware error {rel:.3g} "
                             f"> {TOL[dtype]}")
    return rel, max_abs


def _ln_variants(torch):
    import torch.nn.functional as F
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for n1 in (8, 256):
            n2 = 768
            g = torch.Generator(device="cuda").manual_seed(n1)
            x = torch.randn(n1, n2, device="cuda", generator=g).to(dtype)
            w = 1 + 0.1 * torch.randn(n2, device="cuda", generator=g)
            b = 0.1 * torch.randn(n2, device="cuda", generator=g)

            def kernel():
                return ln.layer_norm_fwd(x, w, b, 1e-5)

            def plain():
                xhat, mean, invvar = ln._ln_forward_plain(x, 1e-5)
                return (xhat * w + b).to(dtype), mean, invvar

            dt = str(dtype).split(".")[1]
            y, mean, invvar = kernel()
            py, pmean, pinvvar = plain()
            rel, max_abs = _check("layer_norm_fwd", dt, y, py)
            for got, want in ((mean, pmean), (invvar, pinvvar)):
                r, m = _check("layer_norm_fwd stats", "float32", got, want)
                rel, max_abs = max(rel, r), max(max_abs, m)
            isz = x.element_size()
            nbytes = 2 * n1 * n2 * isz + 2 * n2 * 4 + 2 * n1 * 4
            bms, by = bound(nbytes, 8 * n1 * n2, "float32")
            out.append({
                "shape": [n1, n2], "dtype": dt, "rel_err": rel,
                "max_abs_err": max_abs,
                "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                "library_ms": median_ms(
                    lambda: F.layer_norm(x, (n2,), w.to(dtype),
                                         b.to(dtype), 1e-5)),
                "bound_ms": bms, "bound_by": by})
    return out


def _flash_variants(torch):
    import torch.nn.functional as F
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    out = []
    h, d = 12, 64
    for dtype in (torch.float32, torch.bfloat16):
        for s, length in ((16, 11), (100, 77), (256, 200), (1024, 1000)):
            g = torch.Generator(device="cuda").manual_seed(s)
            q, k, v = (torch.randn(1, s, h, d, device="cuda", generator=g)
                       .to(dtype) for _ in range(3))
            mask = torch.where(torch.arange(s, device="cuda") < length, 0.0,
                               -1e9)[None].float()
            scale = 1.0 / d ** 0.5

            def kernel():
                return fa.flash_attention(q, k, v, kv_mask=mask, causal=True,
                                          return_lse=True)

            def plain():
                return fa._reference(q, k, v, mask, True, scale,
                                     return_lse=True)

            dt = str(dtype).split(".")[1]
            o, lse = kernel()
            po, plse = plain()
            rel, max_abs = _check("flash_fwd", dt, o, po)
            r, m = _check("flash_fwd lse", "float32", lse, plse)
            rel, max_abs = max(rel, r), max(max_abs, m)
            causal = torch.triu(torch.full((s, s), float("-inf"),
                                           device="cuda"), 1)
            sdpa_mask = (causal[None, None] + mask[:, None, None, :]).to(dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            isz = q.element_size()
            nbytes = 4 * s * h * d * isz + s * 4 + h * s * 4
            bms, by = bound(nbytes, 2 * h * s * s * d, dt)
            out.append({
                "shape": [1, s, h, d], "dtype": dt, "rel_err": rel,
                "max_abs_err": max_abs,
                "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                "library_ms": median_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=sdpa_mask)),
                "bound_ms": bms, "bound_by": by})
    return out


def _decode_variants(torch):
    import torch.nn.functional as F
    da = importlib.import_module("apex_tpu_torch.ops.decode_attention")
    out = []
    b, t, h, d = 8, 1025, 12, 64
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(7)
        q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(dtype)
        k, v = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
                for _ in range(2))
        # the engine's bias: cached context < length, then the live self
        # slot; slot 0 is an empty decode slot at position 0
        lengths = torch.randint(1, t - 1, (b,), device="cuda", generator=g)
        lengths[0] = 0
        pos = torch.arange(t, device="cuda")[None, :]
        bias = torch.where(pos < lengths[:, None], 0.0, -1e9).float()
        bias[:, -1] = 0.0
        scale = 1.0 / d ** 0.5

        def kernel():
            return da.cached_attention(q, k, v, kv_bias=bias)

        def plain():
            return da._reference(q, k, v, bias, scale)

        dt = str(dtype).split(".")[1]
        rel, max_abs = _check("decode_attention", dt, kernel(), plain())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_mask = bias[:, None, None, :].to(dtype)
        isz = q.element_size()
        nbytes = 2 * b * t * h * d * isz + 2 * b * h * d * isz + b * t * 4
        bms, by = bound(nbytes, 4 * b * h * t * d, dt)
        out.append({
            "shape": [b, t, h, d], "dtype": dt, "rel_err": rel,
            "max_abs_err": max_abs,
            "ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "library_ms": median_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask)),
            "bound_ms": bms, "bound_by": by})
    return out


# (name, source, TPU kernel it replaces, variant builder, summary variant)
KERNELS = (
    ("layer_norm_fwd", "apex_tpu_torch/csrc/layer_norm.cu",
     "apex_tpu/normalization/fused_layer_norm.py:63", _ln_variants,
     ([8, 768], "float32")),
    ("flash_fwd", "apex_tpu_torch/csrc/flash_fwd.cu",
     "apex_tpu/ops/flash_attention.py:161", _flash_variants,
     ([1, 256, 12, 64], "float32")),
    ("decode_attention", "apex_tpu_torch/csrc/decode_attention.cu",
     "apex_tpu/ops/decode_attention.py:125", _decode_variants,
     ([8, 1025, 12, 64], "float32")),
)


def phase_kernels():
    import torch
    results = {}
    for name, source, replaces, variants, summary in KERNELS:
        rows = variants(torch)
        for row in rows:
            emit("kernels", kernel=name, **row)
        main = next(r for r in rows
                    if r["shape"] == summary[0] and r["dtype"] == summary[1])
        results[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "dtype": main["dtype"],
            "variants": rows}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "kernels.json").write_text(json.dumps(results, indent=1))
    return results


def _make_prompts(cfg, n=16, seed=0):
    # examples/serving/serve_gpt.py's traffic at --config small
    rng = np.random.RandomState(seed)
    max_ctx = cfg.max_position_embeddings
    return [list(rng.randint(0, cfg.vocab_size,
                             size=int(rng.randint(4, max(8, max_ctx // 4)))))
            for _ in range(n)]


def _serve_once(server, prompts, max_new):
    """Drive the main path once with every launch count at 0 just
    before and read just after; checks the counts against the model's
    2L+1 LayerNorms and L attentions per forward."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    server.reset_meters()
    t0 = time.perf_counter()
    outs = server.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = server.stats()
    layers = server.engine.cfg.num_hidden_layers
    want = {"layer_norm_fwd": (2 * layers + 1)
            * (st["prefills"] + st["decode_steps"]),
            "flash_fwd": layers * st["prefills"],
            "decode_attention": layers * st["decode_steps"]}
    if counts != want or not all(counts.values()) \
            or st["kernel_launches"] != counts:
        raise AssertionError(f"kernel launches {counts} (stats() "
                             f"{st['kernel_launches']}) != expected {want} "
                             f"({st['prefills']} prefills, "
                             f"{st['decode_steps']} decode steps)")
    server.scheduler.audit()
    if server.engine.allocator.num_free != \
            server.engine.cache_cfg.num_blocks - 1:
        raise AssertionError("blocks leaked after generate")
    vocab = server.engine.cfg.vocab_size
    for o in outs:
        if len(o) != max_new or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"malformed completion: {o}")
    return outs, wall, counts, st


def _plain_layer_norm(mod, x):
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    n2 = mod.scale.numel()
    xhat, _, _ = ln._ln_forward_plain(x.reshape(-1, n2), mod.eps)
    return (xhat * mod.scale + mod.bias).to(x.dtype).reshape(x.shape)


def _plain_oracle(model):
    """``model`` with every LayerNorm on its plain PyTorch version; its
    attention is the model's plain default.  The oracle then shares no
    kernel with the server it checks."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    for mod in model.modules():
        if isinstance(mod, ln.FusedLayerNorm):
            mod.forward = functools.partial(_plain_layer_norm, mod)
    return model


def _oracle_check(model, prompts, outs):
    """Greedy full recompute on the card through the plain oracle;
    returns (tokens compared, near-ties that ended a comparison).  Fails
    if the oracle launched any of the port's kernels."""
    import torch
    from apex_tpu_torch._kernels import launch_counts
    from apex_tpu_torch.ops import greedy_argmax
    compared = near_ties = 0
    before = launch_counts()
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            toks = list(p)
            for t, got in enumerate(o):
                ids = torch.tensor([toks], device="cuda")
                logits = model(ids)[0, -1]
                ref = int(greedy_argmax(logits))
                top2 = torch.topk(logits, 2).values
                gap = float(top2[0] - top2[1])
                if got != ref:
                    if gap < NEAR_TIE_GAP:
                        near_ties += 1
                        break
                    raise AssertionError(
                        f"token {t} of a {len(p)}-token prompt: served {got}"
                        f" != oracle {ref} (top-2 gap {gap:.3g})")
                compared += 1
                toks.append(got)
    if launch_counts() != before:
        raise AssertionError("the full-recompute oracle launched a port "
                             "kernel")
    return compared, near_ties


def phase_serve():
    import torch
    from apex_tpu_torch.models import GPTLMHeadModel, gpt_small
    from apex_tpu_torch.serving import InferenceServer

    cfg = gpt_small()
    model = GPTLMHeadModel(cfg, device="cuda", seed=0).eval()
    params = model.state_dict()
    oracle = _plain_oracle(model)
    prompts = _make_prompts(cfg)
    max_new = 32
    common = dict(device="cuda", max_batch_size=8, block_size=16)
    results = {}

    # (a) fp32 cache against greedy full recompute
    server = InferenceServer(cfg, params, cache_dtype=torch.float32, **common)
    outs_a, wall, counts, st = _serve_once(server, prompts, max_new)
    compared, near_ties = _oracle_check(oracle, prompts, outs_a)
    results["fp32"] = {"wall_s": wall, "tokens_per_s": st["tokens_generated"]
                       / wall, "launches": counts, "stats": st,
                       "oracle_tokens_compared": compared,
                       "near_ties": near_ties}
    emit("serve", cache="float32", tokens=st["tokens_generated"],
         wall_s=round(wall, 4), prefills=st["prefills"],
         decode_steps=st["decode_steps"], launches=counts,
         oracle_tokens_compared=compared, near_ties=near_ties,
         preemptions=st["preemptions"])
    del server

    # (b) the default bf16 cache, timed after one warm-up pass; the wall
    # is host-bound and the host's CPU is shared, so several passes
    server = InferenceServer(cfg, params, **common)
    server.generate(prompts[:2], max_new_tokens=2)
    passes = []
    for _ in range(TIMED_SERVE_PASSES):
        server.engine.reset_cache()
        outs_b, wall, counts, st = _serve_once(server, prompts, max_new)
        passes.append(st["tokens_generated"] / wall)
    tokens_per_s = statistics.median(passes)
    agree = sum(a == b for oa, ob in zip(outs_a, outs_b)
                for a, b in zip(oa, ob)) / (len(prompts) * max_new)
    results["bf16"] = {"tokens_per_s": tokens_per_s,
                       "tokens_per_s_passes": passes, "launches": counts,
                       "stats": st, "token_agreement_with_fp32": agree}
    emit("serve", cache="bfloat16", tokens=st["tokens_generated"],
         tokens_per_s=tokens_per_s, tokens_per_s_passes=passes,
         batch_occupancy_avg=st["batch_occupancy_avg"],
         queue_depth_peak=st["queue_depth_peak"],
         preemptions=st["preemptions"], prefills=st["prefills"],
         decode_steps=st["decode_steps"], launches=counts,
         token_agreement_with_fp32=round(agree, 4))
    results["profile"] = _profile_serve(server, prompts, max_new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "serve.json").write_text(json.dumps(results, indent=1,
                                                   default=str))
    return counts


# device-time classes of the serve pass's kernels, by kernel-name fragment
KERNEL_CLASSES = (
    ("layer_norm_fwd (port)", ("layer_norm_fwd_kernel",)),
    ("flash_fwd (port)", ("flash_fwd_kernel",)),
    ("decode_attention (port)", ("decode_attention_kernel",)),
    ("gemm", ("gemm", "gemv", "xmma", "cutlass", "cublas")),
    ("gather/scatter", ("index", "gather", "scatter")),
    ("copy/cast/cat", ("copy", "cat", "Cat")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise",)),
)


def _profile_serve(server, prompts, max_new):
    """One more bf16 serve pass under ``torch.profiler``: device time by
    kernel class and the device's idle share of the pass's wall time.
    Reports ``"not measured"`` when the profiler records no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    server.engine.reset_cache()
    server.reset_meters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.generate(prompts, max_new_tokens=max_new)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        emit("profile", device_time="not measured")
        return {"device_time": "not measured"}
    by_class, by_name, busy_us, end_us = {}, {}, 0.0, None
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        if end_us is None or start >= end_us:
            busy_us += end - start
            end_us = end
        elif end > end_us:
            busy_us += end - end_us
            end_us = end
        dur = end - start
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e.name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    st = server.stats()
    steps = st["prefills"] + st["decode_steps"]
    total = sum(by_class.values())
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "kernel_ms_total": total / 1e3, "kernel_launches": len(kernels),
           "engine_steps": steps,
           "by_class_ms": {c: v / 1e3 for c, v in
                           sorted(by_class.items(), key=lambda kv: -kv[1])},
           "top_kernels_ms": {n[:120]: v / 1e3 for n, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:15]}}
    emit("profile", wall_ms=round(out["wall_ms"], 3),
         device_busy_ms=round(out["device_busy_ms"], 3),
         device_idle_share=round(out["device_idle_share"], 4),
         kernel_launches=len(kernels), engine_steps=steps,
         by_class_ms={c: round(v, 3) for c, v in
                      out["by_class_ms"].items()})
    return out


def main(phases=("device", "build", "kernels", "serve")):
    t_start = time.perf_counter()
    name, smi_line = phase_device()
    sys.path.insert(0, str(REPO))
    import torch
    kernels = None
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels = phase_kernels()
    if "serve" in phases:
        counts = phase_serve()
        for k in kernels.values():
            k["launches"] = counts[k["name"]]
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(smi_line)
    if kernels is not None:
        print(json.dumps({"kernels": [
            {key: v for key, v in k.items() if key != "variants"}
            for k in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
