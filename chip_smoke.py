"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (PATH, $CUDA_HOME or /usr/local/cuda) and the
repository checkout it sits in. Phases, each of which fails the run:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the serving and training paths from
   elasticdl_tpu_torch/csrc (flash_fwd.cu, flash_bwd.cu, paged_decode.cu;
   one nvcc per source, all at once);
3. kernel A (flash forward) against its plain PyTorch version at the
   prefill shapes;
4. kernel B (paged decode partials) against its plain version at the
   decode shapes;
5. kernels C and D (flash backward dq, dk/dv) against their plain
   versions: b = 2, h = 8 with 8 and 2 kv heads, l = 64 / 200 / 1024,
   d = 128, causal and not, bf16 and fp32; then FlashAttentionFunction's
   gradients on the card against the plain versions on the CPU, fp32;
6. the serving slice at the flagship transformer_lm width (vocab 32000,
   seq_len 1024, embed 1024, 8 heads, 8 layers, bf16, seeded random
   weights): 16 greedy requests, 8 sharing a 256-token prefix, through
   the port's GenerationServer (8 slots, paged KV, block 16, prefix
   sharing). Every request must finish with its full token count and
   the serving kernels (A, B) must have launched during that run. Then a
   2-layer model at the same width, with weights made by numpy, runs one
   prompt and 8 decode steps on the card and on the CPU (plain
   versions); the logits must agree;
7. where a decode step's time goes (host clock, torch.profiler);
8. the training slice at the same flagship width (bf16 compute over fp32
   parameters, AdamW 3e-4, weight decay 0.01): the port's RecordWriter
   writes token records of 1025 tokens, and LocalExecutor(minibatch 8,
   max_steps 4) trains on them. Every loss must be finite and the first
   near its value at initialisation, and kernels A, C and D must each
   launch once per layer in every step. Then a 2-layer model at the same
   width with numpy weights takes one train_step in bf16 on the card and
   on the CPU: the loss and each parameter's gradient norm must agree;
   and one profiled step shows where a training step's time goes;
9. kernel timings at the main paths' shapes (CUDA events, graph-replayed
   for device time), beside the plain version, a library call where one
   computes the same function, and the bound implied by the card's
   published peaks.

It prints a `kernels` JSON line, a `serving` JSON line, a `training`
JSON line, the nvidia-smi line and, last, {"ok": true, "device": {...}}.
fp32 comparisons run with TF32 off (torch.backends.cuda.matmul / cudnn
allow_tf32 = False).
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.api.generation import kv_layout
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.model_utils import load_model_spec_from_module
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.data.example_codec import encode_example
from elasticdl_tpu_torch.data.record_format import RecordWriter
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import attention as att
from elasticdl_tpu_torch.serving.kv_pool import PagedKVPool
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig
from elasticdl_tpu_torch.training.trainer import Trainer

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab_size=32000, seq_len=1024, embed_dim=1024,
                num_heads=8, num_layers=8, dtype=torch.bfloat16)
FLASH_TOL_OUT, FLASH_TOL_LSE = 2e-2, 1e-3
PAGED_TOL_REL = 1e-3
LOGIT_TOL_REL = 5e-2
# flash backward against its plain version, max |err| / max |ref| per
# output: fp32 sums in another order (1e-4); bf16 outputs rounded once
# more or less than the plain version's (2^-8 of the largest value)
BWD_TOL_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# a bf16 train step on the card against the same step on the CPU: the
# loss, and each parameter's gradient norm, by relative error (bf16
# rounding at other places in cuBLAS and the CPU kernels)
STEP_LOSS_TOL_REL = 1e-2
STEP_GRAD_NORM_TOL_REL = 5e-2
SERVING_KERNELS = ("flash_fwd", "paged_decode", "paged_decode_tile")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_BATCH, TRAIN_STEPS = 8, 4


class SmokeFailure(Exception):
    pass


def check(cond, message):
    if not cond:
        raise SmokeFailure(message)


def log(*args):
    print(*args, flush=True)


def _events_ms(run, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_ms(fn, iters=50, warmup=3):
    """(device ms, eager ms) of one fn() call. Device: fn captured once in
    a CUDA graph and replayed `iters` times between CUDA events, so the
    host's launch overhead is not in it. Eager: `iters` plain calls
    between events, which includes the wrapper's host work whenever the
    host is slower than the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, iters), _events_ms(fn, iters)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def flash_work(b, h, hkv, lq, lk, d, itemsize):
    """(operations, bytes) of one causal flash forward: 4*d operations
    per visible (query, key) pair; q, k, v read once, out and the fp32
    lse written once."""
    pairs = sum(min(i + 1, lk) for i in range(lq))
    flops = 4 * d * pairs * b * h
    nbytes = itemsize * d * (2 * b * h * lq + 2 * b * hkv * lk) + 4 * b * h * lq
    return flops, nbytes


def paged_work(lengths, hkv, n_rows, d, itemsize, m):
    """(operations, bytes) of one paged partials call over the live rows
    only: each cached row k_pos < length is read once per kv head (K and
    V), 4*d operations per (query row, live row); fp32 query rows and
    partials move once, plus the table and lengths."""
    live = int(sum(lengths))
    b = len(lengths)
    flops = 4 * d * n_rows * hkv * live
    nbytes = (2 * itemsize * d * hkv * live
              + 4 * b * hkv * n_rows * (2 * d + 2) + 4 * b * (m + 1))
    return flops, nbytes


# ------------------------------------------------------------ kernel checks


def flash_inputs(gen, b, h, hkv, l, d, dtype):
    def mk(heads):
        return torch.randn(b, heads, l, d, generator=gen).to("cuda", dtype)

    return mk(h), mk(hkv), mk(hkv)


def check_flash(gen):
    """Kernel A against flash_attention_plain at the prefill shapes."""
    worst_out = worst_lse = 0.0
    cases = [(8, 8, 64), (8, 8, 200), (8, 8, 1024), (8, 2, 200)]
    for h, hkv, l in cases:
        q, k, v = flash_inputs(gen, 1, h, hkv, l, 128, torch.bfloat16)
        out, lse = att.flash_forward(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref, ref_lse = att.flash_attention_plain(q, k, v, causal=True)
        e_out = (out.float() - ref.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        log("flash h=%d hkv=%d lq=%d bf16: out err %.3g, lse err %.3g"
            % (h, hkv, l, e_out, e_lse))
        check(torch.isfinite(out.float()).all().item(), "flash: non-finite")
        check(e_out <= FLASH_TOL_OUT and e_lse <= FLASH_TOL_LSE,
              "flash kernel disagrees with its plain version at h=%d "
              "hkv=%d lq=%d: %.3g / %.3g" % (h, hkv, l, e_out, e_lse))
        worst_out, worst_lse = max(worst_out, e_out), max(worst_lse, e_lse)
    return worst_out, worst_lse


def paged_inputs(gen, b=8, hkv=8, group=1, t=1, d=128, bs=16, m=64,
                 num_blocks=640, lengths=None):
    if lengths is None:
        lengths = torch.randint(1, 1000, (b,), generator=gen)
    lengths = torch.as_tensor(lengths)
    table = torch.full((b, m), -1, dtype=torch.int32)
    perm = torch.randperm(num_blocks, generator=gen)
    used = 0
    for i in range(b):
        n = -(-int(lengths[i]) // bs)
        table[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    pools = [torch.randn(num_blocks, bs, hkv, d, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(2)]
    qf = (torch.randn(b, hkv, group * t, d, generator=gen)
          * d ** -0.5).to("cuda")
    return (qf, pools[0], pools[1], table.cuda(),
            lengths.to(torch.int32).cuda()), lengths.tolist()


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def check_paged(gen):
    """Kernel B against paged_decode_partials_plain at the decode shapes
    (t = 1 decode and t = 8 through the split kernel, t = 40 through the
    tile kernel), bf16 arenas, -1 padded tables."""
    worst_abs = worst_rel = 0.0
    for t in (1, 8, 40):
        args, _lengths = paged_inputs(gen, t=t)
        o, l, mx = att.paged_decode_partials(*args)
        torch.cuda.synchronize()
        po, pl, pm = att.paged_decode_partials_plain(*args)
        errs = [rel_err(o, po), rel_err(l, pl), rel_err(mx, pm)]
        e_abs = (o - po).abs().max().item()
        log("paged t=%d: rel err o %.3g l %.3g m %.3g" % (t, *errs))
        check(all(e <= PAGED_TOL_REL for e in errs),
              "paged kernel disagrees with its plain version at t=%d: %s"
              % (t, errs))
        worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel,
                                                          max(errs))
    return worst_abs, worst_rel


def check_flash_bwd(gen):
    """Kernels C (dq, and delta) and D (dk/dv) against their plain
    versions, on the same inputs and the forward kernel's out and lse.
    Returns {kernel: {"max_abs_err", "max_rel_err"}}, worst over cases;
    rel is max |err| / max |ref| of each output."""
    worst = {"flash_bwd_dq": [0.0, 0.0], "flash_bwd_dkv": [0.0, 0.0]}
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for h, hkv, l in ((8, 8, 64), (8, 8, 200), (8, 8, 1024),
                              (8, 2, 200), (8, 2, 1024)):
                q, k, v = flash_inputs(gen, 2, h, hkv, l, 128, dtype)
                do = flash_inputs(gen, 2, h, h, l, 128, dtype)[0]
                out, lse = att.flash_forward(q, k, v, causal=causal)
                dq, delta = att.flash_backward_dq(q, k, v, out, lse, do,
                                                  causal=causal)
                dk, dv = att.flash_backward_dkv(q, k, v, do, lse, delta,
                                                causal=causal)
                torch.cuda.synchronize()
                pdq, pdelta = att.flash_backward_dq_plain(
                    q, k, v, out, lse, do, causal=causal)
                pdk, pdv = att.flash_backward_dkv_plain(
                    q, k, v, do, lse, pdelta, causal=causal)
                errs = {}
                for name, pairs in (
                        ("flash_bwd_dq", ((dq, pdq), (delta, pdelta))),
                        ("flash_bwd_dkv", ((dk, pdk), (dv, pdv)))):
                    rel = max(rel_err(a.float(), b.float()) for a, b in pairs)
                    e_abs = max((a.float() - b.float()).abs().max().item()
                                for a, b in pairs)
                    finite = all(torch.isfinite(a.float()).all().item()
                                 for a, _b in pairs)
                    errs[name] = rel
                    check(finite, "%s: non-finite output" % name)
                    check(rel <= BWD_TOL_REL[dtype],
                          "%s disagrees with its plain version at h=%d "
                          "hkv=%d l=%d causal=%s %s: rel err %.3g"
                          % (name, h, hkv, l, causal, dtype, rel))
                    worst[name][0] = max(worst[name][0], e_abs)
                    worst[name][1] = max(worst[name][1], rel)
                log("flash bwd h=%d hkv=%d l=%d causal=%d %s: rel err dq "
                    "%.3g, dk/dv %.3g" % (h, hkv, l, causal,
                                          str(dtype)[6:], errs["flash_bwd_dq"],
                                          errs["flash_bwd_dkv"]))
    return {name: {"max_abs_err": e[0], "max_rel_err": e[1]}
            for name, e in worst.items()}


def check_autograd(gen):
    """FlashAttentionFunction's gradients on the card (forward and both
    backward kernels) against the same function on the CPU (plain
    versions), fp32 inputs, b = 2, h = 8, hkv = 2, l = 200, causal."""
    q, k, v = (x.float().cpu() for x in flash_inputs(
        gen, 2, 8, 2, 200, 128, torch.float32))
    w = torch.randn(2, 8, 200, 128, generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = att.flash_attention(*leaves, causal=True)
        check(type(out.grad_fn).__name__.startswith("FlashAttention"),
              "flash_attention did not record FlashAttentionFunction")
        (out * w.to(dev)).sum().backward()
        grads[dev] = [x.grad.cpu() for x in leaves]
    errs = [rel_err(a, b) for a, b in zip(grads["cuda"], grads["cpu"])]
    log("autograd cuda vs cpu (fp32): rel err dq %.3g dk %.3g dv %.3g"
        % tuple(errs))
    check(max(errs) <= BWD_TOL_REL[torch.float32],
          "FlashAttentionFunction gradients differ between the card and "
          "the CPU: %s" % errs)
    return max(errs)


# ------------------------------------------------------------ serving slice


def serve_flagship(rng):
    """16 greedy requests through the port's server at flagship width.
    Returns the serving metrics and the kernel launch counts of the run."""
    model = TransformerLM(device="cuda", seed=0, **FLAGSHIP)
    server = GenerationServer(model, ServingConfig(
        num_slots=8, queue_capacity=64, kv_block_size=16, kv_shared=True,
    )).start()
    try:
        # warm the card (cuBLAS handles, allocator) outside the counts
        server.generate([1, 2, 3, 4], 2)
        vocab = FLAGSHIP["vocab_size"]
        prefix = rng.randint(0, vocab, size=256).tolist()
        specs = []
        for i in range(16):
            p_len = int(rng.randint(32, 513))
            new = int(rng.randint(32, 129))
            if i % 2 == 0:
                p_len = max(p_len, 264)
                prompt = prefix + rng.randint(0, vocab,
                                              size=p_len - 256).tolist()
            else:
                prompt = rng.randint(0, vocab, size=p_len).tolist()
            specs.append((prompt, new))
        sched = server.scheduler
        n_steps, n_ttft = len(sched.step_secs), len(sched.ttft_secs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [server.submit(p, n) for p, n in specs]
        for req in reqs:
            for _chunk in server.events(req):
                pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(att.KERNEL_LAUNCHES)
        for req, (prompt, new) in zip(reqs, specs):
            check(len(req.generated) == new,
                  "request %d finished with %d of %d tokens"
                  % (req.request_id, len(req.generated), new))
            check(all(0 <= t < vocab for t in req.generated),
                  "token out of the vocabulary")
        kv = server.engine.kv_stats()
        ttft = np.asarray(sched.ttft_secs[n_ttft:]) * 1e3
        steps = np.asarray(sched.step_secs[n_steps:]) * 1e3
        tokens = sum(len(r.generated) for r in reqs)
        metrics = {
            "requests": len(reqs),
            "tokens_generated": tokens,
            "prompt_tokens": sum(len(p) for p, _n in specs),
            "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "decode_step_ms_p50": float(np.percentile(steps, 50)),
            "decode_step_ms_p99": float(np.percentile(steps, 99)),
            "decode_steps": int(steps.size),
            "mean_batch": float(np.mean(sched.step_batch[n_steps:])),
            "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
            "prefix_hit_tokens": kv["prefix_hit_tokens"],
            "kv_blocks_total": kv["kv_blocks_total"],
        }
    finally:
        server.stop(timeout=120)
    check(not server.scheduler.is_alive(), "scheduler did not stop")
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    for name in SERVING_KERNELS:
        check(launches[name] > 0,
              "kernel %s was not launched on the serving path" % name)
    return metrics, launches


def numpy_flax_params(cfg, seed):
    """transformer_lm params in the flax layout, drawn by numpy."""
    rs = np.random.RandomState(seed)
    e, v = cfg["embed_dim"], cfg["vocab_size"]

    def w(*shape):
        return (rs.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    def vec(n, base):
        return (base + 0.1 * rs.standard_normal(n)).astype(np.float32)

    params = {"wte/embedding": w(v, e) * np.sqrt(v / e),
              "wpe/embedding": w(cfg["seq_len"], e),
              "ln_f/scale": vec(e, 1.0), "ln_f/bias": vec(e, 0.0),
              "head/kernel": w(e, v)}
    for i in range(cfg["num_layers"]):
        blk = "block_%d/" % i
        params.update({
            blk + "LayerNorm_0/scale": vec(e, 1.0),
            blk + "LayerNorm_0/bias": vec(e, 0.0),
            blk + "LayerNorm_1/scale": vec(e, 1.0),
            blk + "LayerNorm_1/bias": vec(e, 0.0),
            blk + "attn/qkv/kernel": w(e, 3 * e),
            blk + "attn/proj/kernel": w(e, e),
            blk + "mlp_up/kernel": w(e, 4 * e),
            blk + "mlp_up/bias": vec(4 * e, 0.0),
            blk + "mlp_down/kernel": w(4 * e, e),
            blk + "mlp_down/bias": vec(e, 0.0),
        })
    return params


def logits_trace(model, prompt, forced):
    """Prefill logits [p, vocab] and the logits of len(forced) paged
    decode steps fed `forced` tokens (None: the step's own argmax),
    through the serving pool's write paths. Returns (prefill, decode
    logits, tokens fed)."""
    dev = model.device
    pool = PagedKVPool(kv_layout(model), model.seq_len, 1, 64, 16,
                       device=dev)
    p = len(prompt)
    pool.seat(0, prompt, p + len(forced))
    logits, kv = model(torch.as_tensor([prompt], device=dev))
    pool.write_prompt(kv, 0, p)
    fed, steps = [], []
    nxt = int(logits[0, -1].argmax())
    for i, tok in enumerate(forced):
        tok = nxt if tok is None else tok
        fed.append(tok)
        pos = p + i
        pool.ensure_blocks(0, pos)
        step, rows = model.decode_paged(
            torch.as_tensor([[tok]], device=dev),
            torch.as_tensor([pos], device=dev), pool.pools,
            pool.tables_device())
        pool.scatter([(k[:, :, 0], v[:, :, 0]) for k, v in rows],
                     [pool.tables[0, pos // 16]], [pos % 16])
        steps.append(step[0, 0])
        nxt = int(step[0, 0].argmax())
    return logits[0].float().cpu(), torch.stack(steps).float().cpu(), fed


def compare_cuda_cpu(rng):
    """A 2-layer flagship-width model on the card and on the CPU, same
    numpy weights, bf16 on both: prefill and 8 decode steps fed the
    card's greedy tokens."""
    cfg = dict(FLAGSHIP, num_layers=2)
    sd = params_from_flax(numpy_flax_params(cfg, seed=1))
    prompt = rng.randint(0, cfg["vocab_size"], size=64).tolist()
    runs = {}
    forced = [None] * 8
    for dev in ("cuda", "cpu"):
        model = TransformerLM(device=dev, **cfg)
        model.load_state_dict(sd)
        model.use_compute_weights()
        runs[dev] = logits_trace(model, prompt, forced)
        forced = runs[dev][2]
    out = {}
    for i, what in enumerate(("prefill", "decode")):
        gpu, cpu = runs["cuda"][i], runs["cpu"][i]
        scale = cpu.abs().max().item()
        err = (gpu - cpu).abs().max().item()
        log("cuda vs cpu %s logits: max err %.4g, max |logit| %.4g"
            % (what, err, scale))
        check(bool(torch.isfinite(gpu).all()), "non-finite %s logits" % what)
        check(err <= LOGIT_TOL_REL * scale,
              "%s logits: cuda and cpu differ by %.4g (limit %.4g)"
              % (what, err, LOGIT_TOL_REL * scale))
        out[what] = {"max_abs_err": err, "max_abs_logit": scale}
    return out


def device_summary(events, steps, step_ms, top, group=None):
    """Device time per step from a profiler's key_averages: the sum of
    the kernels' own time (events on the CUDA device; operator ranges,
    which report their kernels' time again, and user annotations such as
    `Optimizer.step`, which report the span of theirs, are left out), its
    share of `step_ms` (the step on the host clock, measured without the
    profiler, which slows the host but not the kernels), the `top`
    kernels, and the time of the kernels whose name contains `group`."""
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    ranked = sorted(kernels, key=dev_us, reverse=True)
    out = {
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "kernel_ms_per_step": {
            e.key[:60]: dev_us(e) / 1e3 / steps for e in ranked[:top]},
    }
    if group:
        ms = sum(dev_us(e) for e in kernels if group in e.key) / 1e3 / steps
        out["%s_kernels_ms_per_step" % group.strip("_")] = ms
        out["%s_kernels_share_of_device" % group.strip("_")] = (
            ms / device_ms if device_ms else None)
    return out


def profile_decode(rng, steps=10):
    """Where a decode step's time goes: the flagship engine with 8 active
    slots, `steps` steps timed on the host clock, then the same number
    under torch.profiler for the device's busy time and the top host
    and device entries."""
    from torch.profiler import ProfilerActivity, profile

    from elasticdl_tpu_torch.serving.admission import ServingRequest
    from elasticdl_tpu_torch.serving.engine import (
        PagedContinuousBatchingEngine,
    )

    engine = PagedContinuousBatchingEngine(
        TransformerLM(device="cuda", seed=0, **FLAGSHIP), 8, block_size=16)
    for _ in range(8):
        engine.insert(ServingRequest(
            rng.randint(0, FLAGSHIP["vocab_size"], size=256).tolist(),
            4 * steps + 8))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
    return {
        "batch": 8, "step_ms": step_ms, "step_ms_profiled": prof_ms,
        **device_summary(events, steps, step_ms, top=6),
        "top_host_ms_per_step": {
            e.key[:60]: e.self_cpu_time_total / 1e3 / steps
            for e in top_cpu},
        "host_ops_per_step": sum(e.count for e in events
                                 if e.key.startswith("aten::")) / steps,
    }


# ----------------------------------------------------------- training slice


def transformer_flops_per_step(batch, seq, d_model, n_layers, vocab):
    """Matmul operations of one forward + backward train step, bench.py's
    count: per token and layer 24 d^2 (qkv, proj, MLP) + 4 seq d
    (attention scores and values), plus 2 d vocab for the head; the
    backward is twice the forward."""
    per_token_layer = 24 * d_model * d_model + 4 * seq * d_model
    fwd = batch * seq * (n_layers * per_token_layer + 2 * d_model * vocab)
    return 3 * fwd


def _params_str(cfg):
    kw = dict(cfg, dtype="bf16")
    return "; ".join("%s=%r" % kv for kv in kw.items())


def _write_token_records(path, n, rng):
    """n records of seq_len + 1 tokens, as the zoo's dataset_fn reads
    them, through the port's own writer."""
    length = FLAGSHIP["seq_len"] + 1
    with RecordWriter(path) as w:
        for _ in range(n):
            w.write(encode_example({"tokens": rng.randint(
                0, FLAGSHIP["vocab_size"], size=(length,)).astype(np.int64)}))


def train_flagship(rng, workdir):
    """TRAIN_STEPS steps of the flagship model through LocalExecutor
    (minibatch TRAIN_BATCH) over token records on disk. Returns the
    training metrics, the executor and the kernel launches of the run."""
    data = os.path.join(workdir, "train")
    os.makedirs(data)
    _write_token_records(os.path.join(data, "tokens-00000.trec"),
                         TRAIN_BATCH * TRAIN_STEPS + 3, rng)
    executor = LocalExecutor(
        load_model_spec_from_module(tzoo), training_data=data,
        minibatch_size=TRAIN_BATCH, max_steps=TRAIN_STEPS,
        model_params=_params_str(FLAGSHIP), device="cuda")
    steps = []
    step_fn = executor.trainer.train_step

    def timed_step(state, batch, true_count=None):
        before = dict(att.KERNEL_LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch, true_count)
        torch.cuda.synchronize()
        steps.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {k: att.KERNEL_LAUNCHES[k] - before[k]
                         for k in TRAINING_KERNELS},
        })
        return out

    executor.trainer.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    t0 = time.perf_counter()
    state, _metrics = executor.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(att.KERNEL_LAUNCHES)
    executor.trainer.train_step = step_fn
    losses = executor.losses
    log("training losses: %s; step ms %s" % (
        losses, [round(s["ms"], 2) for s in steps]))
    check(state is not None and state.step == TRAIN_STEPS
          and len(losses) == TRAIN_STEPS,
          "LocalExecutor took %d steps, not %d" % (len(losses), TRAIN_STEPS))
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    # at initialisation the head's logits have unit variance (lecun-normal
    # kernel over a LayerNorm output), so the expected first loss is
    # ln(vocab) + 1/2, not ln(vocab)
    expected = math.log(FLAGSHIP["vocab_size"]) + 0.5
    check(abs(losses[0] - expected) <= 0.5,
          "first loss %.4f is not within 0.5 of ln(%d) + 1/2 = %.4f"
          % (losses[0], FLAGSHIP["vocab_size"], expected))
    layers = FLAGSHIP["num_layers"]
    for i, s in enumerate(steps):
        for name in TRAINING_KERNELS:
            check(s["launches"][name] == layers,
                  "step %d launched %s %d times, not once per layer (%d)"
                  % (i, name, s["launches"][name], layers))
    timed = np.asarray([s["ms"] for s in steps[1:]])
    step_ms = float(np.percentile(timed, 50))
    tokens = TRAIN_BATCH * FLAGSHIP["seq_len"]
    flops = transformer_flops_per_step(
        TRAIN_BATCH, FLAGSHIP["seq_len"], FLAGSHIP["embed_dim"], layers,
        FLAGSHIP["vocab_size"])
    metrics = {
        "model": "transformer_lm flagship, bf16 compute, fp32 params",
        "minibatch": TRAIN_BATCH, "seq_len": FLAGSHIP["seq_len"],
        "steps": TRAIN_STEPS,
        "step_ms": [s["ms"] for s in steps],
        "step_ms_p50": step_ms,
        "step_ms_p50_over": "steps 2-%d (step 1 warms the card)"
                            % TRAIN_STEPS,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "mfu": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "flops_per_step": flops,
        "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
        "losses": losses, "expected_first_loss": expected,
        "wall_s": wall,
        "launches_per_step": steps[-1]["launches"],
    }
    return metrics, executor, launches


def compare_train_step(rng):
    """One bf16 train_step of a 2-layer flagship-width model on the card
    and on the CPU (plain versions), same numpy weights and batch: the
    loss and every parameter's gradient norm, by relative error."""
    cfg = {k: v for k, v in FLAGSHIP.items() if k != "dtype"}
    cfg["num_layers"] = 2
    sd = params_from_flax(numpy_flax_params(cfg, seed=3))
    tokens = rng.randint(0, cfg["vocab_size"],
                         size=(2, cfg["seq_len"] + 1)).astype(np.int32)
    batch = ({"tokens": tokens[:, :-1]}, tokens[:, 1:])
    runs = {}
    for dev in ("cuda", "cpu"):
        spec = load_model_spec_from_module(tzoo)
        trainer = Trainer(spec, model_params=_params_str(cfg), device=dev)
        state = trainer.init_state(batch, params=sd)
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        secs = time.perf_counter() - t0
        norms = {k: p.grad.float().norm().item()
                 for k, p in state.params.items()}
        runs[dev] = (loss, norms, secs)
    (gl, gn, gs), (cl, cn, cs) = runs["cuda"], runs["cpu"]
    loss_err = abs(gl - cl) / abs(cl)
    norm_errs = {k: abs(gn[k] - cn[k]) / max(cn[k], 1e-30) for k in cn}
    worst = max(norm_errs, key=norm_errs.get)
    log("train step cuda vs cpu: loss %.6f / %.6f (rel %.3g); worst grad "
        "norm rel err %.3g (%s); %.1f s / %.1f s"
        % (gl, cl, loss_err, norm_errs[worst], worst, gs, cs))
    check(all(math.isfinite(x) for x in list(gn.values()) + [gl]),
          "non-finite loss or gradient on the card")
    check(loss_err <= STEP_LOSS_TOL_REL,
          "train step loss: card %.6f vs cpu %.6f" % (gl, cl))
    check(norm_errs[worst] <= STEP_GRAD_NORM_TOL_REL,
          "gradient norm of %s: card %.6g vs cpu %.6g"
          % (worst, gn[worst], cn[worst]))
    return {"loss_cuda": gl, "loss_cpu": cl, "loss_rel_err": loss_err,
            "grad_norm_max_rel_err": norm_errs[worst],
            "grad_norm_worst_param": worst,
            "limits": {"loss_rel": STEP_LOSS_TOL_REL,
                       "grad_norm_rel": STEP_GRAD_NORM_TOL_REL}}


def profile_train_step(executor, rng, steps=2):
    """Where a flagship training step's time goes: after one warm step,
    `steps` more steps of the executor's trainer on one batch timed on
    the host clock, then as many under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    trainer, state = executor.trainer, executor.state
    tokens = rng.randint(0, FLAGSHIP["vocab_size"], size=(
        TRAIN_BATCH, FLAGSHIP["seq_len"] + 1)).astype(np.int32)
    batch = ({"tokens": tokens[:, :-1]}, tokens[:, 1:])
    state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    return {"step_ms": step_ms, "step_ms_profiled": prof_ms,
            **device_summary(events, steps, step_ms, top=10, group="flash_"),
            "host_ops_per_step": sum(e.count for e in events
                                     if e.key.startswith("aten::")) / steps}


# ----------------------------------------------------------------- timings


def _timing_entry(name, source, replaces, shape, fn, plain, library,
                  work, launches, errors):
    """`library`: a callable timed like the kernel, or (ms, what) timed
    by the caller, or None."""
    ms, eager_ms = timed_ms(fn)
    plain_ms, _ = timed_ms(plain)
    bound, bound_by = bound_ms(*work)
    if callable(library):
        library = (timed_ms(library)[0], None)
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "shape": shape, "launches": launches[name],
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None if library is None else library[0],
    }
    if library is not None and library[1]:
        entry["library_call"] = library[1]
    entry.update(errors)
    return entry


def flash_bwd_work(b, h, hkv, l, d, itemsize, dkv):
    """(operations, bytes) of one causal backward pass at lq = lk = l:
    6*d operations per visible (query, key) pair for dq (S, dP, dQ), 8*d
    for dk/dv (S, dP, dV, dK); each input read once and each output
    written once: dq reads q, k, v, out, dO and the lse, writes dq and
    delta; dk/dv reads q, k, v, dO, lse and delta, writes dk and dv."""
    pairs = l * (l + 1) // 2
    rows_q, rows_kv = b * h * l, b * hkv * l
    if dkv:
        return (8 * d * pairs * b * h,
                itemsize * d * (2 * rows_q + 4 * rows_kv) + 8 * rows_q)
    return (6 * d * pairs * b * h,
            itemsize * d * (4 * rows_q + 2 * rows_kv) + 8 * rows_q)


def sdpa_backward_ms(q, k, v, do):
    """(ms, what) of PyTorch's own flash-attention backward computing dq,
    dk and dv in one call at these inputs (causal), timed eagerly between
    CUDA events; used only as a yardstick, never by the port. Where the
    aten op's signature does not fit this PyTorch, SDPA's autograd
    backward is timed instead (forward + backward less the forward)."""
    aten = torch.ops.aten
    try:
        fwd = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True,
                                                       False)
        out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

        def run():
            return aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, True, seed,
                offset)

        run()
        torch.cuda.synchronize()
        return (_events_ms(run, 20),
                "aten._scaled_dot_product_flash_attention_backward: dq, dk "
                "and dv in one call")
    except (RuntimeError, TypeError) as e:
        log("aten flash backward not callable here (%s); timing SDPA's "
            "autograd backward instead" % e)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd_only():
        return F.scaled_dot_product_attention(*leaves, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd_only(), leaves, do)

    fwd_bwd()
    torch.cuda.synchronize()
    return (_events_ms(fwd_bwd, 20) - _events_ms(fwd_only, 20),
            "F.scaled_dot_product_attention autograd backward (forward + "
            "backward less forward): dq, dk and dv")


def time_backward(gen, train_launches, bwd_err):
    """Kernels C and D at the training shape: b = 8, h = 8, l = 1024,
    d = 128, causal, bf16, on the forward kernel's out and lse."""
    b, h, l, d = TRAIN_BATCH, 8, FLAGSHIP["seq_len"], 128
    q, k, v = flash_inputs(gen, b, h, h, l, d, torch.bfloat16)
    do = flash_inputs(gen, b, h, h, l, d, torch.bfloat16)[0]
    out, lse = att.flash_forward(q, k, v, causal=True)
    _dq, delta = att.flash_backward_dq(q, k, v, out, lse, do, causal=True)
    library = sdpa_backward_ms(q, k, v, do)
    shape = "b=%d h=%d lq=lk=%d d=%d causal bf16" % (b, h, l, d)
    entries = []
    for name, line, fn, plain, dkv in (
            ("flash_bwd_dq", 1241,
             lambda: att.flash_backward_dq(q, k, v, out, lse, do, causal=True),
             lambda: att.flash_backward_dq_plain(q, k, v, out, lse, do,
                                                 causal=True), False),
            ("flash_bwd_dkv", 1294,
             lambda: att.flash_backward_dkv(q, k, v, do, lse, delta,
                                            causal=True),
             lambda: att.flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                                  causal=True), True)):
        entry = _timing_entry(
            name, "elasticdl_tpu_torch/csrc/flash_bwd.cu",
            "elasticdl_tpu/ops/attention.py:%d" % line, shape, fn, plain,
            library, flash_bwd_work(b, h, h, l, d, 2, dkv), train_launches,
            dict(bwd_err[name], max_err=bwd_err[name]["max_abs_err"]))
        entry["launches_per_step"] = train_launches[name] // TRAIN_STEPS
        entries.append(entry)
    return entries


def time_kernels(gen, launches, flash_err, paged_err):
    """Each serving kernel at the main path's shapes: the largest prefill
    bucket (lq = 512) for A; for B the 8-slot decode step (t = 1, ragged
    lengths under 1000, split kernel) and a 128-token suffix tile over
    the 256-token shared prefix (tile kernel)."""
    q, k, v = flash_inputs(gen, 1, 8, 8, 512, 128, torch.bfloat16)
    flash = _timing_entry(
        "flash_fwd", "elasticdl_tpu_torch/csrc/flash_fwd.cu",
        "elasticdl_tpu/ops/attention.py:941",
        "b=1 h=8 lq=lk=512 d=128 causal bf16",
        lambda: att.flash_forward(q, k, v, causal=True),
        lambda: att.flash_attention_plain(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        flash_work(1, 8, 8, 512, 512, 128, 2), launches,
        {"max_abs_err": flash_err[0], "max_err": flash_err[0],
         "lse_max_abs_err": flash_err[1]},
    )
    paged_errors = {"max_abs_err": paged_err[0], "max_err": paged_err[0],
                    "max_rel_err": paged_err[1]}
    entries = [flash]
    for name, t, lengths, label in (
            ("paged_decode", 1, None, "b=8 t=1"),
            ("paged_decode_tile", 128, [256], "b=1 t=128")):
        args, lens = paged_inputs(gen, b=1 if lengths else 8, t=t,
                                  lengths=lengths)
        entries.append(_timing_entry(
            name, "elasticdl_tpu_torch/csrc/paged_decode.cu",
            "elasticdl_tpu/ops/attention.py:591",
            "%s hkv=8 d=128 bs=16 m=64 bf16, live rows %d"
            % (label, sum(lens)),
            lambda args=args: att.paged_decode_partials(*args),
            lambda args=args: att.paged_decode_partials_plain(*args),
            None, paged_work(lens, 8, t, 128, 2, 64), launches,
            paged_errors,
        ))
    return entries


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("card: %s | torch %s cuda %s | %s"
        % (smi, torch.__version__, torch.version.cuda, kind))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (fp32 comparisons in full fp32)")

    t0 = time.perf_counter()
    report = _build.build()
    log("kernels built in %.1f s: %s" % (
        time.perf_counter() - t0,
        ", ".join("%s %.1f s" % (n, r["seconds"]) for n, r in
                  report.items())))

    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(0)
    flash_err = check_flash(gen)
    paged_err = check_paged(gen)
    bwd_err = check_flash_bwd(gen)
    autograd_err = check_autograd(gen)
    serving, launches = serve_flagship(rng)
    log("serving run launches: %s" % launches)
    serving["cuda_vs_cpu"] = compare_cuda_cpu(rng)
    serving["decode_profile"] = profile_decode(rng)
    log("decode profile: %s" % json.dumps(serving["decode_profile"]))
    with tempfile.TemporaryDirectory() as workdir:
        training, executor, train_launches = train_flagship(rng, workdir)
    log("training run launches: %s" % train_launches)
    training["step_profile"] = profile_train_step(executor, rng)
    log("training step profile: %s" % json.dumps(training["step_profile"]))
    del executor
    training["cuda_vs_cpu_step"] = compare_train_step(rng)
    training["autograd_cuda_vs_cpu_rel_err"] = autograd_err
    kernels = time_kernels(gen, launches, flash_err, paged_err)
    kernels[0]["launches_training_per_step"] = (
        train_launches["flash_fwd"] // TRAIN_STEPS)
    kernels += time_backward(gen, train_launches, bwd_err)
    serving["card"] = training["card"] = smi
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
