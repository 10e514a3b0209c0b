"""Device time of the port's attention kernels (A, C, D, B), its dense
update kernel (G) and its embedding kernels (E, F) on one card, for
comparing two checkouts of the port in one call.

    PYTHONPATH=<checkout> python3 <this file> [label [group ...]]

imports `elasticdl_tpu_torch` from PYTHONPATH (so the same file times
any checkout whose wrappers take these arguments), builds its kernels,
and prints one JSON line: each case's device ms, with the card's name
and power limit. The groups (all but vit by default): flash (A, C,
D), paged (B), dense (G), embedding (E, F), vit (A, C and D in fp32).
"Hot": the median of 5 rounds of 50
CUDA-graph replays of one call between CUDA events, so its inputs sit in
L2 where they fit. "Cold" (B): 8 calls over 8 disjoint arena pairs in
one CUDA graph, as a decode step issues one per layer, L2 flushed
before each of 20 rounds, the per-call mean. Flash cases, bf16, d 128,
inputs from seeded generators:

* A at the serving path's largest prefill bucket (b 1, h 8, l 512) and
  at the training shape (b 8, h 8, l 1024), causal, each beside SDPA
  (is_causal);
* A, C and D at the training shape, causal: unmasked (C and D), window
  256 (the windowed flagship), and the segments of pack_sequences over
  documents of 64-1024 tokens (the packed flagship); A's masked cases
  beside SDPA with the same boolean mask;
* A, C and D at the windowed ring's one-shard-back rotation (b 2, h 8,
  1024-row shards, window 1536, pos_offset 1024, not causal; C and D
  with fp32 gradients and the ring's global lse); A beside SDPA with the
  same boolean mask;
* aten's flash-attention backward (dq, dk and dv in one call) at the
  training shape, causal: the yardstick of C + D.

The `vit` group: A, C and D in fp32 (TF32 off) at ViT-Base's path
shape (b 64, h 12, l 256, d 64, not causal), at l 197 (ViT-B/16 at 224
px, 196 patches and the class token) and at the training shape (b 8,
h 8, l 1024, d 128, causal: the fp32 d 128 instances); A beside SDPA's
fp32 forward (hot, graph-replayed: the memory-efficient kernel, which
SDPA runs for fp32), C and D beside SDPA's autograd backward on the
same inputs (dq, dk and dv; forward and backward less the forward,
eager between CUDA events, 20 calls), each kernel's ms also over the
operations bound at the card's 67 TFLOP/s fp32 rate (`_bound_share`);
at the path's shape also the SM clock and power draw while C and D run
back to back for 2 s, and while A runs for 2 s (`_clocks`: the median
of nvidia-smi's 100 ms samples). Not in the default groups.

B, `paged_decode_partials` (hkv 8, d 128, blocks of 16, tables of 64
slots), bf16 arenas and the same quantized to int8 with fp32 row scales,
hot, cold and by the profiler (`_kernel_us`: the kernels' own device
time, since a one-call graph replay adds a few microseconds, measured as
`replay_floor_ms` on a one-element fill), inputs drawn as chip_smoke.py's
time_kernels draws them
(PAGED_SEED; PAGED_SEED + 1 for the windowed cases, as
check_masked_paged draws them):

* the split kernel at the 8-slot decode step (t 1, lengths under 1000),
  without and with window 256; and, by the profiler, bf16 with the same
  4184 rows spread evenly (8 sequences of 523);
* the tile kernel at a 128-row suffix tile over a 256-token prefix,
  without and with window 256.

G, the five rules at 64M fp32 (the dense update API's path) through
their public wrappers, beside `p.add(g, alpha=-lr)`, hot (every call
moves 0.8-2.4 GB, far past L2).

E and F at the DLRM path's shape: 26 tables of 1,200,000 x 32 fp32 and
4096 ids a table uniform over the rows, drawn from EMB_SEED; F over
each table's ids deduplicated (`dedup_indexed_slices`), as the row tier
calls it. Each case over the 26 tables of a step, with L2 flushed
before each round (`_step`: ms a step, `_kernel_us`: the kernels'
own microseconds a step by the profiler, each call after a flush,
`_eager_ms`: a step's calls without a graph, the wrappers' host work
included):

* the 26 lookups of a step: through `embedding_gather_many` where the
  checkout has it, else 26 `embedding_gather` calls in one graph; one
  table's call (`_table`: per call of 26 in one graph, and its kernel
  alone); 26 `torch.index_select` in one graph;
* the 26 updates of a step for each rule (sgd, momentum with Nesterov,
  adam at update 3, adagrad): through `row_update_many` where the
  checkout has it, else 26 `sparse_*_update` calls; SGD's one table's
  call; 26 `Tensor.index_add_` (SGD's update) in one graph.

SDPA, aten, `p.add`, `index_select` and `index_add_` are used nowhere in
the port.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from elasticdl_tpu_torch.data import packing
from elasticdl_tpu_torch.model_zoo.transformer_lm import kv_quantize_rows
from elasticdl_tpu_torch.ops import attention as att
from elasticdl_tpu_torch.ops import embedding_ops as eo
from elasticdl_tpu_torch.ops import optimizer_kernels as ok
from elasticdl_tpu_torch.ops import update_math as um

ROUNDS, REPLAYS = 5, 50
WINDOW = 256
RING_WINDOW, RING_SHARD = 1536, 1024
PAGED_SEED = 11  # chip_smoke.py's PAGED_TIMING_SEED
COLD_LAYERS, COLD_ROUNDS = 8, 20
L2_FLUSH_BYTES = 256 << 20  # past the H100's 50 MB L2
DENSE_N = 64 * 1024 * 1024
EMB_TABLES, EMB_VOCAB, EMB_DIM, EMB_IDS = 26, 1_200_000, 32, 4096
EMB_SEED = 6


def _replay_ms(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / REPLAYS)
    return sorted(times)[ROUNDS // 2]


def _packed_segments(b, l, seed=5):
    """[b, l] int32 ids of pack_sequences over documents of 64-1024
    tokens drawn from `seed`, on the card."""
    rs = np.random.RandomState(seed)
    docs = [np.zeros(rs.randint(64, 1025), np.int64)
            for _ in range(3 * b * l // 544 + 1)]
    seg = packing.pack_sequences(docs, l)[1][:b]
    return torch.as_tensor(seg, dtype=torch.int32).cuda()


def _forward_case(out, name, q, k, v, **kw):
    """A of one variant and SDPA with the same boolean mask: device ms of
    each into `out`."""
    mask = att._visible(q.shape[2], k.shape[2], kw.get("causal", False),
                        kw.get("window"), kw.get("q_seg"), kw.get("k_seg"),
                        device=q.device, pos_offset=kw.get("pos_offset", 0))
    out["flash_fwd_" + name] = _replay_ms(lambda: att.flash_forward(q, k, v,
                                                                    **kw))
    out["sdpa_fwd_" + name] = _replay_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))


def _backward_cases(out, name, q, k, v, do, **kw):
    """C and D of one variant: device ms of each into `out`."""
    o, lse = att.flash_forward(q, k, v, **kw)
    _dq, delta = att.flash_backward_dq(q, k, v, o, lse, do, **kw)
    out["flash_bwd_dq_" + name] = _replay_ms(
        lambda: att.flash_backward_dq(q, k, v, o, lse, do, **kw))
    out["flash_bwd_dkv_" + name] = _replay_ms(
        lambda: att.flash_backward_dkv(q, k, v, do, lse, delta, **kw))


def _aten_backward_ms(q, k, v, do):
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True, False)
    o, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    backward = aten._scaled_dot_product_flash_attention_backward
    return _replay_ms(lambda: backward(do, q, k, v, o, lse, cq, ck, mq, mk,
                                       0.0, True, seed, offset))


def _kernel_us(fn, name, calls=20, flush=None):
    """Device microseconds a call of fn spends in kernels whose name holds
    `name`, by torch.profiler over `calls` eager calls: the kernels' own
    durations, without the few microseconds a graph replay adds around a
    short kernel. `flush`: a tensor zeroed before each call, to evict
    the L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for event in prof.key_averages():
        if name in event.key:
            total += getattr(event, "device_time_total", None) or getattr(
                event, "cuda_time_total", 0.0)
    return total / calls


def _cold_ms(calls):
    """Per-call device ms of `calls` (over disjoint data) captured in one
    CUDA graph, with L2 flushed before each of COLD_ROUNDS rounds."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def round_():
        for call in calls:
            call()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        round_()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        round_()
    total = 0.0
    for _ in range(COLD_ROUNDS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / COLD_ROUNDS / len(calls)


def _paged_inputs(gen, b=8, t=1, lengths=None, hkv=8, d=128, bs=16, m=64,
                  num_blocks=640):
    """chip_smoke.py's paged_inputs: (qf, k_pool, v_pool, table, length)
    on the card and the lengths, drawn from `gen` in the same order."""
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
    qf = (torch.randn(b, hkv, t, d, generator=gen) * d ** -0.5).to("cuda")
    return (qf, pools[0], pools[1], table.cuda(),
            lengths.to(torch.int32).cuda()), lengths.tolist()


def _paged_cases(out):
    """B's split and tile kernels, bf16 and int8, without and with window
    256, hot and cold (see the module docstring)."""
    arena_gen = torch.Generator(device="cuda").manual_seed(PAGED_SEED + 100)
    for seed, window in ((PAGED_SEED, None), (PAGED_SEED + 1, WINDOW)):
        gen = torch.Generator().manual_seed(seed)
        for kernel, t, lengths in (("split", 1, None),
                                   ("tile", 128, [256])):
            args, lens = _paged_inputs(gen, b=1 if lengths else 8, t=t,
                                       lengths=lengths)
            qf, k_pool, v_pool, table, length = args
            # 8 arena pairs, as 8 layers: the first is the hot inputs'
            pairs = [(k_pool, v_pool)] + [
                tuple(torch.randn(k_pool.shape, generator=arena_gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2)) for _ in range(COLD_LAYERS - 1)]
            for dtype in ("bf16", "int8"):
                calls = []
                for kp, vp in pairs:
                    if dtype == "int8":
                        (k8, ks), (v8, vs) = map(kv_quantize_rows, (kp, vp))
                        extra = (k8, v8, table, length, ks, vs)
                    else:
                        extra = (kp, vp, table, length)
                    calls.append(lambda e=extra: att.paged_decode_partials(
                        qf, *e, window=window, t=t))
                name = "paged_%s_%s%s" % (kernel, dtype,
                                         "_window" if window else "")
                out[name + "_hot"] = _replay_ms(calls[0])
                out[name + "_cold"] = _cold_ms(calls)
                out[name + "_kernel_us"] = _kernel_us(calls[0], "paged")
                out[name + "_live_rows"] = sum(lens)
            del pairs
            torch.cuda.empty_cache()
    # the same 4184 rows with every sequence at their mean length: what
    # the spread of the lengths costs the split kernel
    gen = torch.Generator().manual_seed(PAGED_SEED + 2)
    args, _ = _paged_inputs(gen, b=8, t=1, lengths=[523] * 8)
    out["paged_split_bf16_even_kernel_us"] = _kernel_us(
        lambda: att.paged_decode_partials(*args), "paged")


DENSE_SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adam_amsgrad": 3,
               "adagrad": 1}


def _dense_call(rule, p, slots, g):
    """One update of `rule` through its public wrapper."""
    if rule == "sgd":
        return ok.sgd_update(p, g, 0.01)
    if rule == "momentum":
        return ok.momentum_update(p, slots[0], g, 0.01, nesterov=True)
    if rule == "adagrad":
        return ok.adagrad_update(p, slots[0], g, 0.01)
    return ok.adam_update(p, slots[0], slots[1], g, 3, 1e-3,
                          max_square=slots[2] if len(slots) > 2 else None)


def _dense_cases(out):
    """G's five rules at DENSE_N fp32 and p.add(g, alpha=-lr), hot."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for rule, n_slots in DENSE_SLOTS.items():
        p, g = (torch.randn(DENSE_N, generator=gen, device="cuda")
                for _ in range(2))
        slots = [torch.randn(DENSE_N, generator=gen, device="cuda").abs()
                 * 0.1 for _ in range(n_slots)]
        if rule == "sgd":
            out["torch_add_64m"] = _replay_ms(lambda: p.add(g, alpha=-0.01))
        out["dense_%s_64m" % rule] = _replay_ms(
            lambda: _dense_call(rule, p, slots, g))
        del p, g, slots
        torch.cuda.empty_cache()


# each rule's arguments for the one-table wrappers, and its hyperparameters
# as the grouped wrapper takes them
ROW_CASES = {
    "sgd": (eo.sparse_sgd_update, 0, {"lr": 0.01}, [0.01]),
    "momentum": (eo.sparse_momentum_update, 1,
                 {"lr": 0.01, "momentum": 0.9, "nesterov": True},
                 [0.01, 0.9, 1.0]),
    "adam": (eo.sparse_adam_update, 2,
             {"step": 3, "lr": 1e-3, "beta1": 0.9, "beta2": 0.999,
              "eps": 1e-8},
             [um.adam_alpha(1e-3, 0.9, 0.999, 3), 0.9, 0.999, 1e-8]),
    "adagrad": (eo.sparse_adagrad_update, 1, {"lr": 0.01, "eps": 1e-10},
                [0.01, 1e-10]),
}


def _eager_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _embedding_cases(out):
    """E and F over the 26 tables of a DLRM step (see the module
    docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(EMB_SEED)
    n_tab = EMB_TABLES
    tables = torch.randn(n_tab, EMB_VOCAB, EMB_DIM, generator=gen,
                         device="cuda")
    tabs = list(tables)
    ids = torch.randint(0, EMB_VOCAB, (n_tab, EMB_IDS), generator=gen,
                        device="cuda", dtype=torch.int32)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    grouped = hasattr(eo, "embedding_gather_many")
    out["embedding_grouped_wrappers"] = grouped
    one = [lambda t=t: eo.embedding_gather(tabs[t], ids[t])
           for t in range(n_tab)]

    def step():
        if grouped:
            return eo.embedding_gather_many(tabs, ids)
        return [call() for call in one]

    out["gather_step"] = _cold_ms([step])
    out["gather_step_kernel_us"] = _kernel_us(step, "gather_kernel",
                                              flush=flush)
    out["gather_step_eager_ms"] = _eager_ms(step)
    out["gather_table"] = _cold_ms(one)
    out["gather_table_kernel_us"] = _kernel_us(one[0], "gather_kernel",
                                               flush=flush)
    longs = [i.long() for i in ids]
    out["index_select_step"] = _cold_ms([lambda: [
        torch.index_select(tabs[t], 0, longs[t]) for t in range(n_tab)]])
    grads = torch.randn(n_tab, EMB_IDS, EMB_DIM, generator=gen,
                        device="cuda")
    uniq, summed = map(list, zip(*(eo.dedup_indexed_slices(i, g)
                                   for i, g in zip(ids, grads))))
    for rule, (wrapper, n_slots, kwargs, hyper) in ROW_CASES.items():
        slots = [torch.rand(n_tab, EMB_VOCAB, EMB_DIM, generator=gen,
                            device="cuda") * 0.1 for _ in range(n_slots)]
        group = [[tabs[t]] + [s[t] for s in slots] for t in range(n_tab)]
        one = [lambda t=t: wrapper(*group[t], uniq[t], summed[t], **kwargs)
               for t in range(n_tab)]

        def step(rule=rule, group=group, hyper=hyper, one=one):
            if grouped:
                eo.row_update_many(rule, group, uniq, summed,
                                   [hyper] * n_tab)
            else:
                for call in one:
                    call()

        name = "row_%s" % rule
        out[name + "_step"] = _cold_ms([step])
        out[name + "_step_kernel_us"] = _kernel_us(
            step, "row_update_kernel", flush=flush)
        out[name + "_step_eager_ms"] = _eager_ms(step)
        if rule == "sgd":
            out[name + "_table"] = _cold_ms(one)
            out[name + "_table_kernel_us"] = _kernel_us(
                one[0], "row_update_kernel", flush=flush)
            valid = [(u[u >= 0].long(), s[:int((u >= 0).sum())])
                     for u, s in zip(uniq, summed)]
            out["index_add_step"] = _cold_ms([lambda: [
                tabs[t].index_add_(0, v, s, alpha=-0.01)
                for t, (v, s) in enumerate(valid)]])
        del slots, group
        torch.cuda.empty_cache()


GROUPS = ("flash", "paged", "dense", "embedding")
OPTIONAL_GROUPS = ("vit",)
PEAK_FP32_FLOPS = 67e12
VIT_CASES = {"vit_l256": (64, 12, 256, 64, False),
             "vit_l197": (64, 12, 197, 64, False),
             "f32_b8_l1024_d128": (8, 8, 1024, 128, True)}


def _events_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _sdpa_backward_ms(q, k, v, do, causal):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    return _events_ms(fwd_bwd) - _events_ms(fwd)


def _clocks(fn, seconds=2.0):
    """(median SM MHz, median W, the card's max SM MHz) over nvidia-smi's
    100 ms samples while fn runs repeatedly for `seconds`; None where
    nvidia-smi gives no samples."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = []
    for line in smi.communicate(timeout=30)[0].splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    rows = rows[2:-1]  # the first samples may precede the load
    if not rows:
        return None
    mhz, watts = (sorted(r[col] for r in rows)[len(rows) // 2]
                  for col in (0, 1))
    return mhz, watts, rows[0][2]


def _bound_share(ms, b, h, l, d, causal, ops_per_pair):
    """The operations bound at the fp32 rate over ms: `ops_per_pair`
    times d operations per visible (query, key) pair (A 4, C 6, D 8)."""
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = ops_per_pair * d * pairs * b * h
    return flops / PEAK_FP32_FLOPS * 1e3 / ms


def _vit_cases(out):
    """A, C and D in fp32 (see the module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    for name, (b, h, l, d, causal) in VIT_CASES.items():
        q, k, v, do = (torch.randn(b, h, l, d, generator=gen).cuda()
                       for _ in range(4))
        fwd_ms = out["flash_fwd_" + name] = _replay_ms(
            lambda: att.flash_forward(q, k, v, causal=causal))
        out["sdpa_fwd_" + name] = _replay_ms(
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal))
        out["bound_share_fwd_" + name] = _bound_share(fwd_ms, b, h, l, d,
                                                      causal, 4)
        o, lse = att.flash_forward(q, k, v, causal=causal)
        _dq, delta = att.flash_backward_dq(q, k, v, o, lse, do,
                                           causal=causal)
        dq_ms = out["flash_bwd_dq_" + name] = _replay_ms(
            lambda: att.flash_backward_dq(q, k, v, o, lse, do,
                                          causal=causal))
        dkv_ms = out["flash_bwd_dkv_" + name] = _replay_ms(
            lambda: att.flash_backward_dkv(q, k, v, do, lse, delta,
                                           causal=causal))
        out["sdpa_bwd_" + name] = _sdpa_backward_ms(q, k, v, do, causal)
        if name == "vit_l256":
            out["sm_mhz_watts_max_mhz_" + name] = _clocks(lambda: (
                att.flash_backward_dq(q, k, v, o, lse, do, causal=causal),
                att.flash_backward_dkv(q, k, v, do, lse, delta,
                                       causal=causal)))
            out["sm_mhz_watts_max_mhz_fwd_" + name] = _clocks(
                lambda: att.flash_forward(q, k, v, causal=causal))
        out["bound_share_dq_" + name] = _bound_share(dq_ms, b, h, l, d,
                                                     causal, 6)
        out["bound_share_dkv_" + name] = _bound_share(dkv_ms, b, h, l, d,
                                                      causal, 8)
        del q, k, v, do, o, lse, _dq, delta
        torch.cuda.empty_cache()


def main(label, groups=GROUPS):
    if not torch.cuda.is_available():
        print("flash_timing: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(groups) - set(GROUPS + OPTIONAL_GROUPS)
    if unknown:
        print("flash_timing: unknown groups %s (of %s)"
              % (sorted(unknown), GROUPS + OPTIONAL_GROUPS),
              file=sys.stderr)
        return 2
    out = {"label": label, "module": att.__file__}
    if "flash" in groups:
        _flash_cases(out)
    if "vit" in groups:
        _vit_cases(out)
    one = torch.zeros(1, device="cuda")
    out["replay_floor_ms"] = _replay_ms(one.zero_)
    if "paged" in groups:
        _paged_cases(out)
    if "dense" in groups:
        _dense_cases(out)
    if "embedding" in groups:
        _embedding_cases(out)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


def _flash_cases(out):
    """A, C and D (see the module docstring)."""
    gen = torch.Generator().manual_seed(0)

    def mk(b, l):
        return torch.randn(b, 8, l, 128, generator=gen).to("cuda",
                                                            torch.bfloat16)

    q, k, v = mk(1, 512), mk(1, 512), mk(1, 512)
    out["flash_fwd_b1_l512"] = _replay_ms(
        lambda: att.flash_forward(q, k, v, causal=True))
    out["sdpa_fwd_b1_l512"] = _replay_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    q, k, v, do = mk(8, 1024), mk(8, 1024), mk(8, 1024), mk(8, 1024)
    o, lse = att.flash_forward(q, k, v, causal=True)
    _dq, delta = att.flash_backward_dq(q, k, v, o, lse, do, causal=True)
    out["flash_fwd_b8_l1024"] = _replay_ms(
        lambda: att.flash_forward(q, k, v, causal=True))
    out["sdpa_fwd_b8_l1024"] = _replay_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    out["flash_bwd_dq_b8_l1024"] = _replay_ms(
        lambda: att.flash_backward_dq(q, k, v, o, lse, do, causal=True))
    out["flash_bwd_dkv_b8_l1024"] = _replay_ms(
        lambda: att.flash_backward_dkv(q, k, v, do, lse, delta,
                                       causal=True))
    out["aten_flash_bwd_b8_l1024"] = _aten_backward_ms(q, k, v, do)
    _forward_case(out, "window_b8_l1024", q, k, v, causal=True,
                  window=WINDOW)
    _backward_cases(out, "window_b8_l1024", q, k, v, do, causal=True,
                    window=WINDOW)
    seg = _packed_segments(8, 1024)
    _forward_case(out, "segments_b8_l1024", q, k, v, causal=True,
                  q_seg=seg, k_seg=seg)
    _backward_cases(out, "segments_b8_l1024", q, k, v, do, causal=True,
                    q_seg=seg, k_seg=seg)
    # the ring's one-shard-back rotation, with its global lse: this
    # rotation's merged with the diagonal rotation's
    q, k, v, do, k2, v2 = (mk(2, RING_SHARD) for _ in range(6))
    ring = dict(window=RING_WINDOW, pos_offset=RING_SHARD)
    _forward_case(out, "window_offset_b2_l1024", q, k, v, **ring)
    _o, lse_diag = att.flash_forward(q, k2, v2, causal=True)
    o, lse = att.attention_forward_lse(q, k, v, **ring)
    lse = torch.logaddexp(lse, lse_diag)
    grad = dict(ring, grad_dtype=torch.float32)
    _dq, delta = att.flash_backward_dq(q, k, v, o, lse, do, **grad)
    out["flash_bwd_dq_window_offset_b2_l1024"] = _replay_ms(
        lambda: att.flash_backward_dq(q, k, v, o, lse, do, **grad))
    out["flash_bwd_dkv_window_offset_b2_l1024"] = _replay_ms(
        lambda: att.flash_backward_dkv(q, k, v, do, lse, delta, **grad))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "",
                  sys.argv[2:] or GROUPS))
