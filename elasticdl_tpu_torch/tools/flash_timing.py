"""Device time of the flash kernels (A, C, D) on one card, for comparing
two checkouts of the port in one call.

    PYTHONPATH=<checkout> python3 <this file> [label]

imports `elasticdl_tpu_torch` from PYTHONPATH (so the same file times
any checkout whose wrappers take these arguments), builds its kernels,
and prints one JSON line: each case's device ms, the median of 5 rounds
of 50 CUDA-graph replays between CUDA events, with the card's name and
power limit. Cases, bf16, d 128, inputs from seeded generators:

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

SDPA and aten are used nowhere in the port.
"""

import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.data import packing
from elasticdl_tpu_torch.ops import attention as att

ROUNDS, REPLAYS = 5, 50
WINDOW = 256
RING_WINDOW, RING_SHARD = 1536, 1024


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


def main(label):
    if not torch.cuda.is_available():
        print("flash_timing: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)

    def mk(b, l):
        return torch.randn(b, 8, l, 128, generator=gen).to("cuda",
                                                            torch.bfloat16)

    out = {"label": label, "module": att.__file__}
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
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ""))
