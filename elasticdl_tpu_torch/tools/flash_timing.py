"""Device time of the unmasked flash kernels (A, C, D) on one card, for
comparing two checkouts of the port in one call.

    PYTHONPATH=<checkout> python3 <this file> [label]

imports `elasticdl_tpu_torch` from PYTHONPATH (so the same file times
any checkout whose wrappers take these arguments), builds its kernels,
and prints one JSON line: each case's device ms, the median of 5 rounds
of 50 CUDA-graph replays between CUDA events, with the card's name and
power limit. Cases: A at the serving path's largest prefill bucket (b 1,
h 8, l 512) and at the training shape (b 8, h 8, l 1024), C and D at the
training shape; causal, bf16, d 128, inputs from a seeded generator.
"""

import json
import subprocess
import sys

import torch

from elasticdl_tpu_torch.ops import attention as att

ROUNDS, REPLAYS = 5, 50


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
    q, k, v, do = mk(8, 1024), mk(8, 1024), mk(8, 1024), mk(8, 1024)
    o, lse = att.flash_forward(q, k, v, causal=True)
    _dq, delta = att.flash_backward_dq(q, k, v, o, lse, do, causal=True)
    out["flash_fwd_b8_l1024"] = _replay_ms(
        lambda: att.flash_forward(q, k, v, causal=True))
    out["flash_bwd_dq_b8_l1024"] = _replay_ms(
        lambda: att.flash_backward_dq(q, k, v, o, lse, do, causal=True))
    out["flash_bwd_dkv_b8_l1024"] = _replay_ms(
        lambda: att.flash_backward_dkv(q, k, v, do, lse, delta,
                                       causal=True))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ""))
