"""Serving entry point of the PyTorch port.

Builds the transformer_lm model (seeded random weights; the `.params`
of the latest valid checkpoint under --checkpoint_dir, which either
package's trainer wrote; or JAX-package params converted from an .npz),
starts the in-process generation server and answers the requests read
from stdin, one JSON object per line:

    {"prompt": [1, 2, 3], "max_new_tokens": 16, "temperature": 0.0,
     "seed": 0}

Each answer is one JSON line {"tokens": [...prompt + generated]} or
{"error": code, "message": ...}, in request order; the requests are
submitted together, so they are served concurrently. A line
{"status": true} is answered with the server's status when the answers
before it are in (`GenerationServer.status`: slots, queue, the KV pool's
format `kv_cache_dtype`, blocks and bytes).

The engine is chosen as the JAX entry point chooses it: `--kv_paged`
-1 (the default) resolves from EDL_KV_PAGED, so the dense pool unless
that is set; 1 is the block-paged pool, which speculative decode
(`--draft_k` with a draft given by `--draft_model_params`, a second
transformer_lm; its `seed` picks its weights) and chunked prefill
(`--prefill_chunk_tokens`, `--prefill_budget_ms`) need. `--profile 1`
adds the step profiler's phases to the status answer. With
--checkpoint_dir the server keeps following the directory and swaps in
newer versions between decode steps, `--reload_poll_secs` apart (0 =
never by itself). `--warmup_tokens` generates that many tokens before
the first request is read. An int8 KV cache is a model parameter, as in
the JAX package: `--model_params "...; kv_cache_dtype='int8'"`. A
checkpoint of int8 weights (api/quantization) is served dequantized
once at load.

    echo '{"prompt": [1, 2, 3], "max_new_tokens": 8}' | \\
    python -m elasticdl_tpu_torch.serving.main --device cuda \\
        --model_params "vocab_size=32000; seq_len=1024; embed_dim=1024; \\
num_heads=8; num_layers=8; dtype='bf16'" --num_slots 8 --kv_paged 1 \\
        --kv_block_size 16
"""

import argparse
import json
import logging
import sys

logger = logging.getLogger(__name__)


def parse_serving_args(args=None):
    parser = argparse.ArgumentParser(
        description="elasticdl-tpu PyTorch generation server (stdin/stdout)"
    )
    parser.add_argument("--model_params", default="")
    parser.add_argument("--params_npz", default="",
                        help="flax transformer_lm params saved as an .npz "
                             "of 'a/b/c'-keyed arrays; empty = seeded "
                             "random weights")
    parser.add_argument("--checkpoint_dir", default="",
                        help="restore the parameters of the latest valid "
                             "checkpoint version here at start-up "
                             "(strict=False: a parameter it lacks keeps "
                             "its seeded value); none yet = seeded "
                             "weights")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num_slots", type=int, default=4)
    parser.add_argument("--queue_capacity", type=int, default=64)
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--kv_paged", type=int, default=-1,
                        choices=(-1, 0, 1),
                        help="1 = block-paged pool, 0 = dense; -1 "
                             "resolves from EDL_KV_PAGED (dense unless "
                             "set)")
    parser.add_argument("--kv_block_size", type=int, default=16)
    parser.add_argument("--kv_num_blocks", type=int, default=0,
                        help="block budget; 0 = dense-equivalent bytes")
    parser.add_argument("--kv_shared", type=int, default=1, choices=(0, 1))
    parser.add_argument("--reload_poll_secs", type=float, default=2.0,
                        help="seconds between polls of --checkpoint_dir "
                             "for a newer version; 0 = explicit reloads "
                             "only")
    parser.add_argument("--draft_k", type=int, default=0,
                        help="speculative decode: tokens the draft "
                             "proposes a tick (paged pool only)")
    parser.add_argument("--draft_model_params", default="",
                        help="the draft transformer_lm's params; empty = "
                             "speculative decode off")
    parser.add_argument("--prefill_chunk_tokens", type=int, default=-1,
                        help="chunked prefill's tile width (paged pool "
                             "only); -1 resolves from "
                             "EDL_PREFILL_CHUNK_TOKENS, 0 = monolithic")
    parser.add_argument("--prefill_budget_ms", type=float, default=-1.0,
                        help="tile ms a tick may spend while decode "
                             "waits; -1 resolves from "
                             "EDL_PREFILL_BUDGET_MS (default 8), 0 = "
                             "unbounded")
    parser.add_argument("--profile", type=int, default=-1,
                        choices=(-1, 0, 1),
                        help="the step profiler; -1 resolves from "
                             "EDL_PROFILE (off)")
    parser.add_argument("--warmup_tokens", type=int, default=0,
                        help="generate this many tokens before serving")
    return parser.parse_args(args)


def build_model(args):
    """(model, checkpoint version it was restored from or 0)."""
    # imports deferred so --help works without torch initialized
    import numpy as np

    from elasticdl_tpu_torch.checkpoint.saver import (
        get_latest_checkpoint_version,
        load_checkpoint,
        restore_params_from_flat,
    )
    from elasticdl_tpu_torch.common.model_utils import (
        get_dict_from_params_str,
    )
    from elasticdl_tpu_torch.convert import params_from_flax
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        custom_model,
        flax_param_path,
    )
    from elasticdl_tpu_torch.serving.engine import float_weights

    kwargs = get_dict_from_params_str(args.model_params)
    model = custom_model(device=args.device, **kwargs)
    version = 0
    if args.checkpoint_dir:
        if get_latest_checkpoint_version(args.checkpoint_dir) >= 0:
            flat, version = load_checkpoint(args.checkpoint_dir)
            restore_params_from_flat(model, flax_param_path,
                                     float_weights(flat), strict=False)
            logger.info("serving checkpoint version-%d", version)
        else:
            logger.warning("no checkpoint under %r yet; serving seeded "
                           "weights", args.checkpoint_dir)
    if args.params_npz:
        with np.load(args.params_npz) as npz:
            model.load_state_dict(params_from_flax(dict(npz)))
    return model, version


def build_server(args):
    from elasticdl_tpu_torch.serving.server import (
        GenerationServer,
        ServingConfig,
    )

    from elasticdl_tpu_torch.common.model_utils import (
        get_dict_from_params_str,
    )
    from elasticdl_tpu_torch.model_zoo.transformer_lm import custom_model

    model, version = build_model(args)
    draft = None
    if args.draft_k > 0 and args.draft_model_params:
        draft = custom_model(
            device=args.device,
            **get_dict_from_params_str(args.draft_model_params))

    def unset(value):
        return None if value < 0 else value

    return GenerationServer(
        model,
        ServingConfig(
            num_slots=args.num_slots, queue_capacity=args.queue_capacity,
            top_k=args.top_k, top_p=args.top_p,
            kv_paged=unset(args.kv_paged),
            kv_block_size=args.kv_block_size,
            kv_num_blocks=args.kv_num_blocks,
            kv_shared=bool(args.kv_shared),
            draft_k=args.draft_k if draft is not None else 0,
            prefill_chunk_tokens=unset(args.prefill_chunk_tokens),
            prefill_budget_ms=unset(args.prefill_budget_ms),
            profile=unset(args.profile),
            checkpoint_dir=args.checkpoint_dir,
            reload_poll_secs=args.reload_poll_secs,
        ),
        model_version=version,
        draft=draft,
    )


def warmup(server, tokens):
    """Generate `tokens` tokens in-process before the first request is
    read, so the kernels' build and the allocator's growth are paid
    before traffic arrives."""
    if tokens > 0:
        server.generate([1, 2], tokens)
        logger.info("warmup complete (%d tokens)", tokens)


def serve_lines(server, lines):
    """Submit every request line, then collect the answers in order."""
    from elasticdl_tpu_torch.serving.admission import AdmissionError

    pending = []
    for line in lines:
        if not line.strip():
            continue
        spec = json.loads(line)
        if spec.get("status"):
            pending.append(("status", None))
            continue
        try:
            req = server.submit(
                spec["prompt"], spec["max_new_tokens"],
                temperature=spec.get("temperature", 0.0),
                seed=spec.get("seed", 0),
                deadline_ms=spec.get("deadline_ms", 0),
            )
            pending.append((req, None))
        except AdmissionError as e:
            pending.append((None, e))
    answers = []
    for req, err in pending:
        if req == "status":
            answers.append({"status": server.status()})
            continue
        if err is None:
            try:
                for _chunk in server.events(req):
                    pass
                answers.append({"tokens": req.prompt + req.generated})
                continue
            except AdmissionError as e:
                err = e
        answers.append({"error": err.code, "message": str(err)})
    return answers


def main(argv=None):
    args = parse_serving_args(argv)
    server = build_server(args).start()
    warmup(server, args.warmup_tokens)
    try:
        for answer in serve_lines(server, sys.stdin):
            print(json.dumps(answer), flush=True)
    finally:
        server.stop(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
