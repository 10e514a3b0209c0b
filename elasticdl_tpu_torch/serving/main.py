"""Serving entry point of the PyTorch port: the port of
elasticdl_tpu/serving/main.py.

Builds the sequence model from a zoo spec (`--model_zoo` / `--model_def`,
by default the port's own `transformer_lm`; the model must have a
`seq_len`) with seeded random weights, the `.params` of the latest valid
checkpoint under --checkpoint_dir (which either package's trainer
wrote), or JAX-package params converted from an .npz, and serves
generate / generate_stream / server_status / reload_checkpoint and the
chain handoff's export_chain / transfer_chain / abort_transfer on
`--port` (0: an ephemeral one) over the port's transport
(proto/service.py), with at most `--max_workers` handlers at once. Once
bound it prints `SERVING_READY port=N`; it serves until SIGTERM or
SIGINT, which drain it: admission closes, queued requests get
RESOURCE_EXHAUSTED, requests in flight finish, then the transport
stops.

    python -m elasticdl_tpu_torch.serving.main --device cuda --port 50051 \\
        --model_params "vocab_size=32000; seq_len=1024; embed_dim=1024; \\
num_heads=8; num_layers=8; dtype='bf16'" --num_slots 8 --kv_paged 1 \\
        --kv_block_size 16

and from Python:

    from elasticdl_tpu_torch.proto import messages as pb
    from elasticdl_tpu_torch.proto.service import ServingStub, build_channel

    stub = ServingStub(build_channel("localhost:50051"))
    for chunk in stub.generate_stream(pb.GenerateRequest(
            prompt=[1, 2, 3], max_new_tokens=8), timeout=60):
        print(list(chunk.tokens), chunk.done, chunk.model_version)

The engine is chosen as the JAX entry point chooses it: `--kv_paged`
-1 (the default) resolves from EDL_KV_PAGED, so the dense pool unless
that is set; 1 is the block-paged pool, which speculative decode
(`--draft_k` with a draft model: `--draft_model_def`, default the
target's, and `--draft_model_params`; its `seed` picks its weights) and
chunked prefill (`--prefill_chunk_tokens`, `--prefill_budget_ms`) need,
as do the host spill tier (`--kv_host_bytes`: the byte budget for
evicted prefix chains kept in host memory and revived by upload; -1
resolves from EDL_KV_HOST_BYTES, 0 = off) and the chain handoff of
disaggregated serving. `--role` is the phase the replica advertises in
its status (prefill, decode or unified; "" resolves from
EDL_SERVING_ROLE, default unified): a prefill replica answers
`prefill_only` generates and `export_chain`, a decode replica
`transfer_chain` (every role answers all three).
`--profile 1` arms the step profiler. With --checkpoint_dir the server
keeps following the directory and swaps in newer versions between
decode steps, `--reload_poll_secs` apart (0 = only through
reload_checkpoint). `--warmup_tokens` generates that many tokens
through the unwrapped servicer before SERVING_READY, then drops the
latency histograms. An int8 KV cache is a model parameter, as in the
JAX package: `--model_params "...; kv_cache_dtype='int8'"`. A
checkpoint of int8 weights (api/quantization) is served dequantized
once at load.

Not accepted yet (each raises with the ROADMAP item that brings it):
`--metrics_port`, `--forensics`, `--runtime_health`,
`--stall_after_secs` and `--tensorboard_log_dir` (item 6, the
replica's metrics plane). `serve_lines` is a library function that
answers JSON request lines in-process.
"""

import argparse
import json
import logging
import os
import signal
import sys
import threading

logger = logging.getLogger(__name__)


#: the port's zoo, the default --model_zoo
PORT_ZOO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "model_zoo")

_ITEM6 = "ROADMAP Queue 1 item 6 (the replica's metrics plane)"
#: the JAX entry's flags the port does not take yet -> what brings them
NOT_PORTED = {
    "--metrics_port": _ITEM6, "--forensics": _ITEM6,
    "--runtime_health": _ITEM6, "--stall_after_secs": _ITEM6,
    "--tensorboard_log_dir": _ITEM6,
}


def parse_serving_args(args=None):
    parser = argparse.ArgumentParser(
        description="elasticdl-tpu PyTorch generation server"
    )
    parser.add_argument("--model_zoo", default=PORT_ZOO,
                        help="the directory of zoo modules (default: the "
                             "port's own, elasticdl_tpu_torch/model_zoo)")
    parser.add_argument("--model_def", default="transformer_lm.custom_model",
                        help="'<module path>.<model fn>' under --model_zoo")
    parser.add_argument("--model_params", default="")
    parser.add_argument("--port", type=int, default=50051,
                        help="the transport's port; 0 = an ephemeral one")
    parser.add_argument("--max_workers", type=int, default=64,
                        help="handlers that may run at once; size above "
                             "the concurrent calls expected (a pool full "
                             "of streams starves server_status)")
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
    parser.add_argument("--kv_host_bytes", type=int, default=-1,
                        help="host spill tier's byte budget (paged pool "
                             "only); -1 resolves from EDL_KV_HOST_BYTES, "
                             "0 = off")
    parser.add_argument("--role", default="",
                        choices=("", "prefill", "decode", "unified"),
                        help="the phase the replica advertises; empty "
                             "resolves from EDL_SERVING_ROLE (unified)")
    parser.add_argument("--reload_poll_secs", type=float, default=2.0,
                        help="seconds between polls of --checkpoint_dir "
                             "for a newer version; 0 = explicit reloads "
                             "only")
    parser.add_argument("--draft_k", type=int, default=0,
                        help="speculative decode: tokens the draft "
                             "proposes a tick (paged pool only)")
    parser.add_argument("--draft_model_def", default="",
                        help="the draft's model_def under --model_zoo; "
                             "empty = the target's")
    parser.add_argument("--draft_model_params", default="",
                        help="the draft's params; empty = speculative "
                             "decode off")
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
    parsed, unknown = parser.parse_known_args(args)
    for arg in unknown:
        flag = arg.split("=", 1)[0]
        if flag in NOT_PORTED:
            parser.error("%s is not ported yet: %s" % (flag,
                                                       NOT_PORTED[flag]))
    if unknown:
        parser.error("unrecognized arguments: %s" % " ".join(unknown))
    return parsed


def _spec(args, model_def):
    from elasticdl_tpu_torch.common.model_utils import get_model_spec

    return get_model_spec(args.model_zoo, model_def)


def _create(spec, params, device):
    model = spec.create_model(params, device=device)
    if getattr(model, "seq_len", None) is None:
        raise ValueError(
            "the serving entry needs a sequence model with a seq_len; "
            "%s has none" % type(model).__name__)
    return model


def build_model(args):
    """(model, checkpoint version it was restored from or 0)."""
    # imports deferred so --help works without torch initialized
    import numpy as np

    from elasticdl_tpu_torch.checkpoint.saver import (
        get_latest_checkpoint_version,
        load_checkpoint,
        restore_params_from_flat,
    )
    from elasticdl_tpu_torch.convert import params_from_flax
    from elasticdl_tpu_torch.serving.engine import float_weights

    spec = _spec(args, args.model_def)
    model = _create(spec, args.model_params, args.device)
    version = 0
    if args.checkpoint_dir:
        if get_latest_checkpoint_version(args.checkpoint_dir) >= 0:
            flat, version = load_checkpoint(args.checkpoint_dir)
            restore_params_from_flat(model, spec.flax_param_path,
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

    model, version = build_model(args)
    draft = None
    if args.draft_k > 0 and args.draft_model_params:
        draft = _create(_spec(args, args.draft_model_def or args.model_def),
                        args.draft_model_params, args.device)

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
            kv_host_bytes=unset(args.kv_host_bytes),
            role=args.role or None,
            draft_k=args.draft_k if draft is not None else 0,
            prefill_chunk_tokens=unset(args.prefill_chunk_tokens),
            prefill_budget_ms=unset(args.prefill_budget_ms),
            profile=unset(args.profile),
            checkpoint_dir=args.checkpoint_dir,
            reload_poll_secs=args.reload_poll_secs,
            port=args.port,
            max_workers=args.max_workers,
        ),
        model_version=version,
        draft=draft,
    )


def warmup(server, tokens):
    """Generate `tokens` tokens through the unwrapped servicer (an armed
    fault rule never sees it) before the server reports ready, so the
    kernels' build and the allocator's growth are paid before traffic
    arrives; then drop the latency histograms, so that request never
    shows in the percentiles."""
    from elasticdl_tpu_torch.proto import messages as pb

    if tokens > 0:
        server.raw_servicer.generate(
            pb.GenerateRequest(prompt=[1, 2], max_new_tokens=tokens))
        server.telemetry.reset_latency()
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
    server = build_server(args).start(transport=True)
    done = threading.Event()

    def _graceful(_signum, _frame):
        logger.info("signal received: draining and stopping")
        done.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        warmup(server, args.warmup_tokens)
        print("SERVING_READY port=%d" % server.port, flush=True)
        while not done.wait(1.0):
            if not server.scheduler.is_alive():
                raise RuntimeError("the serving scheduler stopped: %r"
                                   % (server.scheduler.crashed,))
    finally:
        server.stop(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
