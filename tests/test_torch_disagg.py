"""Disaggregated prefill/decode serving in the port, against the JAX
package.

The chain-transfer messages byte for byte against elasticdl_pb2 (empty,
a large bytes leaf, repeated strings, nested blocks; both ways); the
codec's refusal of a mismatched arena layout; HandoffCoordinator's three
obligations against fake stubs (tests/test_disagg.py:118-217 on the
port); and one handoff over the transport on localhost: a prefill
replica exports, a decode replica imports and streams, equal to a
unified replica after its own prefill-only warm-up, with the same
tokens and ServerStatus fields as the same handoff between JAX
replicas over gRPC. CPU, tiny widths, fp32.
"""

import flax
import grpc
import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.proto import service as jservice
from elasticdl_tpu.serving import GenerationServer as JServer
from elasticdl_tpu.serving import ServingConfig as JConfig
from elasticdl_tpu.serving import disagg as jdisagg
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import service
from elasticdl_tpu_torch.serving.disagg import (
    HandoffCoordinator,
    HandoffError,
    chain_to_proto,
    proto_to_blocks,
)
from elasticdl_tpu_torch.serving.kv_pool import PagedKVPool
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

WAIT = 60  # seconds: every call in this file is bounded by it

# ------------------------------------------------------------- messages

_BIG = bytes(range(256)) * 4096  # a 1 MiB leaf: a multi-byte length

CASES = [
    ("ExportChainRequest", {}),
    ("ExportChainRequest", dict(prompt=[1, -2, 70000, 0],
                                transfer_id="xfer-9")),
    ("KvChainBlock", {}),
    ("KvChainBlock", dict(tokens=[5, 6, 7, 8], leaves=[b"", _BIG, b"\x00"])),
    ("TransferChainRequest", {}),
    ("TransferChainRequest", dict(
        transfer_id="xfer-é", block_size=-1,
        leaf_dtypes=["bfloat16", "", "int8", "float32"],
        blocks=[dict(), dict(tokens=[1, 2], leaves=[b"ab", _BIG]),
                dict(leaves=[b""])])),
    ("TransferChainResponse", {}),
    ("TransferChainResponse", dict(transfer_id="t", ok=True, blocks=63,
                                   tokens=1008, error="chain ✓")),
    ("AbortTransferRequest", dict(transfer_id="xfer-1")),
]


def _build(module, name, fields):
    fields = dict(fields)
    if name == "TransferChainRequest" and "blocks" in fields:
        fields["blocks"] = [module.KvChainBlock(**b)
                            for b in fields["blocks"]]
    return getattr(module, name)(**fields)


@pytest.mark.parametrize("name,fields", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_chain_messages_are_byte_equal_to_elasticdl_pb2(name, fields):
    ours = _build(pb, name, fields)
    theirs = _build(jpb, name, fields)
    wire = ours.SerializeToString()
    assert wire == theirs.SerializeToString()
    back = getattr(pb, name).FromString(theirs.SerializeToString())
    assert back == ours and back.SerializeToString() == wire
    assert getattr(jpb, name).FromString(wire) == theirs


def test_repeated_fields_parse_as_protobuf_does():
    """Occurrences of a repeated field concatenate across the payload,
    packed and unpacked tokens alike; an unknown field is skipped."""
    theirs = jpb.TransferChainRequest(
        leaf_dtypes=["int8"], blocks=[jpb.KvChainBlock(tokens=[1])])
    extra = jpb.TransferChainRequest(
        leaf_dtypes=["float32"], blocks=[jpb.KvChainBlock(leaves=[b"x"])])
    unknown = b"\xa8\x06\x07"  # field 101, varint 7
    ours = pb.TransferChainRequest.FromString(
        theirs.SerializeToString() + unknown + extra.SerializeToString())
    assert ours.leaf_dtypes == ["int8", "float32"]
    assert [b.tokens for b in ours.blocks] == [[1], []]
    unpacked = b"\x08\x05\x08\x06"  # tokens 5 and 6, one varint each
    assert pb.KvChainBlock.FromString(unpacked).tokens == [5, 6]
    with pytest.raises(TypeError):
        pb.TransferChainRequest(blocks=[jpb.KvChainBlock()])


# ---------------------------------------------------------------- codec


def _pool(block_size=4, kv="int8", layers=2):
    layout = (layers, 2, 8, torch.float32, kv)
    return PagedKVPool(layout, 16, 2, 6, block_size, share_prefix=True,
                       device="cpu")


def _payload_of(pool, prompt):
    gen = torch.Generator().manual_seed(17)
    for arenas in pool.pools:
        for arena in arenas:
            if arena.dtype == torch.int8:
                arena.copy_(torch.randint(-127, 128, arena.shape,
                                          generator=gen))
            else:
                arena.copy_(torch.rand(arena.shape, generator=gen))
    pool.seat(0, prompt, len(prompt))
    pool.register_prefix(0, prompt)
    pool.release(0)
    return chain_to_proto(pool.export_chain(prompt), pool.block_size,
                          pool.leaf_dtypes(), "xfer-m")


def test_codec_refuses_mismatched_arena_layouts():
    """Every geometry mismatch raises ValueError before any import
    (tests/test_disagg.py:95): block_size, leaf count (payload against
    pool), a block missing a leaf, a leaf of the wrong size, a dtype the
    pool does not hold; a round trip imports cleanly."""
    msg = _payload_of(_pool(), list(range(100, 116)))
    blocks, dtypes = proto_to_blocks(msg, _pool())
    assert _pool().import_chain(blocks, leaf_dtypes=dtypes) == (4, 16)
    with pytest.raises(ValueError, match="block_size"):
        proto_to_blocks(msg, _pool(block_size=8))
    with pytest.raises(ValueError, match="leaves"):
        proto_to_blocks(msg, _pool(kv=""))
    bad = pb.TransferChainRequest.FromString(msg.SerializeToString())
    del bad.blocks[0].leaves[-1]
    with pytest.raises(ValueError, match="leaves"):
        proto_to_blocks(bad, _pool())
    bad = pb.TransferChainRequest.FromString(msg.SerializeToString())
    bad.blocks[1].leaves[0] = bad.blocks[1].leaves[0][:-8]
    with pytest.raises(ValueError, match="values"):
        proto_to_blocks(bad, _pool())
    bad = pb.TransferChainRequest.FromString(msg.SerializeToString())
    bad.leaf_dtypes = ["int32"] * len(bad.leaf_dtypes)
    with pytest.raises(ValueError, match="arena dtype"):
        proto_to_blocks(bad, _pool())
    with pytest.raises(ValueError, match="dtypes"):
        _pool().import_chain(blocks, leaf_dtypes=dtypes[::-1])


# --------------------------------------------------- coordinator units


class _FakeStub(object):
    """The ServingStub surface the coordinator drives, scripted."""

    def __init__(self, payload=None, resp=None, abort_exc=None):
        self.payload = payload
        self.resp = resp
        self.abort_exc = abort_exc
        self.calls = []

    def generate(self, request, timeout=None):
        self.calls.append(("generate", request))
        return pb.GenerateResponse(tokens=list(request.prompt) + [0])

    def export_chain(self, request, timeout=None):
        self.calls.append(("export_chain", request))
        return self.payload

    def transfer_chain(self, payload, timeout=None):
        self.calls.append(("transfer_chain", payload))
        return self.resp

    def abort_transfer(self, request, timeout=None):
        self.calls.append(("abort_transfer", request))
        if self.abort_exc is not None:
            raise self.abort_exc
        return pb.TransferChainResponse(ok=True)


class _Rep(object):
    def __init__(self, stub, address="fake:0"):
        self.address = address
        self.stub = stub


class _Req(object):
    def __init__(self, prompt, temperature=0.0, seed=7):
        self.prompt = prompt
        self.temperature = temperature
        self.seed = seed


def _fake_payload(nblocks):
    return pb.TransferChainRequest(
        transfer_id="xfer-f", block_size=4, leaf_dtypes=["int8"],
        blocks=[pb.KvChainBlock(tokens=[1, 2, 3, 4], leaves=[b"x"])
                for _ in range(nblocks)])


def test_coordinator_export_warms_then_exports():
    """One prefill_only generate (max_new_tokens 1, the request's
    sampling knobs) before the export call, which carries the id."""
    stub = _FakeStub(payload=_fake_payload(2))
    payload = HandoffCoordinator().export_chain(
        _Rep(stub), _Req([1, 2, 3, 4, 5]), "xfer-f")
    assert len(payload.blocks) == 2
    assert [c[0] for c in stub.calls] == ["generate", "export_chain"]
    gen = stub.calls[0][1]
    assert gen.prefill_only and gen.max_new_tokens == 1
    assert gen.prompt == [1, 2, 3, 4, 5] and gen.seed == 7
    assert stub.calls[1][1].transfer_id == "xfer-f"


def test_coordinator_raises_on_empty_export():
    with pytest.raises(HandoffError, match="empty chain"):
        HandoffCoordinator().export_chain(
            _Rep(_FakeStub(payload=_fake_payload(0))), _Req([1, 2]),
            "xfer-f")


def test_coordinator_import_raises_on_refusal_or_no_coverage():
    co = HandoffCoordinator()
    refused = pb.TransferChainResponse(ok=False, error="dtype")
    with pytest.raises(HandoffError, match="dtype"):
        co.import_chain(_Rep(_FakeStub(resp=refused)), _fake_payload(1))
    empty = pb.TransferChainResponse(ok=True, blocks=0)
    with pytest.raises(HandoffError, match="no blocks"):
        co.import_chain(_Rep(_FakeStub(resp=empty)), _fake_payload(1))
    warm = pb.TransferChainResponse(ok=True, blocks=3, tokens=12)
    assert co.import_chain(_Rep(_FakeStub(resp=warm)),
                           _fake_payload(1)).blocks == 3


def test_coordinator_abort_is_best_effort():
    stub = _FakeStub(abort_exc=RuntimeError("replica gone"))
    HandoffCoordinator().abort_transfer(_Rep(stub), "xfer-f")
    assert [c[0] for c in stub.calls] == ["abort_transfer"]


def test_transfer_ids_are_unique_across_coordinators():
    a, b = HandoffCoordinator(), HandoffCoordinator()
    ids = [a.new_transfer_id() for _ in range(3)]
    ids += [b.new_transfer_id() for _ in range(3)]
    assert len(set(ids)) == 6 and all(i.startswith("xfer-") for i in ids)


# ------------------------------------------------- over the transport

PARAMS = "vocab_size=128; seq_len=64; embed_dim=32; num_heads=2; num_layers=2"
CFG = dict(vocab_size=128, seq_len=64, embed_dim=32, num_heads=2,
           num_layers=2)
BLOCK = 4
PROMPTS = [list(range(3, 16)), list(range(40, 52))]  # a suffix; whole blocks
NEW = 6
STATUS_FIELDS = ("role", "chain_exports", "chain_imports",
                 "chain_import_tokens", "transfer_aborts",
                 "transfers_inflight", "prefix_hit_tokens", "completed",
                 "kv_blocks_cached", "kv_paged", "kv_shared")


@pytest.fixture(scope="module")
def weights():
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=PARAMS, seed=0)
    toks = (np.arange(65)[None, :] % 128).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    sd = params_from_flax(jax.tree.map(
        np.asarray, flax.core.meta.unbox(state.params)))
    return trainer, state, sd


def _config(name, extra):
    """A replica named after its role ("dense": a unified dense one)."""
    base = dict(num_slots=2, queue_capacity=16, kv_paged=True,
                kv_block_size=BLOCK, kv_num_blocks=32, kv_shared=True,
                port=0, reload_poll_secs=0, role=name)
    base.update(extra)
    return base


def _replicas(kind, weights, roles):
    """{role: (server, rep)} of `kind` ("port" or "jax") on localhost."""
    trainer, state, sd = weights
    out = {}
    for role, extra in roles:
        if kind == "jax":
            server = JServer(trainer, state, JConfig(
                runtime_health=False, **_config(role, extra))).start()
            stub = jservice.ServingStub(jservice.build_channel(
                "localhost:%d" % server.port))
        else:
            model = TransformerLM(device="cpu", **CFG)
            model.load_state_dict(sd)
            server = GenerationServer(model, ServingConfig(
                **_config(role, extra))).start(transport=True)
            stub = service.ServingStub(service.build_channel(
                "localhost:%d" % server.port))
        out[role] = (server, _Rep(stub, "localhost:%d" % server.port))
    return out


def _code(fn):
    try:
        fn()
    except grpc.RpcError as e:
        return e.code().name
    except service.RpcError as e:
        return e.code()
    raise AssertionError("the call did not fail")


def _handoff(kind, weights):
    """The handoff battery on one package's replicas: for each prompt the
    coordinator exports from the prefill replica and imports into the
    decode replica, which streams it; a unified replica streams it after
    its own prefill-only warm-up; then an abort, a payload of the wrong
    block size and the error codes. Returns what is compared."""
    mod, co_cls = ((jpb, jdisagg.HandoffCoordinator) if kind == "jax"
                   else (pb, HandoffCoordinator))
    reps = _replicas(kind, weights, [("prefill", {}), ("decode", {}),
                                     ("unified", {}),
                                     ("dense", dict(kv_paged=False,
                                                    role="unified"))])
    out = {"payloads": [], "streams": [], "unified": [], "imports": []}
    try:
        pre, dec, uni = (reps[r][1] for r in ("prefill", "decode",
                                              "unified"))
        co = co_cls(timeout_secs=WAIT)
        for prompt in PROMPTS:
            payload = co.export_chain(pre, _Req(prompt),
                                      co.new_transfer_id())
            out["payloads"].append(payload)
            resp = co.import_chain(dec, payload)
            out["imports"].append((resp.ok, resp.blocks, resp.tokens))
            req = mod.GenerateRequest(prompt=prompt, max_new_tokens=NEW)
            out["streams"].append([t for c in dec.stub.generate_stream(
                req, timeout=WAIT) for t in c.tokens])
            uni.stub.generate(mod.GenerateRequest(
                prompt=prompt, max_new_tokens=1, prefill_only=True),
                timeout=WAIT)
            out["unified"].append([t for c in uni.stub.generate_stream(
                req, timeout=WAIT) for t in c.tokens])
        co.abort_transfer(pre, "xfer-aborted")
        wrong = mod.TransferChainRequest.FromString(
            out["payloads"][0].SerializeToString())
        wrong.block_size = 2 * BLOCK
        resp = dec.stub.transfer_chain(wrong, timeout=WAIT)
        out["wrong_block_size"] = (resp.ok, "block_size" in resp.error)
        out["not_found"] = _code(lambda: pre.stub.export_chain(
            mod.ExportChainRequest(prompt=[99, 98, 97, 96, 95]),
            timeout=WAIT))
        out["dense"] = _code(lambda: reps["dense"][1].stub.export_chain(
            mod.ExportChainRequest(prompt=PROMPTS[0]), timeout=WAIT))
        out["status"] = {
            role: {f: getattr(rep.stub.server_status(
                mod.ServerStatusRequest(), timeout=WAIT), f)
                for f in STATUS_FIELDS}
            for role, (_server, rep) in reps.items()}
    finally:
        for server, _rep in reps.values():
            server.stop()
    return out


def _rows(payload, dtypes):
    return [np.frombuffer(leaf, dtype=dt) for blk in payload.blocks
            for leaf, dt in zip(blk.leaves, dtypes)]


def test_handoff_over_the_transport_matches_unified_and_jax(weights):
    """Port replicas on localhost: the decode replica's streams after a
    handoff equal a unified replica's after its own warm-up; the import
    covers every full prompt block; server_status shows the roles, the
    chain counters and the transfer ledger (transfers_inflight back at
    0, one abort); a wrong block size is ok=False, an unindexed prompt's
    export NOT_FOUND, a dense replica's FAILED_PRECONDITION. The same
    battery between JAX replicas over gRPC gives the same tokens,
    statuses and payload layout, rows within fp32 rounding."""
    ours = _handoff("port", weights)
    theirs = _handoff("jax", weights)
    assert ours["streams"] == ours["unified"]
    assert all(len(s) == NEW for s in ours["streams"])
    assert ours["imports"] == [(True, len(p) // BLOCK,
                                len(p) // BLOCK * BLOCK) for p in PROMPTS]
    assert ours["wrong_block_size"] == (False, True)
    assert (ours["not_found"], ours["dense"]) == ("NOT_FOUND",
                                                   "FAILED_PRECONDITION")
    st = ours["status"]
    assert st["prefill"]["role"] == "prefill" and st["decode"]["role"] == (
        "decode")
    assert st["prefill"]["chain_exports"] == len(PROMPTS)
    assert st["prefill"]["transfer_aborts"] == 1
    assert st["decode"]["chain_imports"] == len(PROMPTS)
    assert st["decode"]["chain_import_tokens"] == sum(
        len(p) // BLOCK * BLOCK for p in PROMPTS)
    assert all(s["transfers_inflight"] == 0 for s in st.values())
    # the decode replica ran no prompt block's prefill: every full block
    # seated by prefix hit (a block-aligned prompt re-runs its last row)
    assert st["decode"]["prefix_hit_tokens"] == st["decode"][
        "chain_import_tokens"]
    # against the JAX replicas
    for key in ("streams", "unified", "imports", "wrong_block_size",
                "not_found", "dense", "status"):
        assert ours[key] == theirs[key], key
    for p, j in zip(ours["payloads"], theirs["payloads"]):
        assert (p.block_size, list(p.leaf_dtypes)) == (
            j.block_size, list(j.leaf_dtypes))
        assert [b.tokens for b in p.blocks] == [list(b.tokens)
                                                for b in j.blocks]
        for a, b in zip(_rows(p, p.leaf_dtypes), _rows(j, j.leaf_dtypes)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
