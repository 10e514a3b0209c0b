"""The serving engines' in-step int8 dequantize (EDL_SERVING_FUSED_DEQUANT=1)
in the port against the JAX package's engines, on one int8 tree.

Weights are drawn by numpy in the flax layout and quantized by each
package's `quantize_params` (the trees are equal bit for bit,
tests/test_torch_finetune_export.py). The fused engines must serve the
greedy streams of the JAX engines under the same flag (fp32, exact
tokens) and of the port's once-at-load engines (fp32 and bf16, every
engine mode); the model keeps no float copy of a quantized leaf; the
recompile sentry counts JAX's compiles by name in both modes; a reload
that changes quantization raises in both packages with JAX's message.
"""

import flax
import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.api import quantization as jq
from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.observability import runtime_health as jrh
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.serving.admission import ServingRequest as JaxRequest
from elasticdl_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxDenseEngine,
)
from elasticdl_tpu.serving.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.api import quantization as q
from elasticdl_tpu_torch.checkpoint.saver import (
    CheckpointSaver,
    params_tree_leaves,
)
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.observability import runtime_health as prh
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    StepProfiler,
)
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

CFG = dict(vocab_size=64, seq_len=48, embed_dim=64, num_heads=2,
           num_layers=2)
PARAMS = "; ".join("%s=%r" % kv for kv in CFG.items())
MIN_SIZE = 1024  # quantizes every kernel and both embeddings here
SLOTS, BLOCK = 3, 4
PREFIX = [5, 9, 14, 3, 22, 7, 41, 18]
REQUESTS = [(PREFIX + [11, 2], 6), (list(range(30, 43)), 7),
            (PREFIX + [33, 1, 60], 5), ([7, 7, 8], 1),
            (PREFIX + [11, 2, 50, 51, 52], 9)]
QUANT_MSG = "hot reload cannot change quantization"


@pytest.fixture(scope="module")
def rig():
    """(JAX trainer, its state, flax numpy params, their int8 tree)."""
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=PARAMS, seed=0)
    toks = (np.arange(CFG["seq_len"] + 1)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    rs = np.random.RandomState(27)
    params = jax.tree.map(
        lambda a: (rs.randn(*a.shape) / np.sqrt(a.shape[0])
                   if a.ndim == 2 else 1.0 + 0.1 * rs.randn(*a.shape)
                   ).astype(np.float32),
        jax.tree.map(np.asarray, flax.core.meta.unbox(state.params)))
    return trainer, state, params, q.quantize_params(params, MIN_SIZE)


def once_at_load(qtree, **kw):
    """The default mode's model: the int8 tree dequantized at the load."""
    return q.load_params(tzoo.custom_model(device="cpu", **dict(CFG, **kw)),
                         qtree)


def held(qtree, **kw):
    """The fused mode's model: the int8 leaves resident, the float ones
    restored."""
    model = tzoo.custom_model(device="cpu", **dict(CFG, **kw))
    q.hold_int8(model, qtree)
    sd = params_from_flax(q.dequantize_params(qtree))
    names = dict(model.named_parameters())
    with torch.no_grad():
        for key, p in names.items():
            p.copy_(sd[key])
    return model


def engine_of(model, paged, **kw):
    if paged:
        return PagedContinuousBatchingEngine(model, SLOTS, block_size=BLOCK,
                                             **kw)
    return ContinuousBatchingEngine(model, SLOTS, **kw)


def drive(engine, reqs):
    pending = list(reqs)
    for _ in range(400):
        while pending and engine.free_slots() and engine.can_seat(
                pending[0]):
            engine.insert(pending.pop(0))
        if not pending and not engine.active_count():
            break
        engine.step()
    assert not pending and not engine.active_count()
    return [list(r.generated) for r in reqs]


def jax_engine(rig, tree, paged, monkeypatch, fused):
    trainer, state, _params, _qtree = rig
    monkeypatch.setenv("EDL_SERVING_FUSED_DEQUANT", "1" if fused else "0")
    st = state.replace(params=tree)
    if paged:
        return JaxPagedEngine(trainer, st, SLOTS, block_size=BLOCK,
                              share_prefix=True)
    return JaxDenseEngine(trainer, st, SLOTS)


@pytest.mark.parametrize("paged", [False, True])
def test_fused_streams_equal_jax_and_once_at_load(rig, paged, monkeypatch):
    """fp32: the port's fused engine, the JAX engine under the flag and
    the port's once-at-load engine serve the same greedy streams."""
    _t, _s, _params, qtree = rig
    jtree = jq.quantize_params(_params, MIN_SIZE)
    jeng = jax_engine(rig, jtree, paged, monkeypatch, fused=True)
    want = drive(jeng, [JaxRequest(p, n) for p, n in REQUESTS])
    fused = engine_of(held(qtree), paged)
    default = engine_of(once_at_load(qtree), paged)
    assert fused._exec_qz and default._qz and not default._exec_qz
    for eng in (fused, default):
        assert drive(eng, [ServingRequest(p, n)
                           for p, n in REQUESTS]) == want


MODES = {
    "dense": (False, {}),
    "paged": (True, {}),
    "profiled": (True, {"profile": True}),
    "speculative": (True, {"draft_k": 2}),
    "chunked": (True, {"prefill_chunk_tokens": 4}),
    "kv_int8": (True, {"kv_cache_dtype": "int8"}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_modes_serve_the_once_at_load_tokens_bf16(rig, mode):
    """bf16, every engine mode: each product sees the once-at-load
    weights bit for bit, so the streams are equal token for token; the
    draft keeps float weights."""
    _t, _s, params, qtree = rig
    paged, opts = MODES[mode]
    opts = dict(opts)
    model_kw = {"dtype": torch.bfloat16}
    if opts.pop("kv_cache_dtype", None):
        model_kw["kv_cache_dtype"] = "int8"
    profile = opts.pop("profile", False)
    streams, logits = [], []
    for build in (held, once_at_load):
        kw = dict(opts)
        if "draft_k" in kw:
            kw["draft"] = tzoo.custom_model(
                device="cpu", seed=1, **dict(CFG, num_layers=1, **model_kw))
        eng = engine_of(build(qtree, **model_kw), paged, **kw)
        logits.append(eng.model(torch.tensor([REQUESTS[1][0]]))[0])
        if profile:
            eng.profiler = StepProfiler()
        streams.append(drive(eng, [ServingRequest(p, n)
                                   for p, n in REQUESTS]))
        if profile:
            assert eng.profiler.snapshot()["decode"]["count"] > 0
        if "draft_k" in kw:
            assert eng.draft_proposed > 0
    assert torch.equal(logits[0], logits[1])
    assert streams[0] == streams[1]


def test_fused_entry_holds_no_float_copy(rig, tmp_path, monkeypatch):
    """serving/main.py under the flag: every quantized leaf is resident
    as int8 and fp32 scales with no float parameter left, the other
    leaves restore, and the replica answers the once-at-load tokens."""
    _t, _s, _params, qtree = rig
    CheckpointSaver(None, str(tmp_path)).save_flat(dict(
        params_tree_leaves(qtree), **{".step": np.int32(3)}), 3)
    argv = ["--device", "cpu", "--model_params", PARAMS,
            "--checkpoint_dir", str(tmp_path), "--reload_poll_secs", "0",
            "--kv_paged", "1", "--kv_block_size", str(BLOCK)]
    answers, models = [], []
    for flag in ("0", "1"):
        monkeypatch.setenv("EDL_SERVING_FUSED_DEQUANT", flag)
        server = port_main.build_server(port_main.parse_serving_args(argv))
        models.append(server.engine.model)
        server.start()
        try:
            answers.append(port_main.serve_lines(server, [
                '{"prompt": %s, "max_new_tokens": %d}' % (p, n)
                for p, n in REQUESTS]))
        finally:
            server.stop()
    assert answers[0] == answers[1]
    float_model, int8_model = models
    assert float_model.weights_int8 and int8_model.weights_int8
    names = {k for k, _p in int8_model.named_parameters()}
    buffers = dict(int8_model.named_buffers())
    quantized = [k for k, _p in float_model.named_parameters()
                 if k not in names]
    assert len(quantized) == 4 * CFG["num_layers"] + 3  # wte, wpe, head
    for key in quantized:
        assert buffers[key + "_q8"].dtype == torch.int8
        assert buffers[key + "_scale"].dtype == torch.float32
    ln = dict(int8_model.named_parameters())["ln_f.weight"]
    assert torch.equal(ln, dict(float_model.named_parameters())[
        "ln_f.weight"])

    def resident(m):
        return sum(t.numel() * t.element_size()
                   for t in list(m.parameters()) + list(m.buffers()))

    assert resident(int8_model) < resident(float_model) / 3


@pytest.mark.parametrize("fused", [False, True])
def test_compiles_by_name_equal_jax(rig, fused, monkeypatch):
    """One request through each engine, then a reload from the
    checkpoint's leaves: the sentries hold the same names and counts
    (`dequant` once in the default mode: JAX retraces for the
    checkpoint's leaf types; none in the fused mode)."""
    _t, _s, params, qtree = rig
    jtree = jq.quantize_params(params, MIN_SIZE)
    for paged in (False, True):
        jeng = jax_engine(rig, jtree, paged, monkeypatch, fused)
        peng = engine_of(held(qtree) if fused else once_at_load(qtree),
                         paged)
        js, ps = jrh.RecompileSentry(), prh.RecompileSentry()
        jeng.sentry, peng.sentry = js, ps
        prompt, n = REQUESTS[0]
        drive(jeng, [JaxRequest(prompt, n)])
        drive(peng, [ServingRequest(prompt, n)])
        jeng.set_params(jeng_state(rig, jtree), 2)
        peng.set_params(params_tree_leaves(qtree), 2)
        jc, pc = js.snapshot()["compiles"], ps.snapshot()["compiles"]
        assert pc == jc
        assert jc.get("dequant") == (None if fused else 1)


def jeng_state(rig, tree):
    """The reload's state: the tree's leaves as a checkpoint returns
    them (numpy)."""
    return rig[1].replace(params=jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("fused", [False, True])
def test_reload_changing_quantization_raises_in_both(rig, fused,
                                                     monkeypatch):
    """An int8 engine refuses float weights and a float engine int8 ones,
    in both packages, with JAX's message; nothing is copied."""
    trainer, state, params, qtree = rig
    jtree = jq.quantize_params(params, MIN_SIZE)
    jeng = jax_engine(rig, jtree, False, monkeypatch, fused)
    with pytest.raises(ValueError, match=QUANT_MSG):
        jeng.set_params(state.replace(params=params), 2)
    jfloat = jax_engine(rig, params, False, monkeypatch, fused)
    with pytest.raises(ValueError, match=QUANT_MSG):
        jfloat.set_params(state.replace(params=jtree), 2)
    peng = engine_of(held(qtree) if fused else once_at_load(qtree), False)
    before = {k: v.clone() for k, v in peng.model.state_dict().items()}
    with pytest.raises(ValueError, match=QUANT_MSG):
        peng.set_params(params_tree_leaves(params), 2)
    pfloat = engine_of(tzoo.custom_model(device="cpu", **CFG), False)
    with pytest.raises(ValueError, match=QUANT_MSG):
        pfloat.set_params(params_tree_leaves(qtree), 2)
    after = peng.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert peng.model_version == 0
