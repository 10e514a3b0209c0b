"""Hot checkpoint reload in the port: the CheckpointWatcher's failure
isolation (tests/test_hot_reload.py's battery, on checkpoints of a real
transformer_lm written by the JAX package's saver and by the port's),
the engine's in-place swap into the compute dtype, and a server that
follows a checkpoint dir while requests decode (tests/
test_serving_e2e.py:171), against the JAX package's offline decode with
the new weights. CPU, the rig size of tests/test_torch_serving.py.
"""

import os
import time

import flax
import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.api import generation as jgen
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api.generation import autoregressive_generate
from elasticdl_tpu_torch.checkpoint.saver import (
    CheckpointSaver,
    load_checkpoint,
    restore_params_from_flat,
)
from elasticdl_tpu_torch.common.fault_injection import FaultInjector
from elasticdl_tpu_torch.common.model_utils import (
    load_model_spec_from_module as port_spec,
)
from elasticdl_tpu_torch.convert import flax_param_path, params_from_flax
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from elasticdl_tpu_torch.serving.hot_reload import (
    CheckpointWatcher,
    ReloadError,
)
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig
from elasticdl_tpu_torch.training.trainer import Trainer
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

CFG = dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=2,
           num_layers=2)
PARAMS = "vocab_size=64; seq_len=32; embed_dim=32; num_heads=2; num_layers=2"


def _jax(seed, params=PARAMS):
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JTrainer(load_model_spec_from_module(zoo), mesh=mesh,
                       model_params=params, seed=seed)
    toks = (np.arange(33)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    sd = params_from_flax(jax.tree.map(
        np.asarray, flax.core.meta.unbox(state.params)))
    return trainer, state, sd


@pytest.fixture(scope="module")
def rig():
    """Version 3's weights (JAX seed 0) and version 5/7's (seed 123)."""
    return _jax(0), _jax(123)


def port_model(sd=None, **kw):
    model = TransformerLM(device="cpu", **dict(CFG, **kw))
    if sd is not None:
        model.load_state_dict(sd)
    return model


def jsave(path, state, version):
    JSaver(str(path), checkpoint_steps=1, num_shards=2).save(state, version)


def truncate_shard(path, version):
    shard = os.path.join(str(path), "version-%d" % version,
                         "variables-0-of-2.ckpt")
    with open(shard, "r+b") as f:
        f.truncate(10)


def make_watcher(path, template, sleeps=None, **kwargs):
    kwargs.setdefault("poll_secs", 0.0)
    kwargs.setdefault(
        "sleep", sleeps.append if sleeps is not None else lambda s: None)
    return CheckpointWatcher(str(path), template, **kwargs)


def weights_of(flat):
    model = port_model()
    restore_params_from_flat(model, flax_param_path, flat, strict=True)
    return {k: v.clone() for k, v in model.state_dict().items()}


def same_weights(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------- watcher


def test_poll_loads_newer_version_from_either_saver(rig, tmp_path):
    (_t, state, sd), _v7 = rig
    jsave(tmp_path, state, 3)
    w = make_watcher(tmp_path, port_model())
    flat, version = w.poll(force=True)
    assert version == w.version == 3 and not w.reload_failed
    assert same_weights(weights_of(flat), sd)
    assert w.poll(force=True) is None  # nothing newer
    # the port's saver: a port Trainer's state at version 4
    spec = port_spec(tzoo)
    trainer = Trainer(spec, model_params=PARAMS, device="cpu")
    pstate = trainer.init_state(None, params=sd)
    CheckpointSaver(trainer, str(tmp_path)).save(pstate, 4)
    flat, version = w.poll(force=True)
    assert version == 4 and same_weights(weights_of(flat), sd)


def test_truncated_checkpoint_latches_and_keeps_old_weights(rig, tmp_path):
    (_t, state, sd), (_t2, state2, _sd2) = rig
    jsave(tmp_path, state, 3)
    sleeps = []
    engine = ContinuousBatchingEngine(port_model(sd), 2)
    w = make_watcher(tmp_path, engine.model, sleeps=sleeps)
    engine.set_params(*w.poll(force=True))
    jsave(tmp_path, state2, 5)
    truncate_shard(tmp_path, 5)
    assert w.poll(force=True) is None
    assert sleeps == [w.backoff_secs, w.backoff_secs * 2]
    assert w.reload_failed and "CheckpointCorruptError" in w.last_error
    assert w.version == 3 and engine.model_version == 3
    assert same_weights(engine.model.state_dict(), sd)
    assert w.poll(force=True) is None  # the torn version is not re-read
    assert sleeps == [w.backoff_secs, w.backoff_secs * 2]


def test_good_version_clears_the_failure_latch(rig, tmp_path):
    (_t, state, _sd), (_t2, state2, sd2) = rig
    jsave(tmp_path, state, 3)
    w = make_watcher(tmp_path, port_model())
    w.poll(force=True)
    jsave(tmp_path, state, 5)
    truncate_shard(tmp_path, 5)
    w.poll(force=True)
    assert w.reload_failed and w.version == 3
    jsave(tmp_path, state2, 7)
    flat, version = w.poll(force=True)
    assert version == 7 and not w.reload_failed and w.last_error == ""
    assert same_weights(weights_of(flat), sd2)


def test_a_checkpoint_of_another_shape_keeps_the_weights(rig, tmp_path):
    """Architecture drift: a seq_len-16 model's checkpoint fails the fit
    check before anything is copied."""
    (_t, state, sd), _v7 = rig
    jsave(tmp_path, state, 3)
    _t16, state16, _sd16 = _jax(0, PARAMS.replace("seq_len=32",
                                                  "seq_len=16"))
    jsave(tmp_path, state16, 5)
    model = port_model(sd)
    w = make_watcher(tmp_path, model, start_version=3)
    assert w.poll(force=True) is None
    assert w.reload_failed and "wpe" in w.last_error
    assert same_weights(model.state_dict(), sd)


def test_load_version_rolls_back_and_is_idempotent(rig, tmp_path):
    (_t, state, sd), (_t2, state2, _sd2) = rig
    jsave(tmp_path, state, 3)
    jsave(tmp_path, state2, 5)
    w = make_watcher(tmp_path, port_model())
    assert w.poll(force=True)[1] == 5
    flat, version = w.load_version(3)  # poll never goes back; this does
    assert version == w.version == 3
    assert same_weights(weights_of(flat), sd)
    assert w.load_version(3) is None


def test_load_version_failure_raises_reload_error(rig, tmp_path):
    (_t, state, _sd), _v7 = rig
    jsave(tmp_path, state, 3)
    w = make_watcher(tmp_path, port_model())
    w.poll(force=True)
    jsave(tmp_path, state, 5)
    truncate_shard(tmp_path, 5)
    with pytest.raises(ReloadError):
        w.load_version(5)
    assert w.reload_failed and w.version == 3
    with pytest.raises(ReloadError):
        w.load_version(9)  # no such version


def test_injected_checkpoint_read_fault_is_survived(rig, tmp_path):
    """Two reads dropped by the fault injector burn two attempts; the
    third loads. (The JAX test arms `error`, which the injector fires
    only after a handler, so its hook never fires there.)"""
    (_t, state, _sd), _v7 = rig
    jsave(tmp_path, state, 3)
    sleeps = []
    injector = FaultInjector(spec="checkpoint_read:drop:2")
    w = make_watcher(tmp_path, port_model(), sleeps=sleeps,
                     injector=injector)
    assert w.poll(force=True)[1] == 3
    assert injector.injected == {"checkpoint_read": 2}
    assert sleeps == [w.backoff_secs, w.backoff_secs * 2]
    assert not w.reload_failed


def test_poll_disabled_leaves_explicit_reloads_only(rig, tmp_path):
    (_t, state, _sd), _v7 = rig
    jsave(tmp_path, state, 3)
    w = make_watcher(tmp_path, port_model(), poll_secs=0)
    assert w.poll() is None
    assert w.load_version(3)[1] == w.version == 3


# -------------------------------------------------------------- swaps


def test_reload_casts_into_the_compute_dtype(rig, tmp_path):
    """A bf16 engine keeps its matmul and embedding weights in bf16: the
    reload writes each fp32 checkpoint value cast to the live tensor's
    dtype, bit for bit (LayerNorm stays fp32)."""
    (_t, _state, sd), (_t2, state2, _sd2) = rig
    jsave(tmp_path, state2, 7)
    flat, _v = load_checkpoint(str(tmp_path))
    model = port_model(sd, dtype=torch.bfloat16)
    engine = PagedContinuousBatchingEngine(model, 2, block_size=4)
    engine.set_params(flat, 7)
    dtypes = set()
    for key, p in model.named_parameters():
        path = flax_param_path(key).split("/")
        want = torch.as_tensor(np.asarray(
            flat[".params" + "".join("[%r]" % k for k in path)]))
        if path[-1] == "kernel":
            want = want.t()
        assert p.dtype == (torch.float32 if "ln" in key else torch.bfloat16)
        assert torch.equal(p, want.to(p.dtype)), key
        dtypes.add(p.dtype)
    assert dtypes == {torch.float32, torch.bfloat16}
    assert engine.model_version == 7


@pytest.mark.parametrize("paged", [False, True])
def test_swap_between_steps_keeps_in_flight_sequences(rig, tmp_path,
                                                      paged):
    """Two requests decode; the weights swap between steps; both finish
    with every token, and a request seated after the swap equals the
    offline decode with the new weights (port and JAX)."""
    (_t, state, sd), (t2, state2, sd2) = rig
    jsave(tmp_path, state2, 7)
    flat, _v = load_checkpoint(str(tmp_path))
    engine = (PagedContinuousBatchingEngine(port_model(sd), 3, block_size=4)
              if paged else ContinuousBatchingEngine(port_model(sd), 3))
    first = [ServingRequest([1, 2, 3, 4, 5], 12),
             ServingRequest(list(range(10, 19)), 10)]
    for req in first:
        engine.insert(req)
    for _ in range(3):
        engine.step()
    engine.set_params(flat, 7)
    later = ServingRequest([1, 2, 3, 4, 5], 8)
    engine.insert(later)
    while engine.active_count():
        engine.step()
    assert [len(r.generated) for r in first + [later]] == [12, 10, 8]
    assert all(r.model_version == 7 for r in first + [later])
    prompt = np.asarray([[1, 2, 3, 4, 5]], np.int32)
    ref = np.asarray(jgen.autoregressive_generate(t2, state2, prompt, 8,
                                                  use_cache=True))[0]
    assert later.generated == ref[5:].tolist()
    assert autoregressive_generate(port_model(sd2), prompt, 8)[0].tolist(
    ) == ref.tolist()


def test_server_follows_its_checkpoint_dir_mid_stream(rig, tmp_path):
    """tests/test_serving_e2e.py:171 in process: a checkpoint landing
    mid-stream swaps the weights between steps, the stream loses no
    token, a later request reports the new version and decodes as the
    offline decode with the new weights; then an explicit reload rolls
    back and a missing version fails with the old weights serving."""
    (_t, state, sd), (t2, state2, _sd2) = rig
    ckpt = tmp_path / "ckpt"
    jsave(ckpt, state, 3)
    server = GenerationServer(
        port_model(sd), ServingConfig(num_slots=2, kv_paged=True,
                                      kv_block_size=4, checkpoint_dir=str(
                                          ckpt), reload_poll_secs=0.02),
        model_version=3).start()
    try:
        stream = server.submit([1], 28)
        chunks = server.events(stream)
        got = list(next(chunks))
        jsave(ckpt, state2, 7)
        for chunk in chunks:
            got += chunk
        assert len(got) == 28  # nothing dropped
        deadline = time.monotonic() + 30
        version = 3
        while version != 7 and time.monotonic() < deadline:
            req = server.submit([1, 2, 3], 4)
            list(server.events(req))
            version = req.model_version
        assert version == 7
        req = server.submit([1, 2, 3], 4)
        list(server.events(req))
        ref = np.asarray(jgen.autoregressive_generate(
            t2, state2, np.asarray([[1, 2, 3]], np.int32), 4,
            use_cache=True))[0]
        assert req.prompt + req.generated == ref.tolist()
        status = server.status()
        assert status["model_version"] == 7 and status["reloads"] >= 1
        assert not status["reload_failed"]
    finally:
        server.stop(timeout=30)
    assert server.scheduler.crashed is None


def test_explicit_reloads_roll_forward_and_back(rig, tmp_path):
    """reload_poll_secs 0: the server never moves by itself; explicit
    reloads go to any version (the servicer's reload RPC), and a missing
    one fails with the old weights serving."""
    (_t, state, sd), (t2, state2, sd2) = rig
    jsave(tmp_path, state, 3)
    jsave(tmp_path, state2, 7)
    server = GenerationServer(
        port_model(sd), ServingConfig(num_slots=2, checkpoint_dir=str(
            tmp_path), reload_poll_secs=0), model_version=3).start()

    def offline(weights):
        return autoregressive_generate(port_model(weights), [[1, 2, 3]],
                                       4)[0].tolist()

    try:
        assert server.generate([1, 2, 3], 4) == offline(sd)
        assert server.status()["model_version"] == 3
        assert server.reload_checkpoint(7) == 7
        assert server.generate([1, 2, 3], 4) == offline(sd2)
        assert server.reload_checkpoint(3) == 3
        assert server.generate([1, 2, 3], 4) == offline(sd)
        with pytest.raises(ReloadError):
            server.reload_checkpoint(11)
        status = server.status()
        assert status["reload_failed"] and status["model_version"] == 3
        assert "version-11" in status["last_reload_error"]
        assert status["reloads"] == 2
        assert server.generate([1, 2, 3], 4) == offline(sd)
    finally:
        server.stop(timeout=30)
    assert server.scheduler.crashed is None
