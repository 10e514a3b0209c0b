"""The port's dp x sp mesh over gloo processes on the CPU, against the
JAX package on the same mesh (four of the eight host devices
tests/conftest.py makes), same numpy-seeded inputs and converted
weights.

The module fixture writes every input to one npz and starts four rank
processes once (this file run as a script: they import torch and the
port, never JAX). They build `{"dp": 2, "sp": 2}`, run every case on
it, then `{"sp": 4}` for the fused head; ranks 0 and 1 then join a
second group of two for `{"dp": 2}` alone. Each rank saves its results.

Cases: `parse_mesh_spec` against JAX's; three Trainer steps of a small
transformer_lm on dp 2 x sp 2 (ring, windowed ring, Ulysses) over a
plain batch, a packed batch whose documents cross shard boundaries and
a partial batch whose weight-0 rows all fall on dp rank 1, against the
JAX Trainer on the same mesh; the same on `{"dp": 2}`; `fused_head`
under sp 4 against the JAX fused step; bert on dp 2 x sp 2 (plain,
packed, partial) against the JAX Trainer on the same mesh; each zoo
partial loss against `loss` on one device; `forward` and
`evaluate_batch` under the mesh against one device's; LocalExecutor on
dp 2 x sp 2 with a checkpoint every step (its losses against the
one-process executor's, rank 0 alone writing, a crash, restore and
resume bit-identical to the uninterrupted run, the JAX executor
resuming the port's mesh checkpoint); the refusals.

Tolerances, fp32: losses 1e-5 relative; parameters as in
tests/test_torch_training.py (999 elements in 1,000 within 2e-6, every
element within 5e-4, for Adam near eps); the parameters of every rank
bit-identical after every step; outputs under the mesh 1e-5; the
partial losses' quotient equal to `loss` bit for bit.
"""

import os
import random
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

WORLD = 4
CFG = dict(vocab_size=32, seq_len=32, embed_dim=32, num_heads=4,
           num_kv_heads=2, num_layers=2)
BERT = dict(vocab_size=32, seq_len=32, embed_dim=32, num_heads=2,
            num_layers=2)
LR, WD = 1e-2, 0.1
B = 4  # global batch: two rows a dp rank
PARTIAL = 2  # the partial batch's true count: rows 2 and 3 weigh 0
# name: (mesh, family, extra model params)
TRAIN_CASES = {
    "ring": ({"dp": 2, "sp": 2}, "lm", {"sp_impl": "ring"}),
    "ring_window": ({"dp": 2, "sp": 2}, "lm",
                    {"sp_impl": "ring", "attn_window": 12}),
    "ulysses": ({"dp": 2, "sp": 2}, "lm", {"sp_impl": "ulysses"}),
    "fused_ring": ({"sp": 4}, "lm", {"sp_impl": "ring",
                                     "fused_head": True}),
    "bert": ({"dp": 2, "sp": 2}, "bert", {}),
    "dp_only": ({"dp": 2}, "lm", {}),
}
N_STEPS = 3
EXECUTOR_RECORDS, EXECUTOR_TASK = 12, 4  # 3 tasks of one batch each
EXECUTOR_EXTRA = {"sp_impl": "ring"}
EXECUTOR_FAULT = "local_get_task:drop:1:skip=1"  # dies fetching task 2
PARAM_TOL = 2e-6
PARAM_TOL_WORST = 5e-4
RANK_DEADLINE_S = 600


def _params_str(cfg, extra):
    return "; ".join("%s=%r" % kv for kv in dict(cfg, **extra).items())


def _segments(rs, b, l):
    """Contiguous runs whose cuts fall inside shards, so documents cross
    shard boundaries."""
    seg = np.zeros((b, l), np.int32)
    for r in range(b):
        cuts = sorted(rs.choice(np.arange(3, l - 1), size=4, replace=False))
        for c in cuts:
            seg[r, c:] += 1
    return seg


def _lm_batches():
    """(features, labels, true count) x 3: plain tokens, packed rows
    with pad tails (-100 labels split unevenly across shards), a
    partial batch."""
    from elasticdl_tpu_torch.data.packing import pack_sequences

    rs = np.random.RandomState(7)
    vocab, l = CFG["vocab_size"], CFG["seq_len"]
    out = []
    for i in range(N_STEPS):
        if i == 1:
            docs = [rs.randint(0, vocab, size=rs.randint(3, 14))
                    for _ in range(24)]
            tokens, seg, labels = pack_sequences(docs, l)
            assert len(tokens) >= B
            out.append(({"tokens": tokens[:B], "segment_ids": seg[:B]},
                        labels[:B], None))
        else:
            t = rs.randint(0, vocab, size=(B, l + 1)).astype(np.int32)
            out.append(({"tokens": t[:, :-1]}, t[:, 1:],
                        PARTIAL if i == 2 else None))
    return out


def _bert_batches():
    """Masked rows (30% targets) x 3: plain, packed (segment ids whose
    runs cross shard boundaries), partial."""
    from elasticdl_tpu_torch.model_zoo.bert import bert as pbert

    rs = np.random.RandomState(9)
    vocab, l = BERT["vocab_size"], BERT["seq_len"]
    out = []
    for i in range(N_STEPS):
        tokens = rs.randint(0, vocab + 1, size=(B, l)).astype(np.int32)
        labels = np.where(rs.rand(B, l) < 0.3, tokens % vocab,
                          pbert.IGNORE_LABEL).astype(np.int32)
        features = {"tokens": tokens}
        if i == 1:
            features["segment_ids"] = _segments(rs, B, l)
        out.append((features, labels, PARTIAL if i == 2 else None))
    return out


BATCHES = {"lm": _lm_batches, "bert": _bert_batches}


def _spec(family):
    from elasticdl_tpu_torch.common.model_utils import (
        load_model_spec_from_module,
    )
    from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
    from elasticdl_tpu_torch.model_zoo.bert import bert as pbert
    from elasticdl_tpu_torch.training.optimizers import adamw

    spec = load_model_spec_from_module(tzoo if family == "lm" else pbert)
    spec.optimizer = lambda: adamw(LR, weight_decay=WD)
    return spec


def _cfg(family):
    return CFG if family == "lm" else BERT


def _port_trainer(family, extra, params, mesh=None):
    from elasticdl_tpu_torch.training.trainer import Trainer

    trainer = Trainer(_spec(family), mesh=mesh,
                      model_params=_params_str(_cfg(family), extra),
                      device="cpu")
    state = trainer.init_state(None, params={
        k: torch.from_numpy(v) for k, v in params.items()})
    return trainer, state


# ------------------------------------------------ rank processes (no JAX)


def _load_inputs(outdir):
    data = np.load(os.path.join(outdir, "inputs.npz"))
    params = {fam: {k.split("/", 1)[1]: data[k] for k in data.files
                    if k.startswith(fam + "_params/")}
              for fam in BATCHES}
    return params


def _rank_train(mesh, params, name):
    _mesh, family, extra = TRAIN_CASES[name]
    trainer, state = _port_trainer(family, extra, params[family], mesh)
    result = {}
    for i, (features, labels, n) in enumerate(BATCHES[family]()):
        state, loss = trainer.train_step(state, (features, labels), n)
        result["loss_%d" % i] = np.float64(loss)
        for key, p in state.params.items():
            result["step%d/%s" % (i, key)] = p.detach().numpy().copy()
    return result


def _rank_forward(mesh, params):
    """forward and evaluate_batch of the ring LM under the mesh over
    the packed batch and the partial one."""
    trainer, state = _port_trainer("lm", EXECUTOR_EXTRA, params["lm"], mesh)
    batches = _lm_batches()
    out = {"forward": trainer.forward(state, batches[1][0]).numpy()}
    preds, labels = trainer.evaluate_batch(state, batches[2][:2], PARTIAL)
    out["eval_preds"], out["eval_labels"] = preds, labels
    return out


def _executor(data_dir, mesh=None, **kwargs):
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.common.model_utils import (
        load_model_spec_from_module,
    )
    from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo

    random.seed(0)  # the task shuffle: the same order on every rank
    return LocalExecutor(
        load_model_spec_from_module(tzoo), training_data=data_dir,
        minibatch_size=B, records_per_task=EXECUTOR_TASK,
        model_params=_params_str(CFG, EXECUTOR_EXTRA), device="cpu",
        mesh=mesh, **kwargs)


def _final_params(executor):
    return {"param/" + k: p.detach().numpy().copy()
            for k, p in executor.state.params.items()}


def _rank_executors(mesh, outdir):
    """Uninterrupted: 3 steps with a checkpoint each step and a job
    state dir. Crashed: dies fetching its second task (1 step, version
    1 on disk), then resumes from the checkpoint and the job state for
    the last 2 steps."""
    from elasticdl_tpu_torch.common.fault_injection import (
        FaultInjector,
        InjectedRpcError,
    )

    data = os.path.join(outdir, "records")
    full = _executor(data, mesh, checkpoint_dir=os.path.join(outdir, "ck"),
                     checkpoint_steps=1,
                     job_state_dir=os.path.join(outdir, "js"))
    full.train()
    out = {"losses": np.asarray(full.losses, np.float64),
           "wrote": np.asarray(bool(full.checkpoint_saver.last_timing)),
           **_final_params(full)}
    common = dict(checkpoint_dir=os.path.join(outdir, "ck_crash"),
                  checkpoint_steps=1,
                  job_state_dir=os.path.join(outdir, "js_crash"))
    crashed = _executor(data, mesh, fault_injector=FaultInjector(
        spec=EXECUTOR_FAULT), **common)
    try:
        crashed.train()
        raise AssertionError("the fault did not fire")
    except InjectedRpcError as err:
        assert "injected fault: drop local_get_task" in str(err), err
    resumed = _executor(data, mesh, checkpoint_dir_for_init=common[
        "checkpoint_dir"], **common)
    resumed.train()
    out["crashed_losses"] = np.asarray(crashed.losses, np.float64)
    out["resumed_losses"] = np.asarray(resumed.losses, np.float64)
    out["restored_version"] = np.asarray(resumed.restored_version)
    out.update({"resumed_" + k: v
                for k, v in _final_params(resumed).items()})
    return out


def _message_of(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the message is the result
        return "%s: %s" % (type(err).__name__, err)
    return "no error"


def _rank_refusals(mesh, params):
    from elasticdl_tpu_torch.parallel.mesh import build_mesh

    trainer, state = _port_trainer("lm", EXECUTOR_EXTRA, params["lm"], mesh)
    features, labels, _n = _lm_batches()[0]
    odd = ({k: v[:3] for k, v in features.items()}, labels[:3])
    return {"b_not_multiple_of_dp": np.asarray(_message_of(
                lambda: trainer.train_step(state, odd))),
            "world_not_dp_sp": np.asarray(_message_of(
                lambda: build_mesh({"dp": 2, "sp": 4})))}


def _save(outdir, name, rank, result):
    np.savez(os.path.join(outdir, "%s.rank%d.npz" % (name, rank)), **result)


def _rank_main(rank, port, outdir):
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel.mesh import build_mesh

    torch.set_num_threads(1)
    params = _load_inputs(outdir)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=WORLD, rank=rank,
                            timeout=timedelta(seconds=240))
    try:
        meshes = {}
        for name, (spec, _family, _extra) in TRAIN_CASES.items():
            if name == "dp_only":
                continue
            key = tuple(sorted(spec.items()))
            if key not in meshes:
                meshes[key] = build_mesh(spec)
            _save(outdir, name, rank,
                  _rank_train(meshes[key], params, name))
        mesh = meshes[(("dp", 2), ("sp", 2))]
        _save(outdir, "forward", rank, _rank_forward(mesh, params))
        _save(outdir, "executor", rank, _rank_executors(mesh, outdir))
        _save(outdir, "refusals", rank, _rank_refusals(mesh, params))
        # the second group's port, picked by rank 0 just before it binds
        port2 = [_free_port() if rank == 0 else None]
        dist.broadcast_object_list(port2, src=0)
    finally:
        dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group(
            "gloo", init_method="tcp://127.0.0.1:%d" % port2[0], world_size=2,
            rank=rank, timeout=timedelta(seconds=240))
        try:
            _save(outdir, "dp_only", rank,
                  _rank_train(build_mesh({"dp": 2}), params, "dp_only"))
        finally:
            dist.destroy_process_group()
    assert "jax" not in sys.modules


# ----------------------------------------------------------- test side


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks(object):
    """The rank processes; `result(name)` waits for them once and
    returns {rank: npz dict} of one case."""

    def __init__(self, outdir):
        self.outdir = outdir
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
        port = str(_free_port())
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), port,
             outdir], env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        self.done = False

    def wait(self):
        if self.done:
            return
        deadline = time.monotonic() + RANK_DEADLINE_S
        logs = []
        for proc in self.procs:
            try:
                out, _ = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.close()
                raise
            logs.append(out)
        self.done = True
        codes = [p.returncode for p in self.procs]
        if codes != [0] * WORLD:
            self.close()
        assert codes == [0] * WORLD, (codes, "\n".join(logs)[-6000:])

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)

    def result(self, name, ranks=WORLD):
        self.wait()
        return {r: dict(np.load(os.path.join(
            self.outdir, "%s.rank%d.npz" % (name, r)))) for r in range(ranks)}


def _numpy_lm_params(seed=0):
    """Flax params of the LM drawn by numpy over jax.eval_shape."""
    import jax
    import jax.numpy as jnp

    from model_zoo.transformer_lm import transformer_lm as zoo

    shapes = jax.eval_shape(
        lambda: zoo.TransformerLM(**CFG).init(
            jax.random.PRNGKey(0),
            {"tokens": jnp.zeros((1, CFG["seq_len"]), jnp.int32)})
    )["params"]
    rs = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.value.shape if hasattr(leaf, "value") else leaf.shape
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
        base = 1.0 if len(shape) == 1 else 0.0
        return (base + scale * rs.randn(*shape)).astype(np.float32)

    return jax.tree.map(
        draw, shapes,
        is_leaf=lambda x: hasattr(x, "value") or hasattr(x, "shape"))


def _jax_spec(family):
    import optax

    from elasticdl_tpu.common.model_utils import (
        load_model_spec_from_module as jax_spec_of,
    )
    from model_zoo.bert import bert as jbert
    from model_zoo.transformer_lm import transformer_lm as zoo

    spec = jax_spec_of(zoo if family == "lm" else jbert)
    spec.optimizer = lambda: optax.adamw(LR, weight_decay=WD)
    return spec


def _jax_mesh(spec):
    import jax

    from elasticdl_tpu.parallel import mesh as mesh_lib

    n = int(np.prod(list(spec.values())))
    return mesh_lib.build_mesh(spec, devices=jax.devices()[:n])


def _bert_flax_params():
    """The JAX bert Trainer's own initial params (its init on one
    device), as numpy."""
    import jax

    from elasticdl_tpu.training.trainer import Trainer as JTrainer

    trainer = JTrainer(_jax_spec("bert"), mesh=_jax_mesh({"dp": 1}),
                       model_params=_params_str(BERT, {}))
    features, labels, _n = _bert_batches()[0]
    state = trainer.init_state((features, labels))
    return jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from elasticdl_tpu_torch.convert import (
        params_from_flax,
        zoo_params_from_flax,
    )

    outdir = str(tmp_path_factory.mktemp("dp_sp"))
    flax = {"lm": _numpy_lm_params(), "bert": _bert_flax_params()}
    port = {"lm": params_from_flax(flax["lm"]),
            "bert": zoo_params_from_flax(flax["bert"])}
    arrays = {"%s_params/%s" % (fam, k): p.numpy()
              for fam, sd in port.items() for k, p in sd.items()}
    np.savez(os.path.join(outdir, "inputs.npz"), **arrays)
    _write_records(os.path.join(outdir, "records"))
    r = _Ranks(outdir)
    r.flax_params = flax
    r.port_params = {fam: {k: p.numpy() for k, p in sd.items()}
                     for fam, sd in port.items()}
    yield r
    r.close()


def _write_records(data_dir):
    from elasticdl_tpu_torch.data.example_codec import encode_example
    from elasticdl_tpu_torch.data.record_format import RecordWriter

    os.makedirs(data_dir)
    rs = np.random.RandomState(8)
    with RecordWriter(os.path.join(data_dir, "tokens-00000.trec")) as w:
        for _ in range(EXECUTOR_RECORDS):
            w.write(encode_example({"tokens": rs.randint(
                0, CFG["vocab_size"], size=(CFG["seq_len"] + 1,))}))


def _flat_flax(family, sd):
    from elasticdl_tpu_torch.convert import (
        flatten_params,
        params_to_flax,
        zoo_params_to_flax,
    )

    to_flax = params_to_flax if family == "lm" else zoo_params_to_flax
    return flatten_params(to_flax({k: torch.from_numpy(v)
                                   for k, v in sd.items()}))


def _assert_params_close(ours, ref, what):
    assert sorted(ours) == sorted(ref)
    diffs = []
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], atol=PARAM_TOL_WORST,
                                   rtol=0, err_msg="%s %s" % (what, key))
        diffs.append(np.abs(ours[key] - ref[key]).ravel())
    diffs = np.concatenate(diffs)
    assert (diffs > PARAM_TOL).mean() <= 1e-3, np.sort(diffs)[-10:]


def _step_params(result, i):
    return {k.split("/", 1)[1]: v for k, v in result.items()
            if k.startswith("step%d/" % i)}


# ------------------------------------------------------------------ tests


PARSE_CASES = ["", "dp=4", "dp=2,sp=2", "sp=2, dp=-1", " dp = 2 , sp=-1 ",
               "tp=2,pp=2", "dp=2,,sp=2", "sq=2", "dp=-1,sp=-1", "dp=0",
               "dp=2,sp=-2"]


@pytest.mark.parametrize("spec", PARSE_CASES)
def test_parse_mesh_spec_matches_jax(spec):
    from elasticdl_tpu.parallel.mesh import parse_mesh_spec as jparse
    from elasticdl_tpu_torch.parallel.mesh import parse_mesh_spec

    assert _message_of(lambda: parse_mesh_spec(spec)) == _message_of(
        lambda: jparse(spec))
    if _message_of(lambda: jparse(spec)) == "no error":
        assert parse_mesh_spec(spec) == jparse(spec)


@pytest.mark.parametrize("axis", ["fsdp", "ep", "tp", "pp"])
def test_build_mesh_refuses_the_axes_not_ported(axis):
    from elasticdl_tpu_torch.parallel.mesh import build_mesh

    for spec in ({axis: 2}, {"dp": 2, axis: 2}, "%s=2,sp=2" % axis):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            build_mesh(spec)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_mesh_trainer_steps_match_jax(ranks, name):
    """Three steps (plain, packed, partial batch) on the port's mesh
    against the JAX Trainer on the same mesh: losses, parameters, and
    the ranks bit-identical."""
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.training.trainer import Trainer as JTrainer
    from elasticdl_tpu_torch.convert import flatten_params

    spec, family, extra = TRAIN_CASES[name]
    trainer = JTrainer(_jax_spec(family), mesh=_jax_mesh(spec),
                       model_params=_params_str(_cfg(family), extra))
    batches = BATCHES[family]()
    state = trainer.init_state(batches[0][:2])
    jp = jax.tree.map(jnp.asarray, ranks.flax_params[family])
    state = state.replace(params=jp, opt_state=trainer._train_tx.init(jp))
    refs = []
    for features, labels, n in batches:
        state, loss = trainer.train_step(state, (features, labels), n)
        refs.append((float(loss), flatten_params(
            jax.tree.map(np.asarray, state.params))))
    n_ranks = int(np.prod(list(spec.values())))
    got = ranks.result(name, n_ranks)
    for i, (loss, params) in enumerate(refs):
        for r in range(n_ranks):
            assert float(got[r]["loss_%d" % i]) == float(
                got[0]["loss_%d" % i])
        np.testing.assert_allclose(float(got[0]["loss_%d" % i]), loss,
                                   rtol=1e-5, err_msg="step %d" % i)
        per_rank = [_flat_flax(family, _step_params(got[r], i))
                    for r in range(n_ranks)]
        for key in params:
            for r in range(1, n_ranks):  # replicated: bit-identical ranks
                np.testing.assert_array_equal(per_rank[r][key],
                                              per_rank[0][key], err_msg=key)
        _assert_params_close(per_rank[0], params, "step %d" % i)


LOSS_CASES = {
    "lm": ("lm", {}, 0), "lm_weights": ("lm", {}, 2),
    "lm_packed": ("lm", {}, 1), "lm_fused": ("lm", {"fused_head": True}, 0),
    "bert": ("bert", {}, 0), "bert_weights": ("bert", {}, 2),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_partial_loss_gives_the_loss_on_one_device(ranks, name):
    """num / den of `loss_parts` with no mesh is `loss` bit for bit,
    and the JAX zoo loss within 1e-5."""
    family, extra, which = LOSS_CASES[name]
    from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
    from elasticdl_tpu_torch.model_zoo.bert import bert as pbert

    zoo = tzoo if family == "lm" else pbert
    trainer, _state = _port_trainer(family, extra, ranks.port_params[family])
    features, labels, n = BATCHES[family]()[which]
    weights = None if n is None else (np.arange(B) < n).astype(np.float32)
    with torch.no_grad():
        preds = trainer.model(trainer._features(features), training=True)
        num, den = zoo.loss_parts(labels, preds, weights)
        loss = zoo.loss(labels, preds, weights)
    assert (num / den).item() == loss.item()
    if extra:  # the fused dict against the logits' loss
        logits = trainer.model(trainer._features(features))
        ref = zoo.loss(labels, logits.detach(), weights).item()
    else:
        ref = _jax_loss(family, labels, preds.numpy(), weights)
    np.testing.assert_allclose(loss.item(), ref, rtol=1e-5)


def _jax_loss(family, labels, logits, weights):
    import jax.numpy as jnp

    from model_zoo.bert import bert as jbert
    from model_zoo.transformer_lm import transformer_lm as zoo

    fn = (zoo if family == "lm" else jbert).loss
    return float(fn(jnp.asarray(labels), jnp.asarray(logits),
                    None if weights is None else jnp.asarray(weights)))


def test_forward_and_evaluate_under_the_mesh_match_one_device(ranks):
    trainer, state = _port_trainer("lm", EXECUTOR_EXTRA,
                                   ranks.port_params["lm"])
    batches = _lm_batches()
    ref = trainer.forward(state, batches[1][0]).numpy()
    preds, labels = trainer.evaluate_batch(state, batches[2][:2], PARTIAL)
    got = ranks.result("forward")
    for r in range(WORLD):
        assert got[r]["forward"].shape == (B, CFG["seq_len"],
                                           CFG["vocab_size"])
        np.testing.assert_allclose(got[r]["forward"], ref, rtol=1e-5,
                                   atol=1e-5)
        assert got[r]["eval_preds"].shape[0] == PARTIAL
        np.testing.assert_allclose(got[r]["eval_preds"], preds, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got[r]["eval_labels"], labels)


def test_mesh_executor_saves_from_rank_0_and_matches_one_process(ranks):
    ref = _executor(os.path.join(ranks.outdir, "records"))
    ref.train()
    got = ranks.result("executor")
    assert len(ref.losses) == N_STEPS
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["losses"], got[0]["losses"])
        assert bool(got[r]["wrote"]) == (r == 0)
    np.testing.assert_allclose(got[0]["losses"], ref.losses, rtol=1e-5,
                               atol=0)
    assert sorted(os.listdir(os.path.join(ranks.outdir, "ck"))) == [
        "version-%d" % v for v in range(1, N_STEPS + 1)]
    # each version holds the whole replicated state, as on one device
    from elasticdl_tpu_torch.checkpoint.saver import load_checkpoint

    flat, version = load_checkpoint(os.path.join(ranks.outdir, "ck"))
    assert version == N_STEPS and int(flat[".step"]) == N_STEPS


def test_mesh_executor_resume_is_bit_identical(ranks):
    """A run that dies after one step resumes from version 1 and the job
    state on every rank: the losses and final parameters equal the
    uninterrupted run's bit for bit."""
    got = ranks.result("executor")
    for r in range(WORLD):
        res = got[r]
        assert int(res["restored_version"]) == 1
        assert len(res["crashed_losses"]) == 1
        np.testing.assert_array_equal(
            np.concatenate([res["crashed_losses"], res["resumed_losses"]]),
            res["losses"])
        for key in (k for k in res if k.startswith("param/")):
            np.testing.assert_array_equal(res["resumed_" + key], res[key],
                                          err_msg="rank %d %s" % (r, key))
    assert sorted(os.listdir(os.path.join(ranks.outdir, "ck_crash"))) == [
        "version-%d" % v for v in range(1, N_STEPS + 1)]


def test_jax_executor_resumes_the_mesh_checkpoint(ranks):
    import jax

    from elasticdl_tpu.api.local_executor import LocalExecutor as JExecutor
    from elasticdl_tpu.common.model_utils import (
        load_model_spec_from_module as jax_spec_of,
    )
    from elasticdl_tpu.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.convert import flatten_params, params_to_flax
    from model_zoo.transformer_lm import transformer_lm as zoo

    ranks.wait()
    ckpt = os.path.join(ranks.outdir, "ck")
    data = os.path.join(ranks.outdir, "records")
    common = dict(max_steps=N_STEPS + 1, checkpoint_dir_for_init=ckpt)
    port = _executor(data, **common)
    port.train()
    random.seed(0)
    jex = JExecutor(jax_spec_of(zoo), mesh=mesh_lib.build_mesh(
        {"dp": 1}, devices=jax.devices()[:1]), training_data=data,
        minibatch_size=B, records_per_task=EXECUTOR_TASK,
        model_params=_params_str(CFG, EXECUTOR_EXTRA), **common)
    jex.train()
    assert port.restored_version == N_STEPS
    assert len(port.losses) == len(jex.losses) == 1
    np.testing.assert_allclose(port.losses, jex.losses, rtol=1e-5)
    _assert_params_close(
        flatten_params(params_to_flax(port.trainer.model.state_dict())),
        flatten_params(jax.tree.map(np.asarray, jex.state.params)),
        "step %d" % (N_STEPS + 1))


@pytest.mark.parametrize("what,pattern", [
    ("b_not_multiple_of_dp", "ValueError: batch size 3 is not a multiple "
     "of dp = 2"),
    ("world_not_dp_sp", "ValueError: mesh dp = 2 x sp = 4 needs a group of "
     "8 processes, got 4")])
def test_mesh_refusals_in_the_ranks(ranks, what, pattern):
    got = ranks.result("refusals")
    for r in range(WORLD):
        assert str(got[r][what]) == pattern


@pytest.mark.parametrize("family,shape", [
    ("bert", {"tp": 2}), ("vit", {"tp": 2}), ("vit", {"sp": 2}),
    ("vit", {"dp": 2})])
def test_encoders_refuse_the_meshes_not_ported(family, shape):
    from elasticdl_tpu_torch.common.constants import MeshAxis
    from elasticdl_tpu_torch.model_zoo.bert import bert as pbert
    from elasticdl_tpu_torch.model_zoo.vit import vit as pvit
    from elasticdl_tpu_torch.parallel.mesh import _CURRENT

    fake = type("FakeMesh", (), {})()
    fake.shape = dict(dict.fromkeys(MeshAxis.ALL, 1), **shape)
    fake.size = shape.get("sp", 1)
    if family == "bert":
        model = pbert.custom_model(device="cpu", **BERT)
        features = {"tokens": np.zeros((1, 8), np.int32)}
    else:
        model = pvit.custom_model(device="cpu", image_size=8, patch_size=4,
                                  embed_dim=16, num_heads=2, num_layers=1)
        features = {"image": np.zeros((1, 8, 8, 3), np.float32)}
    token = _CURRENT.set(fake)
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            model(features)
    finally:
        _CURRENT.reset(token)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
