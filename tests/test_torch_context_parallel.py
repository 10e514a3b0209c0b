"""Ring attention, Ulysses and the sp Trainer of the port over four gloo
processes on the CPU, against the JAX package's on a four-device mesh
(four of the eight host devices tests/conftest.py makes), same
numpy-seeded inputs.

The module fixture writes every input to one npz, starts the four rank
processes once (this file run as a script: they import torch and the
port, never JAX) and lets them run every case while the JAX side
computes its references; each rank saves its shards of the results.

Cases: ring attention forward and gradients (out, dq, dk, dv), causal
and not, windows reaching one, two and three shards back, packed
segment ids that travel with their kv shard and cross shard boundaries,
GQA; Ulysses with a window and segments; three Trainer steps of a small
transformer_lm at sp 4 (ring, windowed ring, Ulysses) over a plain, a
packed (pad tails: -100 labels split unevenly across shards, documents
crossing shard boundaries) and a plain batch, against the JAX Trainer
on the same mesh from the same converted params; LocalExecutor with the
mesh over token records against the port's single-process executor.

Tolerances, fp32: attention outputs and gradients 1e-5 (the port merges
a rotation's exact softmax, JAX's blockwise scan sums in blocks);
Trainer losses 1e-5 relative and parameters as in
tests/test_torch_training.py (999 elements in 1,000 within 2e-6, every
element within 5e-4, for Adam near eps); the parameters of the four
ranks bit-identical after every step; the executor's losses 1e-5
relative.
"""

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

SP = 4
B, H, L, D = 2, 4, 64, 8  # 16-token shards
LOCAL = L // SP

# name: (impl, causal, window, segments, kv heads)
ATTN_CASES = {
    "ring_causal": ("ring", True, None, False, H),
    "ring_full": ("ring", False, None, False, H),
    "ring_w1back": ("ring", True, 10, False, H),
    "ring_w2back": ("ring", True, 20, False, H),
    "ring_w3back": ("ring", True, 40, False, H),
    "ring_full_w2back": ("ring", False, 20, False, H),
    "ring_causal_seg": ("ring", True, None, True, H),
    "ring_full_seg": ("ring", False, None, True, H),
    "ring_w2back_seg": ("ring", True, 20, True, H),
    "ring_gqa_w1back": ("ring", True, 10, False, 2),
    "ulysses_w2back_seg": ("ulysses", True, 20, True, H),
    "ulysses_full": ("ulysses", False, None, False, H),
}

CFG = dict(vocab_size=32, seq_len=32, embed_dim=32, num_heads=4,
           num_kv_heads=2, num_layers=2)
LR, WD = 1e-2, 0.1
# name: extra model params
TRAIN_CASES = {
    "train_ring": {"sp_impl": "ring"},
    "train_ring_window": {"sp_impl": "ring", "attn_window": 12},
    "train_ulysses": {"sp_impl": "ulysses"},
}
N_STEPS = 3
EXECUTOR_RECORDS, EXECUTOR_BATCH = 12, 4
EXECUTOR_EXTRA = {"sp_impl": "ring", "attn_window": 12}
PARAM_TOL = 2e-6
PARAM_TOL_WORST = 5e-4


def _params_str(extra):
    return "; ".join("%s=%r" % kv for kv in dict(CFG, **extra).items())


def _segments(rs, b, l):
    """Contiguous runs whose cuts fall inside shards, so documents cross
    shard boundaries."""
    seg = np.zeros((b, l), np.int32)
    for r in range(b):
        cuts = sorted(rs.choice(np.arange(3, l - 1), size=4, replace=False))
        for c in cuts:
            seg[r, c:] += 1
    return seg


def _attn_inputs(name, case):
    _impl, _causal, _window, segs, hkv = case
    rs = np.random.RandomState(sum(map(ord, name)))
    arrays = {
        "q": rs.randn(B, H, L, D), "k": rs.randn(B, hkv, L, D),
        "v": rs.randn(B, hkv, L, D), "g": rs.randn(B, H, L, D)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    if segs:
        arrays["seg"] = _segments(rs, B, L)
    return arrays


def _train_batches():
    """(features, labels) x 3: plain tokens, packed rows with pad tails,
    plain tokens."""
    from elasticdl_tpu_torch.data.packing import pack_sequences

    rs = np.random.RandomState(7)
    vocab, l = CFG["vocab_size"], CFG["seq_len"]
    batches = []
    for i in range(N_STEPS):
        if i == 1:
            docs = [rs.randint(0, vocab, size=rs.randint(3, 14))
                    for _ in range(12)]
            tokens, seg, labels = pack_sequences(docs, l)
            tokens, seg, labels = tokens[:4], seg[:4], labels[:4]
            batches.append(({"tokens": tokens, "segment_ids": seg}, labels))
        else:
            t = rs.randint(0, vocab, size=(4, l + 1)).astype(np.int32)
            batches.append(({"tokens": t[:, :-1]}, t[:, 1:]))
    return batches


# ------------------------------------------------ rank processes (no JAX)


def _rank_attention(mesh, inputs, name, case):
    from elasticdl_tpu_torch.parallel import context_parallel as tcp

    impl, causal, window, segs, _hkv = case
    r = mesh.rank
    local = {k: torch.from_numpy(np.ascontiguousarray(
        x[:, r * LOCAL:(r + 1) * LOCAL] if k == "seg"
        else x[:, :, r * LOCAL:(r + 1) * LOCAL]))
        for k, x in inputs.items()}
    leaves = [local[k].requires_grad_() for k in ("q", "k", "v")]
    fn = (tcp.ulysses_attention_local if impl == "ulysses"
          else tcp.ring_attention_local)
    out = fn(*leaves, mesh, causal=causal, window=window,
             segments=local.get("seg"))
    out.backward(local["g"])
    return {"out": out.detach().numpy(),
            **{"d" + k: x.grad.numpy() for k, x in zip("qkv", leaves)}}


def _rank_train(mesh, params, batches, extra):
    from elasticdl_tpu_torch.common.model_utils import (
        load_model_spec_from_module,
    )
    from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
    from elasticdl_tpu_torch.training.optimizers import adamw
    from elasticdl_tpu_torch.training.trainer import Trainer

    spec = load_model_spec_from_module(tzoo)
    spec.optimizer = lambda: adamw(LR, weight_decay=WD)
    trainer = Trainer(spec, mesh=mesh, model_params=_params_str(extra),
                      device="cpu")
    state = trainer.init_state(None, params={
        k: torch.from_numpy(v) for k, v in params.items()})
    result = {}
    for i, batch in enumerate(batches):
        state, loss = trainer.train_step(state, batch)
        result["loss_%d" % i] = np.float64(loss)
        for key, p in state.params.items():
            result["step%d/%s" % (i, key)] = p.detach().numpy().copy()
    return result


def _executor_losses(data_dir, mesh=None):
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.common.model_utils import (
        load_model_spec_from_module,
    )
    from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo

    executor = LocalExecutor(
        load_model_spec_from_module(tzoo), training_data=data_dir,
        minibatch_size=EXECUTOR_BATCH, max_steps=N_STEPS,
        model_params=_params_str(EXECUTOR_EXTRA), device="cpu", mesh=mesh)
    executor.train()
    return np.asarray(executor.losses, np.float64)


def _rank_main(rank, port, outdir):
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel.mesh import build_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=SP, rank=rank,
                            timeout=timedelta(seconds=240))
    try:
        mesh = build_mesh({"sp": SP})
        data = np.load(os.path.join(outdir, "inputs.npz"))
        for name, case in ATTN_CASES.items():
            inputs = {k.split("/", 1)[1]: data[k] for k in data.files
                      if k.startswith(name + "/")}
            np.savez(os.path.join(outdir, "%s.rank%d.npz" % (name, rank)),
                     **_rank_attention(mesh, inputs, name, case))
        params = {k.split("/", 1)[1]: data[k] for k in data.files
                  if k.startswith("params/")}
        batches = [({k.split("/")[2]: data[k] for k in data.files
                     if k.startswith("batch%d/f/" % i)},
                    data["batch%d/labels" % i]) for i in range(N_STEPS)]
        for name, extra in TRAIN_CASES.items():
            np.savez(os.path.join(outdir, "%s.rank%d.npz" % (name, rank)),
                     **_rank_train(mesh, params, batches, extra))
        np.savez(os.path.join(outdir, "executor.rank%d.npz" % rank),
                 losses=_executor_losses(os.path.join(outdir, "records"),
                                         mesh))
        assert "jax" not in sys.modules
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- test side


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks(object):
    """The four rank processes; `result(name)` waits for them once and
    returns {rank: npz dict} of one case."""

    def __init__(self, outdir):
        self.outdir = outdir
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(port),
             outdir], env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(SP)]
        self.done = False

    def wait(self):
        if self.done:
            return
        deadline = time.monotonic() + 600
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
        assert codes == [0] * SP, (codes, "\n".join(logs)[-6000:])

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)

    def result(self, name):
        self.wait()
        return {r: dict(np.load(os.path.join(
            self.outdir, "%s.rank%d.npz" % (name, r)))) for r in range(SP)}


def _numpy_flax_params(cfg, seed=0):
    import jax
    import jax.numpy as jnp

    from model_zoo.transformer_lm import transformer_lm as zoo

    shapes = jax.eval_shape(
        lambda: zoo.TransformerLM(**cfg).init(
            jax.random.PRNGKey(0),
            {"tokens": jnp.zeros((1, cfg["seq_len"]), jnp.int32)})
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from elasticdl_tpu_torch.convert import params_from_flax

    outdir = str(tmp_path_factory.mktemp("context_parallel"))
    arrays = {}
    for name, case in ATTN_CASES.items():
        for key, x in _attn_inputs(name, case).items():
            arrays["%s/%s" % (name, key)] = x
    flax_params = _numpy_flax_params(CFG)
    for key, p in params_from_flax(flax_params).items():
        arrays["params/" + key] = p.numpy()
    for i, (features, labels) in enumerate(_train_batches()):
        for key, x in features.items():
            arrays["batch%d/f/%s" % (i, key)] = x
        arrays["batch%d/labels" % i] = labels
    np.savez(os.path.join(outdir, "inputs.npz"), **arrays)
    _write_records(os.path.join(outdir, "records"))
    r = _Ranks(outdir)
    r.flax_params = flax_params
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


def _jax_mesh():
    import jax

    from elasticdl_tpu.parallel import mesh as mesh_lib

    return mesh_lib.build_mesh({"sp": SP}, devices=jax.devices()[:SP])


def _gather(result, key, axis):
    return np.concatenate([result[r][key] for r in range(SP)], axis=axis)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_sp_attention_matches_jax(ranks, name):
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.context_parallel import (
        ring_attention,
        ulysses_attention,
    )

    impl, causal, window, segs, hkv = ATTN_CASES[name]
    x = {k: jnp.asarray(v) for k, v in _attn_inputs(name,
                                                    ATTN_CASES[name]).items()}
    mesh = _jax_mesh()
    fn = ulysses_attention if impl == "ulysses" else ring_attention
    k, v = x["k"], x["v"]
    if hkv != H and impl == "ulysses":
        raise AssertionError("Ulysses cases take full kv heads")

    def attn(q, k, v):
        return fn(q, k, v, mesh, causal=causal, window=window,
                  segments=x.get("seg"))

    with mesh:
        out, vjp = jax.vjp(jax.jit(attn), x["q"], k, v)
        ref = dict(zip(("dq", "dk", "dv"), vjp(x["g"])), out=out)
    got = ranks.result(name)
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(_gather(got, key, 2),
                                   np.asarray(ref[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_sp_trainer_steps_match_jax(ranks, name):
    import jax
    import jax.numpy as jnp
    import optax

    from elasticdl_tpu.common.model_utils import (
        load_model_spec_from_module as jax_spec_of,
    )
    from elasticdl_tpu.training.trainer import Trainer as JTrainer
    from elasticdl_tpu_torch.convert import flatten_params, params_to_flax
    from model_zoo.transformer_lm import transformer_lm as zoo

    spec = jax_spec_of(zoo)
    spec.optimizer = lambda: optax.adamw(LR, weight_decay=WD)
    batches = _train_batches()
    trainer = JTrainer(spec, mesh=_jax_mesh(),
                       model_params=_params_str(TRAIN_CASES[name]))
    state = trainer.init_state(batches[0])
    jp = jax.tree.map(jnp.asarray, ranks.flax_params)
    state = state.replace(params=jp, opt_state=trainer._train_tx.init(jp))
    refs = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        refs.append((float(loss), flatten_params(
            jax.tree.map(np.asarray, state.params))))
    got = ranks.result(name)
    for i, (loss, params) in enumerate(refs):
        np.testing.assert_allclose(float(got[0]["loss_%d" % i]), loss,
                                   rtol=1e-5, err_msg="step %d" % i)
        per_rank = []
        for r in range(SP):
            sd = {k.split("/", 1)[1]: torch.from_numpy(v)
                  for k, v in got[r].items()
                  if k.startswith("step%d/" % i)}
            per_rank.append(flatten_params(params_to_flax(sd)))
            assert float(got[r]["loss_%d" % i]) == float(
                got[0]["loss_%d" % i])
        assert sorted(per_rank[0]) == sorted(params)
        diffs = []
        for key, ref in params.items():
            for r in range(1, SP):  # replicated: bit-identical ranks
                np.testing.assert_array_equal(per_rank[r][key],
                                              per_rank[0][key], err_msg=key)
            np.testing.assert_allclose(per_rank[0][key], ref,
                                       atol=PARAM_TOL_WORST, rtol=0,
                                       err_msg="step %d %s" % (i, key))
            diffs.append(np.abs(per_rank[0][key] - ref).ravel())
        diffs = np.concatenate(diffs)
        assert (diffs > PARAM_TOL).mean() <= 1e-3, np.sort(diffs)[-10:]


def test_sp_local_executor_matches_one_process(ranks):
    """LocalExecutor hands its mesh to the Trainer: four ranks over the
    same records take the steps one process takes without a mesh."""
    ref = _executor_losses(os.path.join(ranks.outdir, "records"))
    got = ranks.result("executor")
    assert len(ref) == N_STEPS
    for r in range(SP):
        np.testing.assert_array_equal(got[r]["losses"], got[0]["losses"])
    np.testing.assert_allclose(got[0]["losses"], ref, rtol=1e-5, atol=0)


def test_sp_mesh_and_model_arguments_are_checked():
    from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
    from elasticdl_tpu_torch.parallel.mesh import build_mesh, current_mesh

    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        build_mesh({"sp": 1, "fsdp": 2})
    # dp is a mesh axis of the port now: without a process group it asks
    # for one (tests/test_torch_dp_sp.py runs it)
    with pytest.raises(RuntimeError, match="init_process_group"):
        build_mesh({"dp": 2})
    with pytest.raises(ValueError, match="Unknown mesh axis"):
        build_mesh({"sq": 2})
    mesh = build_mesh({"sp": 1})
    assert current_mesh() is None
    with mesh:
        assert current_mesh() is mesh
    assert current_mesh() is None
    with pytest.raises(ValueError, match="sp_impl"):
        tzoo.custom_model(device="cpu", sp_impl="rings", **CFG)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
