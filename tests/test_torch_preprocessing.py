"""The port's preprocessing layers, feature columns and analysis
accessors against the JAX package's, on the CPU, same numpy inputs.

Ids and hashes are held exactly (md5 of `str(value)` in both packages,
not the reference's FarmHash). A torch tensor given to a port layer is
held against the JAX layer given the same values: as numpy for the
string and hashing layers, as a jnp array for the numeric layers (the
JAX layers' traceable path). Lookups with carried weights: 1e-6.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elasticdl_tpu.preprocessing as jpre
from elasticdl_tpu.preprocessing import analyzer_utils as jan
from elasticdl_tpu.preprocessing import feature_column as jfc
from elasticdl_tpu.preprocessing import layers as jl
import elasticdl_tpu_torch.preprocessing as tpre
from elasticdl_tpu_torch.embedding.layer import PADDING_ID, Embedding
from elasticdl_tpu_torch.preprocessing import analyzer_utils as tan
from elasticdl_tpu_torch.preprocessing import feature_column as tfc
from elasticdl_tpu_torch.preprocessing import layers as tl

EMB_TOL = 1e-6


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_package_exports_the_jax_layers():
    names = sorted(n for n in dir(jpre) if not n.startswith("_")
                   and n[0].isupper())
    assert names == sorted(n for n in dir(tpre) if not n.startswith("_")
                           and n[0].isupper())
    assert len(names) == 11


# ---------------------------------------------------------------- hashing

HASH_INPUTS = {
    "bytes": b"reversible",
    "str": "Self-emp-not-inc",
    "bytes_array": np.array([b"fixed", b"normal", b""], dtype="S16"),
    "str_array": np.array([["a", "bb"], ["ccc", "a"]]),
    "int": 12345,
    "int_array": np.array([[3, PADDING_ID, 0], [7, 1 << 40, PADDING_ID]]),
    "np_int_scalar": np.int64(-7),
    "np_uint": np.array([1, 2, 3], np.uint32),
    "np_float32_scalar": np.float32(0.1),
    "np_float_array": np.array([0.1, 2.5, -3.0, 1e-8], np.float32),
    "np_float64": np.array([0.1, 1.0 / 3.0]),
    "unicode": "café",
}


@pytest.mark.parametrize("case", sorted(HASH_INPUTS))
@pytest.mark.parametrize("bins", [1, 100, 1 << 20])
def test_hashing_matches_jax(case, bins):
    x = HASH_INPUTS[case]
    got, want = tl.Hashing(bins)(x), jl.Hashing(bins)(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.float32])
def test_hashing_torch_tensors_hash_their_values(dtype):
    """A tensor hashes as the JAX layer hashes its numpy values: ints
    as ints (PADDING_ID kept), fp32 elements as numpy's fp32 scalars;
    never `str(tensor)`."""
    values = np.array([[5, PADDING_ID, 0], [PADDING_ID, 99, 7]])
    x = torch.tensor(values, dtype=dtype)
    if dtype == torch.float32:
        x = x / 3
    got = tl.Hashing(1000)(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    want = jl.Hashing(1000)(x.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype != torch.float32:
        assert (got.numpy()[values == PADDING_ID] == PADDING_ID).all()
    scalar = torch.tensor(3, dtype=dtype)
    np.testing.assert_array_equal(tl.Hashing(1000)(scalar).numpy(),
                                  jl.Hashing(1000)(scalar.numpy()))
    assert int(tl.Hashing(1 << 30)(torch.tensor(3))) != int(
        jl.Hashing(1 << 30)("tensor(3)"))


def test_hashing_rejects_bad_bins():
    for bad in (None, 0, -1):
        with pytest.raises(ValueError):
            tl.Hashing(bad)


# ----------------------------------------------------------- index lookup

VOCAB = ["Private", "Self-emp-inc", "Federal-gov", "Local-gov"]
LOOKUP_IN = np.array([[b"Private", b"Never-worked", b"Local-gov"],
                      [b"", b"Federal-gov", b"Self-emp-inc"],
                      [b"x", b"y", b"z"]], dtype="S16")


@pytest.mark.parametrize("oov", [1, 3])
def test_index_lookup_matches_jax(oov):
    got = tl.IndexLookup(VOCAB, num_oov_tokens=oov)
    want = jl.IndexLookup(VOCAB, num_oov_tokens=oov)
    assert got.vocab_size() == want.vocab_size() == len(VOCAB) + oov
    for x in (LOOKUP_IN, LOOKUP_IN.astype(str), "Private", b"nope"):
        np.testing.assert_array_equal(got(x), want(x))
    out = got(LOOKUP_IN)
    assert ((out >= len(VOCAB)) == np.isin(LOOKUP_IN.astype(str), VOCAB,
                                           invert=True)).all()
    if oov == 3:
        assert len(set(out[2].tolist())) > 1  # OOV spread over 3 ids


def test_index_lookup_from_a_file(tmp_path):
    path = str(tmp_path / "vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(VOCAB) + "\n\n")
    got, want = tl.IndexLookup(path), jl.IndexLookup(path)
    assert got.vocabulary == want.vocabulary == VOCAB
    np.testing.assert_array_equal(got(LOOKUP_IN), want(LOOKUP_IN))
    with pytest.raises(ValueError, match="repeated"):
        tl.IndexLookup(["a", "b", "a"])


# ------------------------------------------------------- numeric layers

RS = np.random.RandomState(0)
FLOATS = np.concatenate([
    RS.randn(40).astype(np.float32) * 20,
    np.array([-0.5, 0.5, 1.5, 2.5, 3.5, -1.5, 0.0, 4.0, 9.5], np.float32),
])
POSITIVE = np.concatenate([np.exp(RS.randn(40)).astype(np.float32) * 30,
                           np.array([1.0, 2.0, 4.0, 8.0, 1024.0],
                                    np.float32)])

NUMERIC = {
    "normalizer": (lambda m: m.Normalizer(1.913844818114358,
                                          7.203044443387521), FLOATS),
    "round_identity": (lambda m: m.RoundIdentity(6, default_value=5),
                       FLOATS.reshape(7, 7)),
    "log_round": (lambda m: m.LogRound(10), POSITIVE),
    "log_round_base2": (lambda m: m.LogRound(12, base=2, default_value=11),
                        POSITIVE.reshape(5, 9)),
    "discretization": (lambda m: m.Discretization([0, 1, 4, 16, 64]),
                       FLOATS),
    "discretization_ints": (lambda m: m.Discretization([0, 20, 40, 60, 80]),
                            np.array([[-3, 0, 19], [20, 40, 99]])),
}


@pytest.mark.parametrize("case", sorted(NUMERIC))
def test_numeric_layers_match_jax(case):
    make, x = NUMERIC[case]
    got, want = make(tl)(x), make(jl)(x)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a tensor: the jnp path's result, as a tensor
    t = make(tl)(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor)
    ref = np.asarray(make(jl)(jnp.asarray(x)))
    if case == "normalizer":
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-7, atol=0)
    else:
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), ref)
        np.testing.assert_array_equal(t.numpy(), got)


def test_round_identity_rounds_half_to_even():
    halves = np.array([0.5, 1.5, 2.5, -0.5, 3.5], np.float32)
    want = np.array([0, 2, 2, 0, 4])
    np.testing.assert_array_equal(tl.RoundIdentity(5)(halves), want)
    np.testing.assert_array_equal(
        tl.RoundIdentity(5)(torch.from_numpy(halves)).numpy(), want)


EDGES = np.array([-1, 0, np.nan, np.inf, 0.5, 2.5, 1e12], np.float32)


@pytest.mark.parametrize("make,jnp_ids", [
    (lambda m: m.LogRound(10, base=2, default_value=7),
     [0, 7, 0, 7, 7, 1, 7]),
    (lambda m: m.RoundIdentity(5, default_value=3), [3, 0, 0, 3, 0, 2, 3]),
], ids=["log_round", "round_identity"])
def test_rounding_layers_read_nan_as_the_jnp_path_does(make, jnp_ids):
    """A NaN (log of -1, or NaN itself) is id 0 through the tensor path,
    as XLA casts it in the JAX layer's jnp path; the numpy paths of both
    packages give default_value."""
    ref = np.asarray(make(jl)(jnp.asarray(EDGES)))
    np.testing.assert_array_equal(ref, jnp_ids)
    got = make(tl)(torch.from_numpy(EDGES))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(make(tl)(EDGES), make(jl)(EDGES))


def test_discretization_boundary_is_the_right_bucket():
    """A value equal to a boundary goes to the bucket right of it, as
    searchsorted(side="right") (torch.bucketize(right=True))."""
    layer = tl.Discretization([0.0, 1.0, 2.0])
    x = np.array([-1.0, 0.0, 0.5, 1.0, 2.0, 3.0], np.float32)
    want = np.array([0, 1, 1, 2, 3, 3])
    np.testing.assert_array_equal(layer(x), want)
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), want)
    assert layer.num_bins() == jl.Discretization([0.0, 1.0, 2.0]).num_bins()


def test_normalizer_rejects_zero_divisor():
    with pytest.raises(ValueError):
        tl.Normalizer(1.0, 0)


@pytest.mark.parametrize("as_torch", [False, True])
def test_concatenate_with_offset_keeps_padding(as_torch):
    parts = [np.array([[0, 2], [PADDING_ID, 1]]),
             np.array([[3], [PADDING_ID]]),
             np.array([[PADDING_ID, 0, 4], [1, 1, PADDING_ID]])]
    offsets = [0, 3, 7]
    want = jl.ConcatenateWithOffset(offsets)(parts)
    ins = [torch.from_numpy(p) for p in parts] if as_torch else parts
    got = tl.ConcatenateWithOffset(offsets)(ins)
    assert isinstance(got, torch.Tensor) == as_torch
    np.testing.assert_array_equal(_np(got), want)
    rows = [ins[0], ins[0]]  # no offsets, stacked on axis 0
    np.testing.assert_array_equal(
        _np(tl.ConcatenateWithOffset(None, axis=0)(rows)),
        jl.ConcatenateWithOffset(None, axis=0)([parts[0], parts[0]]))
    with pytest.raises(ValueError, match="offsets length"):
        tl.ConcatenateWithOffset([0, 1])(ins)
    assert tl.ConcatenateWithOffset(offsets)(ins[0]) is ins[0]


# -------------------------------------------------------- string layers

STRINGS = np.array([[b"1.5", b"", b"-2"], [b"x", b"7", b"3e2"]], dtype="S8")


@pytest.mark.parametrize("out_type", [np.float32, np.int64])
def test_to_number_matches_jax(out_type):
    for x in (STRINGS, STRINGS.astype(str), np.array([1, 2], np.int32),
              np.array([0.5, 2.5])):
        got = tl.ToNumber(out_type, -1)(x)
        want = jl.ToNumber(out_type, -1)(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


RAGGED_INPUTS = {
    "ints": np.array([[3, -1, 4], [-1, -1, 2], [5, 6, 7]]),
    "bytes": np.array([[b"3", b"-1", b""], [b"8", b"9", b"-1"]],
                      dtype="S4"),
    "flat": np.array([1, -1, 3]),
}


@pytest.mark.parametrize("case", sorted(RAGGED_INPUTS))
def test_to_ragged_and_to_sparse_match_jax(case):
    x = RAGGED_INPUTS[case]
    np.testing.assert_array_equal(tl.ToRagged()(x), jl.ToRagged()(x))
    if x.ndim == 2:
        np.testing.assert_array_equal(tl.ToSparse()(x), jl.ToSparse()(x))
    np.testing.assert_array_equal(tl.ToRagged(ignore_value=3)(x),
                                  jl.ToRagged(ignore_value=3)(x))


# ------------------------------------------------------------- analyzer


@pytest.fixture
def analysis_env(monkeypatch):
    """Every analysis variable this test sets is removed after it."""
    before = dict(os.environ)
    yield
    for key in set(os.environ) - set(before):
        monkeypatch.delenv(key)


def test_analyzer_environment_channel_across_packages(analysis_env):
    rs = np.random.RandomState(3)
    column = rs.randn(200).astype(np.float32) * 5 + 2
    vocab_column = np.array([b"b", b"a,1", b"b", b"c/d"])
    got = tan.publish_analysis("edl_test_x", column, num_buckets=5)
    for key in got:
        del os.environ[key]
    want = jan.publish_analysis("edl_test_x", column, num_buckets=5)
    assert got == want  # the same names and values, published by JAX now
    for mod in (tan, jan):  # each package reads what the other set
        assert mod.get_min("edl_test_x") == float(column.min())
        assert mod.get_max("edl_test_x", default=-1.0) == float(column.max())
        assert mod.get_bucket_boundaries("edl_test_x") == (
            jan.get_bucket_boundaries("edl_test_x"))
        assert mod.get_distinct_count("edl_test_x") == 200
    tan.publish_analysis("edl_test_v", vocab_column)
    assert jan.get_vocabulary("edl_test_v") == ["b", "a,1", "c/d"]
    os.environ["_edl_test_p_vocab"] = os.path.join("some", "vocab.txt")
    os.environ["_edl_test_l_vocab"] = "x,y"
    for name in ("edl_test_v", "edl_test_p", "edl_test_l", "edl_unset"):
        assert tan.get_vocabulary(name) == jan.get_vocabulary(name)
    for fn in ("get_min", "get_max", "get_avg", "get_stddev",
               "get_distinct_count"):
        assert getattr(tan, fn)(column) == getattr(jan, fn)(column)
        assert getattr(tan, fn)("edl_unset") == getattr(jan, fn)("edl_unset")
        assert getattr(tan, fn)() == getattr(jan, fn)()
    assert tan.get_bucket_boundaries(column, num_buckets=4) == (
        jan.get_bucket_boundaries(column, num_buckets=4))
    assert tan.get_vocabulary(vocab_column) == jan.get_vocabulary(
        vocab_column)


# ------------------------------------------------ embeddings and columns


def _jax_lookup(layer, table, ids):
    return np.asarray(layer.apply({"params": {"embedding_table": table}},
                                  jnp.asarray(ids)))


def _port_lookup(layer, table, ids):
    layer.load_state_dict({"embedding_table": torch.from_numpy(table)})
    return layer(torch.from_numpy(ids)).detach().numpy()


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_sparse_embedding_matches_jax(combiner):
    rs = np.random.RandomState(4)
    table = rs.uniform(-1, 1, (50, 6)).astype(np.float32)
    ids = rs.randint(0, 50, (7, 5))
    ids[0] = PADDING_ID  # a row with no ids: zeros
    ids[1, 2:] = PADDING_ID
    layer = tl.SparseEmbedding(50, 6, combiner=combiner, device="cpu")
    assert isinstance(layer, Embedding) and layer.combiner == combiner
    got = _port_lookup(layer, table, ids)
    want = _jax_lookup(jl.SparseEmbedding(50, 6, combiner=combiner), table,
                       ids)
    np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=EMB_TOL)
    assert not got[0].any()


def _columns(mod):
    return [mod.categorical_column_with_identity("a", 5),
            mod.CategoricalColumn("b", 7,
                                  transform=lambda v: np.asarray(v) % 7),
            mod.categorical_column_with_identity("c", 3)]


def test_concatenated_column_and_embedding_column_match_jax():
    rs = np.random.RandomState(5)
    features = {"a": rs.randint(0, 5, (6, 2)),
                "b": rs.randint(0, 100, (6,)),
                "c": rs.randint(0, 3, (6, 3))}
    features["a"][1, 1] = PADDING_ID
    features["c"][2] = PADDING_ID
    col, jcol = (m.concatenated_categorical_column(_columns(m))
                 for m in (tfc, jfc))
    assert col.num_buckets == jcol.num_buckets == 15
    assert col.keys == jcol.keys == ["a", "b", "c"]
    ids = col(features)
    np.testing.assert_array_equal(ids, jcol(features))
    assert (ids[:, :2][features["a"] == PADDING_ID] == PADDING_ID).all()
    table = rs.uniform(-0.05, 0.05, (15, 4)).astype(np.float32)
    for combiner in ("sum", "mean"):
        column_fn, factory = tfc.embedding_column(col, 4, combiner=combiner)
        jcolumn_fn, jfactory = jfc.embedding_column(jcol, 4,
                                                    combiner=combiner)
        layer = factory(device="cpu")
        assert isinstance(layer, Embedding) and layer.input_dim == 15
        got = _port_lookup(layer, table, column_fn(features))
        want = _jax_lookup(jfactory(name="concat"), table,
                           jcolumn_fn(features))
        np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=EMB_TOL)
    # the default initializer is keras RandomUniform(-0.05, 0.05)
    drawn = factory(device="cpu", generator=torch.Generator().manual_seed(1))
    assert float(drawn.embedding_table.abs().max()) <= 0.05
    assert jax.default_backend() == "cpu"
