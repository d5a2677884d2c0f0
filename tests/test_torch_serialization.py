"""The port's `.params` files against the JAX package's, both ways.

* a file written by either package loads in the other with the same
  values and dtypes (float32, float16, bfloat16, int32, bool), and the
  two packages write the same entries: names, dtypes and bytes (the
  bfloat16 bits as uint16 beside a `__dtype__:bfloat16` entry);
* the port restores bfloat16 and float8 without ml_dtypes, and no
  module of the port imports jax, mxnet_tpu, orbax or ml_dtypes;
* the legacy MXNet `.params` layouts v0 to v3 (the byte builders of
  tests/test_serialization.py) and the refusal of a sparse record;
* Block.save_parameters / load_parameters and ParameterDict.save / load
  with allow_missing, ignore_extra and cast_dtype, into deferred and
  uninitialised parameters;
* a 2-layer BERT MLM saved by the JAX net and loaded by the port's net
  gives the logits of the same net loaded by load_jax_params.
"""
import ast
import os
import struct
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import serialization as jser  # noqa: E402
from mxnet_tpu.models import BertConfig as JaxConfig  # noqa: E402
from mxnet_tpu.models import BertForMaskedLM as JaxBert  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, serialization as ser  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.models import (BertConfig, BertForMaskedLM,  # noqa: E402
                                    load_jax_params)

CPU = mx.cpu()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

R = np.random.default_rng(0)
VALUES = {
    "float32": R.standard_normal((3, 4)).astype(np.float32),
    "float16": R.standard_normal((5,)).astype(np.float16),
    "bfloat16": R.standard_normal((2, 3)).astype(np.float32),
    "int32": R.integers(-9, 9, (4, 2)).astype(np.int32),
    "bool": R.integers(0, 2, (3,)).astype(bool),
}


def _jax_arrays():
    return {k: jmx.nd.array(v, dtype=k) for k, v in VALUES.items()}


def _port_arrays():
    return {k: mx.nd.array(v, ctx=CPU, dtype=k) for k, v in VALUES.items()}


def _as_f32(a):
    a = np.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def test_reference_file_loads_in_the_port(tmp_path):
    f = str(tmp_path / "ref.npz")
    jser.save_ndarray_dict(f, _jax_arrays())
    got = ser.load_ndarray_dict(f, ctx=CPU)
    assert set(got) == set(VALUES)
    for k, v in _jax_arrays().items():
        want = {"bfloat16": torch.bfloat16}.get(k, np.dtype(k))
        assert got[k].dtype == want, k
        np.testing.assert_array_equal(_as_f32(got[k]._data.float()
                                              if k == "bfloat16"
                                              else got[k]), _as_f32(v))


def test_port_file_loads_in_the_reference(tmp_path):
    f = str(tmp_path / "port.npz")
    ser.save_ndarray_dict(f, _port_arrays())
    got = jser.load_ndarray_dict(f)
    assert set(got) == set(VALUES)
    for k, v in _port_arrays().items():
        assert str(got[k].dtype) == k, k
        want = v._data.float().numpy() if k == "bfloat16" else v.asnumpy()
        np.testing.assert_array_equal(_as_f32(got[k]), want)


def test_both_packages_write_the_same_entries(tmp_path):
    fj, fp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jser.save_ndarray_dict(fj, _jax_arrays())
    ser.save_ndarray_dict(fp, _port_arrays())
    with np.load(fj, allow_pickle=False) as zj, \
            np.load(fp, allow_pickle=False) as zp:
        assert zj.files == zp.files
        assert "__dtype__:bfloat16" in zp.files
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, k
            assert zj[k].shape == zp[k].shape, k
            assert zj[k].tobytes() == zp[k].tobytes(), k
        assert zp["bfloat16"].dtype == np.uint16
        assert str(zp["__dtype__:bfloat16"]) == "bfloat16"


def test_port_needs_no_ml_dtypes(tmp_path, monkeypatch):
    """bfloat16 and float8 round-trip with ml_dtypes unimportable."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    f = str(tmp_path / "raw.npz")
    bf = torch.randn(3, 5).to(torch.bfloat16)
    e4 = torch.randn(7).to(torch.float8_e4m3fn)
    e5 = torch.randn(2, 2).to(torch.float8_e5m2)
    ser.save_ndarray_dict(f, {"bf": bf, "e4": e4, "e5": e5})
    got = ser.load_tensor_dict(f)
    for k, t in (("bf", bf), ("e4", e4), ("e5", e5)):
        assert got[k].dtype == t.dtype
        assert torch.equal(got[k].view(torch.uint8), t.view(torch.uint8))
    with np.load(f, allow_pickle=False) as z:
        assert str(z["__dtype__:e4"]) == "float8_e4m3fn"


def test_no_port_module_imports_jax_orbax_or_ml_dtypes():
    banned = {"jax", "jaxlib", "mxnet_tpu", "orbax", "ml_dtypes"}
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in banned, (path, m)


# -- the legacy MXNet .params binary (builders of tests/test_serialization.py)

def _legacy_record_v2(arr, magic=0xF993FAC9):
    out = struct.pack("<I", magic)
    out += struct.pack("<i", 0)  # kDefaultStorage
    out += struct.pack("<i", arr.ndim)
    out += struct.pack(f"<{arr.ndim}q", *arr.shape)
    out += struct.pack("<iii", 1, 0, 0)  # cpu, dev 0, float32
    out += arr.astype("<f4").tobytes()
    return out


def _legacy_record_v1(arr):
    out = struct.pack("<I", 0xF993FAC8)
    out += struct.pack("<I", arr.ndim)
    out += struct.pack(f"<{arr.ndim}q", *arr.shape)
    out += struct.pack("<iii", 1, 0, 0)
    out += arr.astype("<f4").tobytes()
    return out


def _legacy_record_v0(arr):
    out = struct.pack("<I", arr.ndim)
    out += struct.pack(f"<{arr.ndim}I", *arr.shape)
    out += struct.pack("<iii", 1, 0, 0)
    out += arr.astype("<f4").tobytes()
    return out


def _legacy_record_v3(arr):
    return _legacy_record_v2(arr, magic=0xF993FACA)


def _legacy_file(tmp_path, records, names):
    data = struct.pack("<QQ", 0x112, 0)
    data += struct.pack("<Q", len(records)) + b"".join(records)
    data += struct.pack("<Q", len(names))
    for n in names:
        nb = n.encode()
        data += struct.pack("<Q", len(nb)) + nb
    f = tmp_path / "legacy.params"
    f.write_bytes(data)
    return str(f)


@pytest.mark.parametrize("rec", [_legacy_record_v0, _legacy_record_v1,
                                 _legacy_record_v2, _legacy_record_v3])
def test_legacy_params_layouts(tmp_path, rec):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.array([1.0, -2.0, 3.0], dtype=np.float32)
    f = _legacy_file(tmp_path, [rec(w), rec(b)], ["arg:weight", "aux:bias"])
    out = ser.load_mxnet_params(f)
    ref = jser.load_mxnet_params(f)
    for k in ("arg:weight", "aux:bias"):
        np.testing.assert_array_equal(out[k], ref[k])
        assert out[k].dtype == ref[k].dtype
    nd = ser.load_ndarray_dict(f, ctx=CPU)
    np.testing.assert_array_equal(nd["arg:weight"].asnumpy(), w)
    # the arg: / aux: prefixes are stripped when parameters load
    net = nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    net.load_parameters(f)
    np.testing.assert_array_equal(_get(net, 'weight'), w)
    np.testing.assert_array_equal(_get(net, 'bias'), b)


def test_legacy_bfloat16_record(tmp_path):
    w = np.linspace(-2, 2, 6, dtype=np.float32).reshape(2, 3)
    bits = torch.from_numpy(w).to(torch.bfloat16).view(torch.int16).numpy()
    rec = struct.pack("<Iii", 0xF993FAC9, 0, 2) + struct.pack("<2q", 2, 3)
    rec += struct.pack("<iii", 1, 0, 12) + bits.tobytes()
    f = _legacy_file(tmp_path, [rec], ["w"])
    got = ser.load_mxnet_params(f)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jser.load_mxnet_params(f)["w"],
                                        np.float32))


def test_legacy_params_sparse_rejected(tmp_path):
    rec = struct.pack("<I", 0xF993FAC9) + struct.pack("<i", 1)  # row_sparse
    f = _legacy_file(tmp_path, [rec], ["w"])
    with pytest.raises(MXNetError, match="sparse"):
        ser.load_mxnet_params(f)


# -- Block / ParameterDict ----------------------------------------------------

def _get(net, name):
    return net.collect_params()[name].data().asnumpy()


def _mlp(in_units=3):
    net = nn.HybridSequential()
    net.add(nn.Dense(5, in_units=in_units))
    net.add(nn.Dense(2, in_units=5))
    return net


def test_block_save_load_flags(tmp_path):
    src = _mlp()
    src.initialize(mx.init.Normal(0.5), ctx=CPU)
    f = str(tmp_path / "mlp.params")
    src.save_parameters(f)
    want = {n: p.data().asnumpy() for n, p in src.collect_params().items()}
    # deferred shapes and no initialize(): the file gives both
    dst = nn.HybridSequential()
    dst.add(nn.Dense(5))
    dst.add(nn.Dense(2))
    dst.load_parameters(f, ctx=CPU)
    for n, p in dst.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), want[n])
        assert p.data()._data.device.type == "cpu"
    # a missing parameter, an extra one
    more = nn.HybridSequential()
    more.add(nn.Dense(5, in_units=3))
    more.add(nn.Dense(2, in_units=5))
    more.add(nn.Dense(1, in_units=2))
    more.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="missing"):
        more.load_parameters(f)
    keep = _get(more, '2.weight').copy()
    more.load_parameters(f, allow_missing=True)
    np.testing.assert_array_equal(_get(more, '2.weight'), keep)
    fewer = nn.HybridSequential()
    fewer.add(nn.Dense(5, in_units=3))
    fewer.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="extra"):
        fewer.load_parameters(f)
    fewer.load_parameters(f, ignore_extra=True)
    np.testing.assert_array_equal(_get(fewer, '0.bias'),
                                  want["0.bias"])
    # cast_dtype: a float32 file into float16 parameters, either way
    half = _mlp()
    half.initialize(ctx=CPU)
    half.cast("float16")
    half.load_parameters(f, cast_dtype=True)
    assert _get(half, '0.weight').dtype == np.float16
    np.testing.assert_array_equal(_get(half, '0.weight'),
                                  want["0.weight"].astype(np.float16))


def test_parameter_dict_save_load_and_reference(tmp_path):
    src = _mlp()
    src.initialize(mx.init.Normal(0.5), ctx=CPU)
    params = src.collect_params()
    f = str(tmp_path / "pd.params")
    params.save(f, strip_prefix="0.")
    names = set(ser.load_tensor_dict(f))
    assert names == {"weight", "bias", "1.weight", "1.bias"}
    # the reference reads the port's file as parameters of its own net
    from mxnet_tpu.gluon import nn as jnn
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(5, in_units=3))
    jnet.add(jnn.Dense(2, in_units=5))
    jnet.initialize()
    g = str(tmp_path / "full.params")
    src.save_parameters(g)
    jnet.load_parameters(g)
    for n, p in jnet.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      params[n].data().asnumpy())
    dst = _mlp()
    dst.initialize(ctx=CPU)
    dst.collect_params().load(g)
    for n, p in dst.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      params[n].data().asnumpy())


KW = dict(vocab_size=100, units=64, hidden_size=64, num_layers=2,
          num_heads=2, max_length=16, dropout=0.0, attention_dropout=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_saved_by_jax_loads_in_the_port(tmp_path, dtype):
    jnet = JaxBert(JaxConfig(**KW))
    jmx.rng.seed(5)
    jnet.initialize(jmx.init.Normal(0.02))
    if dtype == "bfloat16":
        jnet.cast("bfloat16")
    f = str(tmp_path / "bert.params")
    jnet.save_parameters(f)
    arrays = {k: v.float().numpy() if v.dtype == torch.bfloat16 else
              v.numpy() for k, v in ser.load_tensor_dict(f).items()}
    net = BertForMaskedLM(BertConfig(**KW), device="cpu")
    ref = load_jax_params(BertForMaskedLM(BertConfig(**KW), device="cpu"),
                          arrays)
    if dtype == "bfloat16":
        net.cast("bfloat16")
        ref.cast("bfloat16")
    net.load_parameters(f)
    for (n, p), (m, q) in zip(net.named_parameters(),
                              ref.named_parameters()):
        assert n == m and p.dtype == q.dtype
        assert torch.equal(p, q), n
    r = np.random.default_rng(0)
    ids = torch.from_numpy(r.integers(0, 100, (2, 16)).astype(np.int32))
    tt = torch.zeros_like(ids)
    vl = torch.tensor([16, 9], dtype=torch.int32)
    pos = torch.tensor([[1, 4, 7], [0, 2, 8]], dtype=torch.int32)
    with torch.no_grad():
        assert torch.equal(net(ids, tt, vl, pos), ref(ids, tt, vl, pos))
    # and back: the port's file loads in the JAX net, bit for bit
    g = str(tmp_path / "back.params")
    net.save_parameters(g)
    jback = JaxBert(JaxConfig(**KW))
    jback.initialize()
    if dtype == "bfloat16":
        jback.cast("bfloat16")
    jback.load_parameters(g)
    for n, p in jnet.collect_params().items():
        np.testing.assert_array_equal(
            _as_f32(jback.collect_params()[n].data()), _as_f32(p.data()))
