"""The rest of the port's array layer (ROADMAP A1) against mxtpu: the
dtype an NDArray reports (numpy's scalar type, as mxtpu and MXNet give
it), ``nd.eye``, ``NDArray.item`` and ``reshape_like``,
``nd.load_from_bytes``, ``nd.invoke`` and ``nd.list_ops``, and MXNet's
``out=`` on every registered op.

Each case runs in both packages on the same inputs, the port inside
``with cpu():``; values and dtypes must agree exactly.
"""
import io

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

DTYPES = ("float32", "float16", "int32", "uint8")


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_is_numpys(name):
    """``a.dtype`` is numpy's scalar type: made with the dtype, and after
    ``astype`` to it from float32; ``np.dtype`` of it works."""
    want = np.dtype(name).type
    for pkg in (mt, mx):
        with pkg.cpu():
            a = pkg.nd.array(np.ones(3, name))
            b = pkg.nd.array(np.ones(3, np.float32)).astype(name)
            c = pkg.nd.zeros((2,), dtype=name)
        for arr in (a, b, c):
            assert arr.dtype == want and arr.dtype is want, (pkg, arr.dtype)
            assert np.dtype(arr.dtype) == np.dtype(name)
            assert arr.asnumpy().dtype == np.dtype(name)


def test_dtype_of_list_and_float64_sources():
    """Lists give float32, float64 numpy narrows to float32, int64 to
    int32: the types match mxtpu's."""
    for src in ([1, 2], np.ones(2), np.arange(3)):
        with mt.cpu():
            got = mt.nd.array(src).dtype
        assert got == mx.nd.array(src).dtype, (src, got)


def test_bfloat16_reports_torchs_type():
    """numpy has no bfloat16: such an array reports torch.bfloat16, which
    astype and zeros take back."""
    import torch
    with mt.cpu():
        a = mt.nd.ones((2,)).astype("bfloat16")
        assert a.dtype == torch.bfloat16
        assert mt.nd.zeros((2,), dtype=a.dtype).data.dtype == torch.bfloat16


@pytest.mark.parametrize("n, m, k", [(3, 0, 0), (3, 4, 1), (4, 3, -2),
                                     (2, 5, 7), (3, 3, -3)])
def test_eye(n, m, k):
    with mt.cpu():
        got = mt.nd.eye(n, m, k)
    want = mx.nd.eye(n, m, k)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    with mt.cpu():
        assert mt.nd.eye(2, dtype="int32").dtype == np.int32


def test_item_and_reshape_like():
    for pkg in (mt, mx):
        with pkg.cpu():
            a = pkg.nd.array(np.arange(6, dtype=np.float32))
            b = pkg.nd.zeros((2, 3))
            assert pkg.nd.array([2.5]).item() == 2.5
            assert a.reshape_like(b).shape == (2, 3)
            assert float(pkg.nd.array([1.5])) == 1.5
            assert int(pkg.nd.array([3.0])) == 3
            with pytest.raises(ValueError):
                a.item()
    with mt.cpu():
        np.testing.assert_array_equal(
            np.asarray(mt.nd.array([1.0, 2.0])), [1.0, 2.0])
        assert [r.shape for r in mt.nd.zeros((3, 2))] == [(2,)] * 3


@pytest.mark.parametrize("writer", ["mxtpu", "port"])
def test_load_from_bytes(tmp_path, writer):
    """The bytes of a .params file either package saved load in both, as
    a dict and as a list."""
    rng = np.random.RandomState(0)
    arrs = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "i": np.arange(5, dtype=np.int32)}
    pkg = mx if writer == "mxtpu" else mt
    for i, data in enumerate(({k: v for k, v in arrs.items()},
                              list(arrs.values()))):
        fname = str(tmp_path / ("a%d.params" % i))
        with pkg.cpu():
            pkg.nd.save(fname, {k: pkg.nd.array(v) for k, v in data.items()}
                        if isinstance(data, dict)
                        else [pkg.nd.array(v) for v in data])
        buf = open(fname, "rb").read()
        with mt.cpu():
            got = mt.nd.load_from_bytes(buf)
        want = mx.nd.load_from_bytes(buf)
        if isinstance(data, dict):
            assert set(got) == set(want) == set(arrs)
            pairs = [(got[k], want[k]) for k in arrs]
        else:
            pairs = list(zip(got, want))
        for g, w in pairs:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(Exception):
        mt.nd.load_from_bytes(io.BytesIO(b"not a file").getvalue())


def test_invoke_and_list_ops():
    from mxtpu.ops import registry as jreg
    from mxtpu_torch.ops import registry as treg
    x = np.arange(6, dtype=np.float32).reshape(2, 3) - 2
    with mt.cpu():
        got = mt.nd.invoke(treg.get_op("relu"), [mt.nd.array(x)], {})
        topk = mt.nd.invoke(treg.get_op("topk"), [mt.nd.array(x)],
                            {"k": 2, "ret_typ": "both"})
    want = mx.nd.invoke(jreg.get_op("relu"), [mx.nd.array(x)], {})
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    wtop = mx.nd.invoke(jreg.get_op("topk"), [mx.nd.array(x)],
                        {"k": 2, "ret_typ": "both"})
    assert len(topk) == len(wtop) == 2
    for g, w in zip(topk, wtop):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    names = mt.nd.list_ops()
    assert names == sorted(names)
    missing = set(jreg.list_ops()) - set(names)
    # only A11's 2-bit gradient compression (and its aliases) waits
    assert {jreg.get_op(n).name for n in missing} == {
        "_contrib_gc_quantize_2bit", "_contrib_gc_dequantize_2bit"}


def _out_case(pkg):
    """Registered ops with ``out=``: the result written into the array
    given, which is returned."""
    nd = pkg.nd
    rng = np.random.RandomState(1)
    a, b = (nd.array(rng.standard_normal((2, 3)).astype(np.float32))
            for _ in range(2))
    res = []
    o = nd.zeros((2, 3))
    r = nd.elemwise_add(a, b, out=o)
    assert r is o
    res.append(o.asnumpy())
    o = nd.zeros((2, 3))
    assert nd.relu(a, out=o) is o
    res.append(o.asnumpy())
    o = nd.zeros((2, 3))
    assert a.exp(out=o) is o
    res.append(o.asnumpy())
    # an update with out= naming the weight: the weight is the result
    w, g = nd.array(a.asnumpy()), nd.array(b.asnumpy())
    mom = nd.zeros((2, 3))
    assert nd.sgd_update(w, g, lr=0.1, wd=0.01, out=w) is w
    res.append(w.asnumpy())
    assert nd.sgd_mom_update(w, g, mom, lr=0.1, momentum=0.9, out=w) is w
    res.append(w.asnumpy())
    # a multi-output op: its first output
    o = nd.zeros((2, 2))
    assert nd.topk(a, k=2, ret_typ="both", out=o) is o
    res.append(o.asnumpy())
    # a random op: the draw lands in the array
    o = nd.zeros((4,))
    assert nd.random_uniform(low=2.0, high=3.0, shape=(4,), out=o) is o
    got = o.asnumpy()
    assert got.shape == (4,) and ((got >= 2) & (got < 3)).all()
    return res


def test_out_on_registered_ops():
    with mt.cpu():
        got = _out_case(mt)
    want = _out_case(mx)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_ctx_of_creating_ops():
    """A random op takes ``ctx=`` (MXNet's), where its draw goes; the
    draws are the generator's either way."""
    mt.random.seed(3)
    with mt.cpu():
        a = mt.nd.random_normal(0, 1, shape=(3,)).asnumpy()
    mt.random.seed(3)
    b = mt.nd.random_normal(0, 1, shape=(3,), ctx=mt.cpu())
    assert b.context == mt.cpu()
    np.testing.assert_array_equal(a, b.asnumpy())


def test_random_namespace():
    """mx.random's samplers: shapes, dtypes and ranges as mxtpu's."""
    for pkg in (mt, mx):
        with pkg.cpu():
            pkg.random.seed(0)
            r = pkg.random
            outs = [r.uniform(0, 1, shape=(50,)), r.normal(0, 1, (50,)),
                    r.gamma(2.0, 1.0, shape=(50,)),
                    r.exponential(2.0, shape=(50,)),
                    r.poisson(3.0, shape=(50,)),
                    r.negative_binomial(2, 0.5, shape=(50,)),
                    r.generalized_negative_binomial(2.0, 0.5, shape=(50,)),
                    r.randint(0, 5, shape=(50,)),
                    r.multinomial(pkg.nd.array([[0.2, 0.8]]), shape=(50,)),
                    r.shuffle(pkg.nd.array(np.arange(10, dtype="f")))]
            shapes = [o.shape for o in outs]
            dtypes = [np.dtype(o.dtype) for o in outs]
        if pkg is mt:
            port = (shapes, dtypes)
        else:
            assert port == (shapes, dtypes), (port, (shapes, dtypes))
    assert (outs[3].asnumpy() >= 0).all()
    assert set(np.unique(outs[7].asnumpy())) <= set(range(5))
