"""The TRAIN symbols of ``example/char_lm/char_lm.py`` and
``example/moe_transformer/moe_transformer.py`` (``cached_attention`` at
pos 0 over zero-fed caches; the MoE FFN) through ``Module.fit`` in both
packages on the CPU: ``chip_smoke.py``'s mirrors (``char_lm_build``,
``moe_build_model``, ``a7_first_fits``) from the same weights, the first
3 steps of each (Adam; the fused step in both packages).

The steps agree within ``EX_SHARE`` (1e-3) of the largest step, the
allowance the card's run of the same steps is held to: float32 gradients
in another summation order, which Adam divides by their own size, so an
element whose gradient is near its rounding steps differently (1.1e-6
against a largest step of 9e-3 in the char LM's first 3 steps). A key's
bias is the exception: it shifts every score of a query
row alike, which the softmax ignores, so its gradient is rounding alone
and Adam steps it by the sign of that rounding; its steps are held to
Adam's bound (the learning rate a step) instead.
"""
import os
import sys

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402

@pytest.fixture(scope="module")
def first_fits():
    with mt.cpu():
        port = CS.a7_first_fits(mt, mt.cpu())
    inits = {k: port[k + " init"] for k in ("char_lm", "moe_transformer")}
    ref = CS.a7_first_fits(mx, mx.cpu(), inits=inits)
    return port, ref


@pytest.mark.parametrize("example", ["char_lm", "moe_transformer"])
def test_first_steps_equal_mxtpu(first_fits, example):
    port, ref = first_fits
    assert port[example + " fused"] and ref[example + " fused"]
    got, want = port[example], ref[example]
    assert sorted(got) == sorted(want)
    lr = port[example + " lr"]
    top = max(float(np.abs(w).max()) for w in want.values())
    keyed = 0
    for k, w in want.items():
        if k.endswith(CS.A7_NO_GRAD):
            keyed += 1
            assert np.abs(got[k]).max() <= CS.FIT_STEPS * lr * (1 + 1e-3)
            continue
        np.testing.assert_allclose(got[k], w, rtol=0, atol=CS.EX_SHARE * top,
                                   err_msg=k)
    assert keyed == 2


def test_train_checkpoints_cross_both_ways(first_fits, tmp_path):
    """Each TRAIN symbol's checkpoint (its JSON, the declared pos and
    cache variables, the weights) written by either package loads in the
    other as written."""
    port, _ref = first_fits
    builds = {"char_lm": lambda p: CS.char_lm_train_symbol(p, 32, 2, 2, 48),
              "moe_transformer": lambda p: CS.moe_build_model(p, CS.MOE_T)}
    for name, build in builds.items():
        init = port[name + " init"]
        for src, dst in ((mt, mx), (mx, mt)):
            prefix = str(tmp_path / ("%s_%s" % (name, src.__name__)))
            params = {k: (src.nd.array(v, ctx=src.cpu()) if src is mt
                          else src.nd.array(v)) for k, v in init.items()}
            src.model.save_checkpoint(prefix, 0, build(src), params, {})
            with mt.cpu():
                sym, args, _aux = dst.model.load_checkpoint(prefix, 0)
            assert sym.list_arguments() == build(src).list_arguments()
            assert sym.list_outputs() == build(src).list_outputs()
            attrs = sym.attr_dict()
            assert tuple(attrs["kc0"]["__shape__"])[0] == 0
            assert tuple(attrs["pos"]["__shape__"]) == (0,)
            assert sorted(args) == sorted(init)
            for k, v in init.items():
                np.testing.assert_array_equal(args[k].asnumpy(), v)


def test_train_symbols_match_mxtpu_json():
    """The mirrors build the same graphs in both packages: arguments,
    outputs, the declared pos and cache shapes."""
    for build in (lambda p: CS.char_lm_train_symbol(p, 32, 2, 2, 48),
                  lambda p: CS.char_lm_gen_symbol(p, 32, 2, 2, 64),
                  lambda p: CS.moe_build_model(p, CS.MOE_T)):
        a, b = build(mx), build(mt)
        assert a.list_arguments() == b.list_arguments()
        assert a.list_outputs() == b.list_outputs()
        loaded = mt.sym.load_json(a.tojson())
        assert loaded.list_outputs() == a.list_outputs()
        assert tuple(loaded.attr_dict()["pos"]["__shape__"]) == (0,)
