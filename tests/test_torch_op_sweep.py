"""The op sweep as a parity gate: every op the PyTorch port registers,
held to ``mxtpu`` on the CPU over ``tests/test_op_sweep.py``'s specs.

For each spec whose op the port registers, the spec's inputs are drawn
from ``RandomState(_seed(name))`` and run through ``mxtpu`` (the sweep's
own ``_run``, ``nd.<name>``) and through the port's ``nd.<name>`` on
``cpu()``; each output is compared at the spec's ``rtol`` / ``atol``
(the values, and the dtype's kind). Where a spec has only a structural
``check``, the check runs on the port's outputs too. The gradients are in
``test_torch_op_sweep_grad.py``; the cases the specs do not reach, and
the two places where the port follows MXNet rather than ``mxtpu``, in
``test_torch_op_sweep_cases.py``.

``test_registry_partition`` is the coverage gate: every canonical
``mxtpu`` op is registered by the port, skipped here with the port's own
test named (``PORT_SKIP``), or listed in ``NOT_PORTED`` with the ROADMAP
item that ports it; an entry of ``NOT_PORTED`` that the port now
registers is stale, and every ``mxtpu`` alias of a ported op must name
the same op in the port.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu_torch as mt
from mxtpu.ops import registry as jax_registry
from mxtpu_torch.ops import registry as torch_registry
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_sweep():
    """``tests/test_op_sweep.py`` as a module (its SPECS, SKIP, _seed,
    _run)."""
    spec = importlib.util.spec_from_file_location(
        "op_sweep_specs", str(ROOT / "tests" / "test_op_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SWEEP = _load_sweep()
SPECS, SKIP, _seed = SWEEP.SPECS, SWEEP.SKIP, SWEEP._seed

# ops with no generic spec that the port registers: the port's own test
PORT_SKIP = {
    "RNN": "tests/test_torch_rnn_op.py and tests/test_torch_rnn_grad.py "
           "(the fused LSTM/GRU op and its gradients against mxtpu)",
    "Custom": "tests/test_torch_custom_op.py (registered Python ops, "
              "forward and backward, against mxtpu)",
    "_contrib_flash_attention": "tests/test_torch_flash_attention.py (the "
                                "kernels' plain versions against mxtpu's "
                                "Pallas kernels in interpret mode)",
    "cached_attention": "tests/test_torch_cached_attention.py (forward and "
                        "jax.vjp gradients against mxtpu: prefill, decode, "
                        "the clamp, ALiBi)",
    "moe_ffn": "tests/test_torch_cached_attention.py (forward and jax.vjp "
               "gradients against mxtpu: top-1, top-2, dropped tokens)",
}

# every canonical mxtpu op the port does not register yet, with the
# ROADMAP item that ports it
NOT_PORTED = {
    "_contrib_gc_quantize_2bit": "A11", "_contrib_gc_dequantize_2bit": "A11",
}
NOT_PORTED.update({n: "A9" for n in (
    # linalg_ops.py beyond dot / batch_dot
    "khatri_rao", "linalg_gelqf", "linalg_gemm", "linalg_gemm2",
    "linalg_potrf", "linalg_potri", "linalg_sumlogdiag", "linalg_syevd",
    "linalg_syrk", "linalg_trmm", "linalg_trsm",
    # extra_ops.py beyond Crop
    "IdentityAttachKLSparseReg", "_contrib_DeformableConvolution",
    "_contrib_DeformablePSROIPooling", "_contrib_bipartite_matching",
    "_contrib_box_iou", "_contrib_box_nms", "_contrib_quadratic",
    "_image_normalize", "_image_to_tensor", "adagrad_update",
    "reshape_like", "softmax_cross_entropy",
    # contrib_ops.py
    "_contrib_count_sketch", "_contrib_dequantize", "_contrib_fft",
    "_contrib_ifft", "_contrib_quantize",
    # optim_ops.py
    "adam_update", "ftml_update", "ftrl_update", "mp_sgd_mom_update",
    "mp_sgd_update", "rmsprop_update", "rmspropalex_update",
    "sgd_mom_update", "sgd_update", "signsgd_update", "signum_update",
    # random_ops.py
    "random_exponential", "random_gamma",
    "random_generalized_negative_binomial", "random_negative_binomial",
    "random_normal", "random_poisson", "random_randint", "random_uniform",
    "sample_exponential", "sample_gamma",
    "sample_generalized_negative_binomial", "sample_multinomial",
    "sample_negative_binomial", "sample_normal", "sample_poisson",
    "sample_uniform", "shuffle")})


def canonical_ops():
    """{canonical name: OpDef} of mxtpu's registry."""
    seen = {}
    for n in jax_registry.list_ops():
        op = jax_registry.get_op(n)
        seen.setdefault(op.name, op)
    return seen


def ported_specs():
    """The spec names whose op the port registers."""
    return sorted(n for n in SPECS if torch_registry.get_op(n) is not None)


def port_run(name, args, params):
    """The port's ``nd.<name>`` on ``cpu()``: its outputs as numpy."""
    with mt.cpu():
        nds = [mt.nd.array(a, ctx=mt.cpu()) if isinstance(a, np.ndarray)
               else a for a in args]
        out = getattr(mt.nd, name)(*nds, **params)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in outs]


def test_registry_partition():
    """Every canonical mxtpu op is ported, skipped with the port's own
    test named, or in NOT_PORTED; no NOT_PORTED entry is stale; mxtpu's
    aliases of a ported op name the same op in the port."""
    canon = canonical_ops()
    ported = {n for n in canon if torch_registry.get_op(n) is not None}
    skipped = set(PORT_SKIP)
    missing = sorted(set(canon) - ported - skipped - set(NOT_PORTED))
    assert not missing, "ops neither ported, skipped nor listed: %s" % missing
    stale = sorted(n for n in NOT_PORTED if n in ported)
    assert not stale, "NOT_PORTED entries the port registers: %s" % stale
    unknown = sorted(set(NOT_PORTED) - set(canon))
    assert not unknown, "NOT_PORTED entries mxtpu lacks: %s" % unknown
    # a skip names the port's own test where mxtpu's sweep skips the op
    # too, or has no spec for it (cached_attention, moe_ffn)
    assert skipped <= ported and skipped <= set(SKIP) | (
        set(canon) - set(SPECS)), sorted(skipped)
    assert all("tests/test_torch_" in r for r in PORT_SKIP.values())
    untested = sorted(ported - set(SPECS) - skipped)
    assert not untested, "ported ops with no spec or skip: %s" % untested
    wrong = []
    for n in jax_registry.list_ops():
        op = jax_registry.get_op(n)
        if op.name in ported:
            t = torch_registry.get_op(n)
            if t is None or t.name != op.name:
                wrong.append((n, op.name, t and t.name))
    assert not wrong, "aliases resolving elsewhere in the port: %s" % wrong
    # what the ROADMAP counts: A7 and A8 ported, these wait for A9 and A11
    assert len(NOT_PORTED) == 58, len(NOT_PORTED)
    assert len(ported) == 186, len(ported)


@pytest.mark.parametrize("name", ported_specs())
def test_forward(name):
    """The port's forward equals mxtpu's on the spec's inputs (and passes
    the spec's structural check)."""
    spec = SPECS[name]
    args = spec.args(np.random.RandomState(_seed(name)))
    got = port_run(name, args, spec.params)
    if spec.check is not None:
        spec.check(got, args)
    want = SWEEP._run(name, args, spec.params)
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        assert g.dtype.kind == w.dtype.kind, (name, i, g.dtype, w.dtype)
        np.testing.assert_allclose(
            g.astype(np.float64), w.astype(np.float64), rtol=spec.rtol,
            atol=spec.atol, err_msg="%s output %d" % (name, i))
