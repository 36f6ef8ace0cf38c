"""mxtpu's own NDArray and autograd suites (``tests/test_ndarray.py``,
``tests/test_autograd.py``) run against the port.

Each file is loaded as a module with ``mxtpu`` and its submodules
(``mxtpu.ndarray``, ``mxtpu.autograd``) aliased in ``sys.modules`` to the
port's, and each of its cases runs with the same aliases (a case may
``import mxtpu`` inside) under ``with cpu():`` (the port's default
context is the card). ``sys.modules`` is restored after each load and
each case: under ``--dist loadfile`` other files share the worker.
Every case passes; none is listed as a documented difference.
"""
import contextlib
import importlib.util
import inspect
import pathlib
import sys

import pytest

import mxtpu_torch
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SUITES = ("test_ndarray", "test_autograd")
ALIASES = {"mxtpu": mxtpu_torch, "mxtpu.ndarray": mxtpu_torch.ndarray,
           "mxtpu.autograd": mxtpu_torch.autograd,
           "mxtpu.symbol": mxtpu_torch.symbol,
           "mxtpu.random": mxtpu_torch.random}


@contextlib.contextmanager
def as_mxtpu():
    """``import mxtpu`` (and its submodules above) gives the port, until
    the block ends."""
    saved = {name: sys.modules.get(name) for name in ALIASES}
    sys.modules.update(ALIASES)
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def load_suite(name):
    with as_mxtpu():
        spec = importlib.util.spec_from_file_location(
            "port_" + name, str(ROOT / "tests" / (name + ".py")))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


MODULES = {name: load_suite(name) for name in SUITES}
CASES = [(suite, case) for suite, mod in MODULES.items()
         for case in sorted(dir(mod)) if case.startswith("test_")
         and callable(getattr(mod, case))]


def test_the_suites_are_whole():
    """11 cases a suite, the port's module behind every alias."""
    assert sorted(sum(1 for s, _c in CASES if s == suite)
                  for suite in SUITES) == [11, 11]
    for mod in MODULES.values():
        assert mod.mx is mxtpu_torch and mod.nd is mxtpu_torch.ndarray
    assert sys.modules.get("mxtpu") is not mxtpu_torch


@pytest.mark.parametrize("suite, case", CASES)
def test_case(suite, case, tmp_path):
    fn = getattr(MODULES[suite], case)
    kwargs = {"tmp_path": tmp_path} \
        if "tmp_path" in inspect.signature(fn).parameters else {}
    with as_mxtpu(), mxtpu_torch.cpu():
        fn(**kwargs)
