"""Inception-BN (example/image-classification/symbols/inception_bn.py on
its 224 path) through chip_smoke.py's ``imagenet_fit`` in the port against
mxtpu, eager and fused, one step from the same weights: the check and
the tolerances of tests/test_torch_resnet.py, in a file of its own so
that each file stays near a minute on one worker (mxtpu compiles the
network's step for about 20 s).
"""
import importlib.util
import pathlib

import pytest

from test_torch_resnet import check_fit
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", ["eager", "fused"])
def test_inception_bn_fit_matches_mxtpu(smoke, path):
    check_fit(smoke, "inception_bn", path)
