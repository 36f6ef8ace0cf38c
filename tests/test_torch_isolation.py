"""mxtpu_torch stands alone: no module of the package (nor chip_smoke.py
or cifar_seeds.py) imports JAX or mxtpu, and the package imports and runs with JAX made
unimportable: the kernels' plain routes, custom ops, and Module.fit with
its iterator, initializer, optimizer and scheduler, kvstore, metrics and
callback."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mxtpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "cifar_seeds.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mxtpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_mxtpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def test_scan_catches_forbidden_imports():
    for m in ("jax", "jax.numpy", "mxtpu", "mxtpu.ops.registry"):
        assert _forbidden(m)
    for m in ("mxtpu_torch", "mxtpu_torch.ops", "torch", "numpy"):
        assert not _forbidden(m)


def test_scan_covers_the_detection_slice():
    """The glob finds the modules a slice adds: the detection ops and
    pipeline here."""
    for rel in ("mxtpu_torch/ops/vision.py", "mxtpu_torch/image_detection.py"):
        assert ROOT / rel in PORT_FILES


def test_imports_and_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mxtpu'] = None\n"
        "import numpy as np, torch\n"
        "before = set(sys.modules)\n"
        "import mxtpu_torch as mt\n"
        "from mxtpu_torch.ops.rnn_scan import lstm_scan\n"
        "rng = np.random.RandomState(0)\n"
        "xp, h0, c0 = (torch.from_numpy(rng.standard_normal(s)"
        ".astype(np.float32)) for s in [(3, 2, 16), (2, 4), (2, 4)])\n"
        "wh = torch.from_numpy(rng.standard_normal((4, 16))"
        ".astype(np.float32))\n"
        "ys, hT, cT = lstm_scan(xp, h0, c0, wh)\n"
        "assert ys.shape == (3, 2, 4) and torch.isfinite(ys).all()\n"
        "import mxtpu_torch.parallel\n"
        "from mxtpu_torch.ops.flash_attention import flash_attention\n"
        "q = torch.from_numpy(rng.standard_normal((1, 2, 8, 16))"
        ".astype(np.float32)).requires_grad_()\n"
        "o = flash_attention(q, q, q, causal=True)\n"
        "o.sum().backward()\n"
        "assert o.shape == (1, 2, 8, 16) and torch.isfinite(q.grad).all()\n"
        "a = mxtpu_torch.parallel.local_attention(q, q, q, causal=True,"
        " impl='flash')\n"
        "assert torch.allclose(a, o)\n"
        "from mxtpu_torch import rtc, operator, autograd, engine\n"
        "mod = rtc.CudaModule('extern \"C\" __global__ void k(float *o) {}')\n"
        "assert mod.exports == ['k'] and mod.compiles == 0\n"
        "class Sq(operator.CustomOp):\n"
        "    def forward(self, is_train, req, in_data, out_data, aux):\n"
        "        self.assign(out_data[0], req[0], in_data[0] * in_data[0])\n"
        "    def backward(self, req, out_grad, in_data, out_data, in_grad,"
        " aux):\n"
        "        self.assign(in_grad[0], req[0],"
        " 2 * in_data[0] * out_grad[0])\n"
        "@operator.register('iso_sq')\n"
        "class SqProp(operator.CustomOpProp):\n"
        "    def create_operator(self, ctx, shapes, dtypes):\n"
        "        return Sq()\n"
        "x = mt.nd.array([1.0, -3.0], ctx=mt.cpu())\n"
        "x.attach_grad()\n"
        "with autograd.record():\n"
        "    y = mt.nd.Custom(x, op_type='iso_sq')\n"
        "y.backward()\n"
        "engine.waitall()\n"
        "assert y.asnumpy().tolist() == [1.0, 9.0]\n"
        "assert x.grad.asnumpy().tolist() == [2.0, -6.0]\n"
        "net = mt.sym.Convolution(mt.sym.var('data'), kernel=(3, 3),"
        " num_filter=2)\n"
        "net = mt.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),"
        " pool_type='max')\n"
        "net = mt.sym.FullyConnected(mt.sym.Flatten(net), num_hidden=3)\n"
        "net = mt.sym.SoftmaxOutput(net, name='softmax')\n"
        "it = mt.io.NDArrayIter(rng.standard_normal((10, 1, 6, 6))"
        ".astype(np.float32), rng.randint(0, 3, 10).astype(np.float32),"
        " 4, shuffle=True)\n"
        "mod = mt.mod.Module(net, context=mt.cpu())\n"
        "mod.fit(it, kvstore=mt.kv.create('local'), optimizer='adam',"
        " initializer=mt.init.Xavier(), eval_metric=['acc', 'ce'],"
        " num_epoch=2, batch_end_callback=mt.callback.Speedometer(4, 1),"
        " optimizer_params={'lr_scheduler':"
        " mt.lr_scheduler.FactorScheduler(2)})\n"
        "assert 0 <= dict(mod.score(it, 'acc'))['accuracy'] <= 1\n"
        "assert not [m for m in set(sys.modules) - before\n"
        "            if m.split('.')[0] in ('jax', 'jaxlib', 'mxtpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


SERVING_SLICE = ("mxtpu_torch/fault.py", "mxtpu_torch/profiler.py",
                 "mxtpu_torch/kvstore_async.py", "mxtpu_torch/obs/metrics.py",
                 "mxtpu_torch/obs/trace.py", "mxtpu_torch/serving/engine.py",
                 "mxtpu_torch/serving/batcher.py",
                 "mxtpu_torch/serving/server.py",
                 "mxtpu_torch/serving/client.py",
                 "mxtpu_torch/serving/rollout.py",
                 "mxtpu_torch/serving/__main__.py",
                 "mxtpu_torch/serving/__init__.py")


def test_scan_covers_the_serving_wire_slice():
    """The glob finds the modules of the serving replica over the wire:
    the transport, faults, metrics and traces, the server, client,
    rollout and the replica process."""
    for rel in SERVING_SLICE:
        assert ROOT / rel in PORT_FILES


def test_serves_over_the_wire_without_jax():
    """With JAX and mxtpu unimportable: a replica on the CPU, a client
    over real sockets, a published weight version followed, a traced
    request, and no JAX or mxtpu module loaded."""
    code = (
        "import sys, tempfile\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mxtpu'] = None\n"
        "import numpy as np\n"
        "before = set(sys.modules)\n"
        "import mxtpu_torch as mt\n"
        "from mxtpu_torch import kvstore_async as ka, obs, profiler\n"
        "from mxtpu_torch.serving import (InferenceEngine, ModelServer,"
        " ServingClient, WeightPublisher, WeightSync)\n"
        "ka._LOCAL_ON = False\n"
        "net = mt.sym.FullyConnected(mt.sym.var('data'), num_hidden=3,"
        " name='fc')\n"
        "p = {'fc_weight': np.ones((3, 4), 'f'),"
        " 'fc_bias': np.zeros(3, 'f')}\n"
        "eng = InferenceEngine(net, p, {}, {'data': (4,)}, buckets=(2,),"
        " ctx=mt.cpu(), warm=False)\n"
        "srv = ModelServer(eng, model_name='m').start()\n"
        "d = tempfile.mkdtemp()\n"
        "WeightPublisher(d).publish({k: v * 2 for k, v in p.items()})\n"
        "assert WeightSync(srv, weight_dir=d).catch_up() == 1\n"
        "cli = ServingClient(addrs=[srv.address])\n"
        "tok = obs.start_trace()\n"
        "out, info = cli.predict2(np.ones((1, 4), 'f'))\n"
        "obs.end_trace(tok)\n"
        "assert out[0].tolist() == [[8.0, 8.0, 8.0]], out\n"
        "assert info['version'] == 1\n"
        "assert any(e['name'] == 'serve.batch.dispatch'"
        " for e in profiler.snapshot_events())\n"
        "srv.stop()\n"
        "assert not [m for m in set(sys.modules) - before\n"
        "            if m.split('.')[0] in ('jax', 'jaxlib', 'mxtpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
