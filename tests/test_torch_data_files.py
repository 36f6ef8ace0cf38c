"""The data files on the CPU, the port against mxtpu: the CSV, MNIST and
LibSVM cases of tests/test_io.py run in both packages (LibSVM's dense
values against mxtpu's CSR batches; their CSR type waits for sparse
arrays), MNISTIter's label name, ``DataDesc.get_list`` and
``hard_reset``; ``gluon.data.RecordFileDataset``; the five
``gluon.data.vision`` datasets over files written here; the nine
transforms with numpy's and Python's generators seeded alike; and a
``DataLoader`` over ``vision.MNIST``.

Tolerances: every array is compared exactly (the same uint8 files, the
same float32 divisions and casts), except the transforms whose float32
arithmetic runs through torch in the port and XLA in mxtpu (ToTensor's
division, Normalize), held within TOL.
"""
import gzip
import pickle
import random
import struct

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _np_of(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(it):
    return [([_np_of(d) for d in b.data], [_np_of(lab) for lab in b.label],
             b.pad) for b in it]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


# -- CSVIter -------------------------------------------------------------------

@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv")
    data = np.random.RandomState(0).rand(10, 3).astype("float32")
    labels = np.arange(10).astype("float32")
    dpath, lpath = str(root / "data.csv"), str(root / "label.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, labels.reshape(-1, 1), delimiter=",")
    return dpath, lpath, data


@pytest.mark.parametrize("kw", [
    dict(data_shape=(3,), label_shape=(1,), batch_size=2),
    dict(data_shape=(3,), label_shape=(1,), batch_size=4),
    dict(data_shape=(3,), label_shape=(1,), batch_size=4,
         round_batch=False),
    dict(data_shape=(1, 3), batch_size=3, data_name="x",
         label_name="y", dtype="float64"),
    dict(data_shape=(3,), batch_size=4, no_label=True)],
    ids=["test_io", "pad", "discard", "names-dtype", "no-label"])
def test_csv_iter_matches_mxtpu(csv_files, kw):
    """tests/test_io.py's CSV case and CSVIter's options, batch for batch
    (data, label, pad) in both packages; provide_data and provide_label
    alike."""
    dpath, lpath, data = csv_files
    kw = dict(kw)
    label = None if kw.pop("no_label", False) else lpath
    its = {pkg: pkg.io.CSVIter(data_csv=dpath, label_csv=label, **kw)
           for pkg in (mt, mx)}
    for attr in ("provide_data", "provide_label"):
        assert [tuple(d[:2]) for d in getattr(its[mt], attr)] == \
            [tuple(d[:2]) for d in getattr(its[mx], attr)]
    got, want = _batches(its[mt]), _batches(its[mx])
    _same_batches(got, want)
    if kw == dict(data_shape=(3,), label_shape=(1,), batch_size=2):
        assert len(got) == 5
        np.testing.assert_allclose(got[0][0][0], data[:2], rtol=1e-5)
    its[mt].reset()
    its[mx].reset()
    _same_batches(_batches(its[mt]), _batches(its[mx]))


# -- MNISTIter -----------------------------------------------------------------

def _write_idx(path, array, magic, compress):
    opener = gzip.open if compress else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">%dI" % (array.ndim + 1), magic, *array.shape))
        f.write(array.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    """tests/test_io.py's MNIST files (50 images), plain and gzipped, and
    the test split (20 images) gzipped only."""
    root = tmp_path_factory.mktemp("mnist")
    rng = np.random.RandomState(0)
    images = (rng.rand(50, 28, 28) * 255).astype(np.uint8)
    labels = rng.randint(0, 10, size=50).astype(np.uint8)
    for gz in (False, True):
        ext = ".gz" if gz else ""
        _write_idx(str(root / ("train-images-idx3-ubyte" + ext)), images,
                   2051, gz)
        _write_idx(str(root / ("train-labels-idx1-ubyte" + ext)), labels,
                   2049, gz)
    _write_idx(str(root / "t10k-images-idx3-ubyte.gz"), images[:20], 2051,
               True)
    _write_idx(str(root / "t10k-labels-idx1-ubyte.gz"), labels[:20], 2049,
               True)
    return root, images, labels


MNIST_CASES = [dict(batch_size=10, shuffle=False),
               dict(batch_size=10, shuffle=False, flat=True),
               dict(batch_size=8, shuffle=True, seed=3),
               dict(batch_size=4, shuffle=False, part_index=1, num_parts=3),
               dict(batch_size=7, shuffle=True, gz=True)]


@pytest.mark.parametrize("kw", MNIST_CASES,
                         ids=["test_io", "flat", "shuffle-seed", "parts",
                              "gz-discard"])
def test_mnist_iter_matches_mxtpu(mnist_dir, kw):
    """tests/test_io.py's MNIST case and MNISTIter's options: data and
    label arrays equal to mxtpu's batch for batch (the last partial batch
    dropped in both); the label named softmax_label where mxtpu names it
    label."""
    root, images, _ = mnist_dir
    kw = dict(kw)
    ext = ".gz" if kw.pop("gz", False) else ""
    paths = dict(image=str(root / ("train-images-idx3-ubyte" + ext)),
                 label=str(root / ("train-labels-idx1-ubyte" + ext)))
    its = {pkg: pkg.io.MNISTIter(**paths, **kw) for pkg in (mt, mx)}
    assert [d.name for d in its[mt].provide_label] == ["softmax_label"]
    assert [d.name for d in its[mx].provide_label] == ["label"]
    assert its[mt].provide_data[0][:2] == its[mx].provide_data[0][:2]
    got, want = _batches(its[mt]), _batches(its[mx])
    _same_batches(got, want)
    if not ext and kw == MNIST_CASES[0]:
        assert len(got) == 5 and got[0][0][0].shape == (10, 1, 28, 28)
        np.testing.assert_allclose(got[0][0][0], images[:10].reshape(
            10, 1, 28, 28) / 255.0, rtol=1e-5)
    if kw.get("flat"):
        assert got[0][0][0].shape == (10, 784)


def test_mnist_iter_label_name_binds_a_module(mnist_dir):
    """A Module bound from MNISTIter's provide_label (as fit binds it)
    finds its label: the executor's softmax_label holds the batch's
    labels, where mxtpu's iterator names the label "label" and the
    Module's softmax_label stays zeros."""
    root, _, labels = mnist_dir
    it = mt.io.MNISTIter(image=str(root / "train-images-idx3-ubyte"),
                         label=str(root / "train-labels-idx1-ubyte"),
                         batch_size=10, shuffle=False, flat=True)
    with mt.cpu():
        data = mt.sym.var("data")
        net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            data, num_hidden=10, name="fc"), name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params()
        mod.forward(it.next(), is_train=True)
        bound = mod._exec_group.execs[0].arg_dict["softmax_label"].asnumpy()
    np.testing.assert_array_equal(bound, labels[:10].astype(np.float32))


def test_mnist_iter_refuses_a_wrong_file(mnist_dir):
    root, _, _ = mnist_dir
    with pytest.raises(ValueError, match="not an MNIST image file"):
        mt.io.MNISTIter(image=str(root / "train-labels-idx1-ubyte"),
                        label=str(root / "train-labels-idx1-ubyte"))


# -- LibSVMIter -----------------------------------------------------------------

LIBSVM_CASES = {
    "test_io": ("1 0:1.5 3:2.0\n0 1:0.5\n", None,
                dict(data_shape=(4,), batch_size=2)),
    "wrap": ("1 0:1.5 3:2.0\n0 1:0.5\n1 2:3.0 3:1.0\n", None,
             dict(data_shape=(4,), batch_size=2)),
    "no-round": ("1 0:1.5 3:2.0\n0 1:0.5\n1 2:3.0 3:1.0\n", None,
                 dict(data_shape=(4,), batch_size=2, round_batch=False)),
    "label-file": ("0 0:1.0\n0 1:1.0\n", "0 0:0.25 2:0.75\n0 1:1.0\n",
                   dict(data_shape=(2,), batch_size=2)),
    "label-shape": ("0 0:1.0\n0 1:1.0\n", "0 0:0.25 2:0.75\n0 1:1.0\n",
                    dict(data_shape=(2,), batch_size=1, label_shape=(4,))),
    "2-d rows": ("1 0:1.5 3:2.0\n0 1:0.5\n", None,
                 dict(data_shape=(2, 2), batch_size=2)),
}


@pytest.mark.parametrize("case", sorted(LIBSVM_CASES))
def test_libsvm_iter_matches_mxtpu(tmp_path, case):
    """tests/test_io.py's LibSVM cases (the label file, the round-batch
    wrap with its pad) and the 2-d rows, in both packages: the port's
    dense batches hold the values of mxtpu's (CSR for 1-d rows), the
    labels and pads equal, and the epoch ends where mxtpu's does."""
    data, label, kw = LIBSVM_CASES[case]
    (tmp_path / "d.libsvm").write_text(data)
    if label is not None:
        (tmp_path / "l.libsvm").write_text(label)
        kw = dict(kw, label_libsvm=str(tmp_path / "l.libsvm"))
    its = {pkg: pkg.io.LibSVMIter(data_libsvm=str(tmp_path / "d.libsvm"),
                                  **kw) for pkg in (mt, mx)}
    assert [tuple(d[:2]) for d in its[mt].provide_data] == \
        [tuple(d[:2]) for d in its[mx].provide_data]
    assert [tuple(d[:2]) for d in its[mt].provide_label] == \
        [tuple(d[:2]) for d in its[mx].provide_label]
    for _ in range(2):
        _same_batches(_batches(its[mt]), _batches(its[mx]))
        for it in its.values():
            it.reset()
    if case == "wrap":
        b = its[mt].next()
        b = its[mt].next()
        assert b.pad == 1
        np.testing.assert_array_equal(b.data[0].asnumpy()[1],
                                      [1.5, 0, 0, 2.0])


def test_libsvm_iter_checks_the_label_rows(tmp_path):
    (tmp_path / "d.libsvm").write_text("0 0:1.0\n0 1:1.0\n")
    (tmp_path / "l.libsvm").write_text("0 0:1.0\n")
    with pytest.raises(ValueError, match="has 1 rows but data file"):
        mt.io.LibSVMIter(data_libsvm=str(tmp_path / "d.libsvm"),
                         data_shape=(2,),
                         label_libsvm=str(tmp_path / "l.libsvm"))


# -- DataDesc.get_list, hard_reset --------------------------------------------

def test_get_list_and_hard_reset_match_mxtpu():
    shapes = [("data", (2, 3)), ("mask", (2,))]
    for types in (None, [("mask", np.int32), ("data", np.float16)]):
        got = mt.io.DataDesc.get_list(shapes, types)
        want = mx.io.DataDesc.get_list(shapes, types)
        assert [(d.name, d.shape, d.dtype) for d in got] == \
            [(d.name, d.shape, d.dtype) for d in want]
    with pytest.raises(KeyError):
        mt.io.DataDesc.get_list(shapes, [("data", np.float32)])
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    its = {pkg: pkg.io.NDArrayIter(data, batch_size=2,
                                   last_batch_handle="roll_over")
           for pkg in (mt, mx)}
    for it in its.values():
        list(it)
        it.hard_reset()
    _same_batches(_batches(its[mt]), _batches(its[mx]))


# -- RecordFileDataset ----------------------------------------------------------

@pytest.mark.parametrize("writer", [mt, mx], ids=["port", "mxtpu"])
def test_record_file_dataset(tmp_path, writer):
    """RecordFileDataset over a file written by either package's
    recordio: its records in the .idx order, as mxtpu's indexed reader
    reads them. (mxtpu's RecordFileDataset opens
    recordio.IndexedRecordIO, which its recordio lacks.)"""
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = writer.recordio.MXIndexedRecordIO(idx, rec, "w")
    records = {}
    for key in (3, 0, 7):
        header = writer.recordio.IRHeader(0, float(key), key, 0)
        records[key] = writer.recordio.pack(header, b"payload %d" % key)
        w.write_idx(key, records[key])
    w.close()
    ds = mt.gluon.data.RecordFileDataset(rec)
    reader = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
    assert len(ds) == 3
    assert [ds[i] for i in range(3)] == [records[k] for k in (3, 0, 7)] == \
        [reader.read_idx(k) for k in reader.keys]
    header, payload = mt.recordio.unpack(ds[2])
    assert header.label == 7.0 and payload == b"payload 7"


# -- gluon.data.vision datasets --------------------------------------------------

@pytest.fixture(scope="module")
def vision_root(tmp_path_factory, mnist_dir):
    """MNIST's files (from mnist_dir), CIFAR-10's and CIFAR-100's pickles,
    and an image folder, written here."""
    root = tmp_path_factory.mktemp("vision")
    rng = np.random.RandomState(1)
    c10 = root / "cifar10" / "cifar-10-batches-py"
    c10.mkdir(parents=True)
    for name, n in [("data_batch_%d" % i, 4) for i in range(1, 6)] + \
            [("test_batch", 6)]:
        with open(c10 / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072)).astype(
                np.uint8), "labels": rng.randint(0, 10, n).tolist()}, f)
    c100 = root / "cifar100" / "cifar-100-python"
    c100.mkdir(parents=True)
    for name, n in (("train", 5), ("test", 3)):
        with open(c100 / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072)).astype(
                np.uint8), "fine_labels": rng.randint(0, 100, n).tolist(),
                "coarse_labels": rng.randint(0, 20, n).tolist()}, f)
    from PIL import Image
    for cls in ("cat", "dog"):
        (root / "folder" / cls).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.randint(0, 256, (9, 7, 3)).astype(
                np.uint8)).save(root / "folder" / cls / ("%d.png" % i))
    (root / "folder" / "notes.txt").write_text("not a class")
    return root, mnist_dir[0]


DATASETS = {
    "MNIST": lambda pkg, root, mnist: pkg.gluon.data.vision.MNIST(
        str(mnist), train=True),
    "MNIST test": lambda pkg, root, mnist: pkg.gluon.data.vision.MNIST(
        str(mnist), train=False),
    "FashionMNIST": lambda pkg, root, mnist:
        pkg.gluon.data.vision.FashionMNIST(str(mnist), train=False),
    "CIFAR10": lambda pkg, root, mnist: pkg.gluon.data.vision.CIFAR10(
        str(root / "cifar10"), train=True),
    "CIFAR10 test": lambda pkg, root, mnist: pkg.gluon.data.vision.CIFAR10(
        str(root / "cifar10"), train=False),
    "CIFAR100": lambda pkg, root, mnist: pkg.gluon.data.vision.CIFAR100(
        str(root / "cifar100"), train=True),
    "CIFAR100 fine": lambda pkg, root, mnist:
        pkg.gluon.data.vision.CIFAR100(str(root / "cifar100"),
                                       fine_label=True, train=False),
    "ImageFolderDataset": lambda pkg, root, mnist:
        pkg.gluon.data.vision.ImageFolderDataset(str(root / "folder")),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_vision_dataset_matches_mxtpu(vision_root, name):
    """Each dataset over the files written here: its length and every
    sample (image values, shape, dtype; label) as mxtpu's, each image on
    the host in the port."""
    root, mnist = vision_root
    got = DATASETS[name](mt, root, mnist)
    want = DATASETS[name](mx, root, mnist)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        (gi, gl), (wi, wl) = got[i], want[i]
        assert gi.context == mt.cpu()
        assert gi.asnumpy().dtype == wi.asnumpy().dtype
        np.testing.assert_array_equal(gi.asnumpy(), wi.asnumpy())
        assert gl == wl and np.asarray(gl).dtype == np.asarray(wl).dtype
    if name == "ImageFolderDataset":
        assert got.synsets == want.synsets == ["cat", "dog"]


def test_vision_dataset_without_files_raises(tmp_path):
    for make in (lambda: mt.gluon.data.vision.MNIST(str(tmp_path)),
                 lambda: mt.gluon.data.vision.CIFAR10(str(tmp_path)),
                 lambda: mt.gluon.data.vision.CIFAR100(str(tmp_path))):
        with pytest.raises(IOError, match="downloads are disabled"):
            make()


# -- transforms ------------------------------------------------------------------

def _image(shape=(12, 10, 3), seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


TRANSFORMS = {
    "Cast": (lambda T: T.Cast("float16"), (12, 10, 3)),
    "ToTensor": (lambda T: T.ToTensor(), (12, 10, 3)),
    "ToTensor batch": (lambda T: T.ToTensor(), (2, 12, 10, 3)),
    "Normalize": (lambda T: T.Compose([
        T.ToTensor(), T.Normalize((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))]),
        (12, 10, 3)),
    "Normalize batch": (lambda T: T.Compose([
        T.ToTensor(), T.Normalize(0.13, 0.31)]), (2, 12, 10, 1)),
    "Resize": (lambda T: T.Resize((7, 5)), (12, 10, 3)),
    "Resize keep_ratio": (lambda T: T.Resize((7, 7), keep_ratio=True),
                          (12, 10, 3)),
    "Resize grey": (lambda T: T.Resize(6), (12, 10, 1)),
    "CenterCrop": (lambda T: T.CenterCrop((6, 4)), (12, 10, 3)),
    "CenterCrop up": (lambda T: T.CenterCrop(14), (12, 10, 3)),
    "RandomResizedCrop": (lambda T: T.RandomResizedCrop(8), (12, 10, 3)),
    "RandomFlipLeftRight": (lambda T: T.RandomFlipLeftRight(), (12, 10, 3)),
    "RandomFlipTopBottom": (lambda T: T.RandomFlipTopBottom(), (12, 10, 3)),
    "Compose": (lambda T: T.Compose([
        T.RandomResizedCrop(8, scale=(0.5, 1.0)), T.RandomFlipLeftRight(),
        T.ToTensor(), T.Normalize(0.5, 0.25)]), (12, 10, 3)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_mxtpu(name):
    """Each transform on the same image, five draws in a row, with
    numpy's and Python's generators seeded alike: the port's output on
    the host equal to mxtpu's (TOL where float32 arithmetic runs)."""
    make, shape = TRANSFORMS[name]
    outs = {}
    for pkg in (mt, mx):
        t = make(pkg.gluon.data.vision.transforms)
        np.random.seed(4)
        random.seed(4)
        outs[pkg] = []
        for i in range(5):
            x = _image(shape, i)
            src = pkg.nd.array(x, ctx=pkg.cpu()) if pkg is mt \
                else pkg.nd.array(x)
            y = t(src)
            if pkg is mt:
                assert y.context == mt.cpu()
            outs[pkg].append(y.asnumpy())
    for g, w in zip(outs[mt], outs[mx]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), **TOL)


def test_data_loader_over_mnist_matches_mxtpu(vision_root):
    """A DataLoader (shuffled, no workers) over vision.MNIST with
    transform_first(ToTensor, Normalize): every batch as mxtpu's under
    one np.random.seed; the port's samples stay on the host and its
    batches are stacked there (on the CPU context)."""
    _, mnist = vision_root
    batches = {}
    for pkg in (mt, mx):
        T = pkg.gluon.data.vision.transforms
        ds = pkg.gluon.data.vision.MNIST(str(mnist)).transform_first(
            T.Compose([T.ToTensor(), T.Normalize(0.13, 0.31)]))
        np.random.seed(0)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=16, shuffle=True,
                                           last_batch="keep")
        with pkg.cpu():
            batches[pkg] = [(x.asnumpy(), y.asnumpy()) for x, y in loader]
    assert len(batches[mt]) == len(batches[mx]) == 4
    for (gx, gy), (wx, wy) in zip(batches[mt], batches[mx]):
        np.testing.assert_allclose(gx, wx, **TOL)
        assert gy.dtype == wy.dtype
        np.testing.assert_array_equal(gy, wy)
