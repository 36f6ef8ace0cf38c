"""The port's RecordIO (mxtpu_torch/recordio.py) against mxtpu's, on the
CPU: files written by either package are the same bytes and are read by
the other, record for record, for MXRecordIO, MXIndexedRecordIO (its
.idx file too), pack/unpack with scalar and array labels, and
pack_img/unpack_img (PNG exact; JPEG through the same PIL encoder). A
reader pickles and reopens in both packages alike, and a torn last record
reads as the end of the file in both. Every comparison is exact: the
format is bytes.
"""
import pickle

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

PKGS = {"mxtpu": mx, "port": mt}
CROSS = [("mxtpu", "port"), ("port", "mxtpu")]


def _payloads(seed=0, n=23):
    """Records of every length modulo 4 (the frames' padding), empty
    included."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size).astype(np.uint8).tobytes()
            for size in [0, 1, 2, 3, 4, 5] + list(rng.randint(6, 3000,
                                                              n - 6))]


def _write(pkg, path, payloads):
    w = pkg.recordio.MXRecordIO(str(path), "w")
    for p in payloads:
        w.write(p)
    w.close()


def _read_all(reader):
    out = []
    while True:
        item = reader.read()
        if item is None:
            return out
        out.append(item)


@pytest.mark.parametrize("src,dst", CROSS, ids=["mxtpu_to_port",
                                                "port_to_mxtpu"])
def test_sequential_records_cross(tmp_path, src, dst):
    payloads = _payloads()
    paths = {k: tmp_path / (k + ".rec") for k in PKGS}
    for k, pkg in PKGS.items():
        _write(pkg, paths[k], payloads)
    assert paths["port"].read_bytes() == paths["mxtpu"].read_bytes()
    reader = PKGS[dst].recordio.MXRecordIO(str(paths[src]), "r")
    assert _read_all(reader) == payloads
    reader.close()


@pytest.mark.parametrize("src,dst", CROSS, ids=["mxtpu_to_port",
                                                "port_to_mxtpu"])
def test_indexed_records_cross(tmp_path, src, dst):
    payloads = _payloads(1)
    for k, pkg in PKGS.items():
        w = pkg.recordio.MXIndexedRecordIO(str(tmp_path / (k + ".idx")),
                                           str(tmp_path / (k + ".rec")), "w")
        for i, p in enumerate(payloads):
            w.write_idx(100 + 3 * i, p)
        w.close()
    for ext in (".rec", ".idx"):
        assert (tmp_path / ("port" + ext)).read_bytes() == \
            (tmp_path / ("mxtpu" + ext)).read_bytes()
    reader = PKGS[dst].recordio.MXIndexedRecordIO(
        str(tmp_path / (src + ".idx")), str(tmp_path / (src + ".rec")), "r")
    assert reader.keys == [100 + 3 * i for i in range(len(payloads))]
    order = np.random.RandomState(2).permutation(len(payloads))
    for i in order:
        assert reader.read_idx(100 + 3 * int(i)) == payloads[i]
    reader.close()


@pytest.mark.parametrize("label", [3.0, [0.25, 1.5, -2.0]],
                         ids=["scalar", "array"])
def test_pack_unpack_cross(label):
    header = (0, label, 17, 4)
    packed = {k: pkg.recordio.pack(pkg.recordio.IRHeader(*header),
                                   b"payload")
              for k, pkg in PKGS.items()}
    assert packed["port"] == packed["mxtpu"]
    for src, dst in CROSS:
        got, rest = PKGS[dst].recordio.unpack(packed[src])
        want, want_rest = PKGS[src].recordio.unpack(packed[src])
        assert rest == want_rest == b"payload"
        assert (got.flag, got.id, got.id2) == (want.flag, want.id, want.id2)
        np.testing.assert_array_equal(np.asarray(got.label),
                                      np.asarray(want.label))


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_unpack_img_cross(fmt):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (12, 9, 3)).astype(np.uint8)
    header = (0, 7.0, 5, 0)
    packed = {k: pkg.recordio.pack_img(pkg.recordio.IRHeader(*header), img,
                                       quality=95, img_fmt=fmt)
              for k, pkg in PKGS.items()}
    assert packed["port"] == packed["mxtpu"]
    for src, dst in CROSS:
        got_h, got = PKGS[dst].recordio.unpack_img(packed[src], iscolor=1)
        want_h, want = PKGS[src].recordio.unpack_img(packed[src], iscolor=1)
        assert got_h == want_h
        np.testing.assert_array_equal(got, want)
        if fmt == ".png":
            np.testing.assert_array_equal(got, img)


def test_reader_pickles_and_reopens(tmp_path):
    """A reader sent to a spawned worker: pickled open, it reopens at the
    file's start in both packages; pickled closed, it stays closed."""
    payloads = _payloads(4, 8)
    _write(mt, tmp_path / "a.rec", payloads)
    for pkg in PKGS.values():
        reader = pkg.recordio.MXRecordIO(str(tmp_path / "a.rec"), "r")
        assert reader.read() == payloads[0]
        clone = pickle.loads(pickle.dumps(reader))
        assert clone.is_open and _read_all(clone) == payloads
        reader.close()
        closed = pickle.loads(pickle.dumps(reader))
        assert not closed.is_open and closed.handle is None


def test_torn_last_record_reads_as_the_end(tmp_path):
    """A file cut inside its last frame: every whole record, then None,
    and tell() names where the whole records end, in both packages."""
    payloads = _payloads(5, 10)
    _write(mt, tmp_path / "a.rec", payloads)
    data = (tmp_path / "a.rec").read_bytes()
    (tmp_path / "a.rec").write_bytes(data[:-7])
    ends = []
    for pkg in PKGS.values():
        reader = pkg.recordio.MXRecordIO(str(tmp_path / "a.rec"), "r")
        assert _read_all(reader) == payloads[:-1]
        assert reader.read() is None
        ends.append(reader.tell())
        reader.close()
    assert ends[0] == ends[1] == len(data) - 8 - len(payloads[-1]) - \
        (-len(payloads[-1]) % 4)
