"""The port's kernel build (mxtpu_torch/_build.py), without nvcc: which
sources and C entries it knows, and that a library's name changes with
every byte a compile reads, so an edited header never loads a stale
library."""
import pytest

from mxtpu_torch import _build


def test_every_source_exists_and_declares_its_entries():
    assert set(_build.SOURCES) == set(_build._SIGNATURES)
    for name, path in _build.SOURCES.items():
        assert path.is_file() and path.parent == _build.CSRC
        text = path.read_text()
        for entry in _build._SIGNATURES[name]:
            assert 'int %s(' % entry in text


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ of one source and one header, standing in for the
    package's."""
    csrc = tmp_path / "csrc"
    (csrc / "sub").mkdir(parents=True)
    src = csrc / "k.cu"
    src.write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("#define K 1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setitem(_build.SOURCES, "k", src)
    return csrc


def test_library_path_is_stable(tree):
    assert _build.library_path("k") == _build.library_path("k")
    assert _build.library_path("k").parent == _build.build_dir()


@pytest.mark.parametrize("change", ["header_bytes", "new_header",
                                    "nested_header", "source", "flags"])
def test_library_path_changes_with_what_a_compile_reads(tree, monkeypatch,
                                                         change):
    before = _build.library_path("k")
    if change == "header_bytes":
        (tree / "k.cuh").write_text("#define K 2\n")
    elif change == "new_header":
        (tree / "extra.h").write_text("#define E 1\n")
    elif change == "nested_header":
        (tree / "sub" / "n.cuh").write_text("#define N 1\n")
    elif change == "source":
        (tree / "k.cu").write_text('#include "k.cuh"\nint x;\n')
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-DK2",))
    assert _build.library_path("k") != before


def test_non_header_files_do_not_change_the_key(tree):
    before = _build.library_path("k")
    (tree / "notes.txt").write_text("not compiled\n")
    assert _build.library_path("k") == before


@pytest.mark.parametrize("form", ["separate", "joined"])
def test_include_dirs_named_by_the_flags_are_hashed(tree, tmp_path,
                                                     monkeypatch, form):
    inc = tmp_path / "inc"
    inc.mkdir()
    (inc / "a.h").write_text("#define A 1\n")
    flags = ("-I", str(inc)) if form == "separate" else ("-I" + str(inc),)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + flags)
    assert inc in _build._header_dirs()
    before = _build.library_path("k")
    (inc / "a.h").write_text("#define A 2\n")
    assert _build.library_path("k") != before
