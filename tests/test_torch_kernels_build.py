"""The port's kernel libraries are named by what they are built from
(``mxnet_tpu_torch.kernels._lib_path``): the source, every header under
``csrc/`` and the nvcc flags.  An edit to a header a source includes must
give a new library name, or a stale library under ``_build/`` would be
loaded.  Runs on the CPU: naming a library builds nothing."""
import pytest

from mxnet_tpu_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("// v1\n")
    (tmp_path / "other.cu").write_text("// another source\n")
    monkeypatch.setattr(kernels, "_CSRC", str(tmp_path))
    return tmp_path


def test_library_name_follows_included_header(csrc):
    before = kernels._lib_path("k.cu")
    assert kernels._lib_path("k.cu") == before  # a pure function of the files
    (csrc / "helpers.cuh").write_text("// v2\n")
    changed = kernels._lib_path("k.cu")
    assert changed != before
    (csrc / "helpers.cuh").write_text("// v1\n")
    assert kernels._lib_path("k.cu") == before


@pytest.mark.parametrize("edit", ["new header", "source", "flags"])
def test_library_name_changes_with_each_input(csrc, monkeypatch, edit):
    before = kernels._lib_path("k.cu")
    if edit == "new header":
        (csrc / "more.cuh").write_text("// added\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "helpers.cuh"\n// edited\n')
    else:
        monkeypatch.setattr(kernels, "NVCC_FLAGS",
                            kernels.NVCC_FLAGS + ["-lineinfo"])
    assert kernels._lib_path("k.cu") != before


def test_library_names_differ_per_source_and_keep_the_stem(csrc):
    a, b = kernels._lib_path("k.cu"), kernels._lib_path("other.cu")
    assert a != b
    assert a.startswith(kernels._BUILD) and "libk-" in a and a.endswith(".so")
    assert "libother-" in b
