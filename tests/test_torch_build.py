"""``ops/kernels/_build.py``: the name of the built library follows every
source and header under ``csrc/``, so an edited header rebuilds.  Runs on a
temporary copy of ``csrc``, never on the repository's files."""

import shutil

import pytest

from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_headers_are_listed():
    assert [p.name for p in _build._headers()] == ["corr_tile.cuh"]
    assert all(p.suffix == ".cu" for p in _build._sources())


@pytest.mark.parametrize("name", ["corr_tile.cuh", "corr_rows.cu",
                                  "subsel_gather.cu"])
def test_an_edit_changes_the_hash(csrc, name):
    before = _build.source_hash()
    assert _build.source_hash() == before
    path = csrc / name
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.source_hash() != before


def test_other_files_leave_the_hash(csrc):
    before = _build.source_hash()
    (csrc / "notes.txt").write_text("not a source")
    assert _build.source_hash() == before


def test_a_new_header_changes_the_hash(csrc):
    before = _build.source_hash()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.source_hash() != before
