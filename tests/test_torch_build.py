"""The port's kernel build names each library by a hash of its source, of
the headers the source includes by a quoted name, and of the flags, so an
edited header builds anew instead of loading a stale library. CPU only:
nothing is compiled here."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path):
    out = tmp_path / "csrc"
    shutil.copytree(build.CSRC, out)
    return out


@pytest.mark.parametrize("name", ["flash_attention", "dpa_matmul"])
def test_sources_name_the_shared_header(name):
    assert [p.name for p in build.sources(build.CSRC / f"{name}.cu")] == [
        f"{name}.cu", "sm90.cuh"]


def test_stream_has_no_local_header():
    assert build.sources(build.CSRC / "stream.cu") == [
        build.CSRC / "stream.cu"]


@pytest.mark.parametrize("name", ["flash_attention", "dpa_matmul"])
def test_header_edit_changes_the_library_path(csrc, name):
    before = build.library_path(name, csrc)
    assert before == build.library_path(name, build.CSRC)
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(name, csrc)
    assert after != before and after.name.startswith(f"lib{name}-")


def test_only_included_files_change_the_library_path(csrc):
    before = build.library_path("stream", csrc)
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    (csrc / "unrelated.cuh").write_text("// not included\n")
    assert build.library_path("stream", csrc) == before
    src = csrc / "stream.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("stream", csrc) != before


def test_nested_and_repeated_includes_are_hashed_once(tmp_path):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include "c.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// leaf\n")
    assert [p.name for p in build.sources(tmp_path / "a.cu")] == [
        "a.cu", "b.cuh", "c.cuh"]
    before = build.library_path("a", tmp_path)
    (tmp_path / "c.cuh").write_text("// leaf, edited\n")
    assert build.library_path("a", tmp_path) != before
