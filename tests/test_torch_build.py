"""The port's kernel build cache (``repro_torch.kernels._build``) without
``nvcc``: a library's file name follows its source, the headers beside it
and the flags, so that an edit to a shared header rebuilds every kernel
that includes it."""
from repro_torch.kernels import _build


def test_library_path_follows_the_headers_of_its_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, header = csrc / "k.cu", csrc / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("// v1\n")
    (tmp_path / "notes.cuh").write_text("// outside csrc\n")
    monkeypatch.setitem(_build.SOURCES, "k", src)
    first = _build.library_path("k")
    assert first == _build.library_path("k")          # unchanged: reused
    (tmp_path / "notes.cuh").write_text("// edited, but not beside the source\n")
    assert _build.library_path("k") == first
    header.write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first and second.parent == first.parent
    (csrc / "other.cuh").write_text("// a new header\n")
    assert _build.library_path("k") not in (first, second)
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path("k") != second


def test_every_kernel_source_exists_and_is_hashed_with_its_headers():
    for name, src in _build.SOURCES.items():
        assert src.exists(), name
        assert _build.library_path(name).name.startswith(f"{name}-")
    fa = _build.SOURCES["flash_attention"].parent
    assert (fa / "sm90.cuh").exists()
    assert _build.SOURCES["flash_attention_bwd"].parent == fa
