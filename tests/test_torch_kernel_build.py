"""The port's kernel build cache: a library is named by a hash of its
source and every header that source includes from ``csrc/``, so an edit
to a shared header rebuilds every kernel that includes it."""

from surreal_tpu_torch.utils import kernel_build as K


def test_scan_kernels_hash_their_shared_header():
    for name in ("gae", "vtrace"):
        assert [p.name for p in K.source_files(name)] == [f"{name}.cu", "scan_ring.cuh"]
    assert [p.name for p in K.source_files("replay_rows")] == ["replay_rows.cu"]


def test_library_name_follows_every_included_header(tmp_path, monkeypatch):
    monkeypatch.setattr(K, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\nint b;\n')
    assert [p.name for p in K.source_files("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = K.library_path("k")
    assert first == K.library_path("k")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\nint b2;\n')
    second = K.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k2;\n')
    assert K.library_path("k") not in (first, second)
