"""The port's kernel build (``repro_torch.kernels._build``) on the CPU:
its cache key covers every source, its flags and the headers the sources
share, so an edit to any of them never loads a stale build. No compiler
is needed: only the key is computed here."""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "build"))
    return copy


def test_sources_include_a_shared_header():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert headers
    for name in ("flash_attention", "rwkv6_scan"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert any(f'#include "{h}"' in text for h in headers)


@pytest.mark.parametrize("edit", ["header", "source", "new header"])
def test_build_key_follows_every_input(csrc, edit):
    before = _build.build_dir()
    assert before == _build.build_dir()
    if edit == "header":
        path = sorted(csrc.glob("*.cuh"))[0]
        path.write_text(path.read_text() + "\n// edited\n")
    elif edit == "source":
        path = csrc / "rwkv6_scan.cu"
        path.write_text(path.read_text() + "\n// edited\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.build_dir() != before
