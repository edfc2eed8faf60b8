"""The port's build cache (runtime/cache.py over ops/_build.py's
directory of nvcc-built libraries), mirroring ``tests/test_cache.py`` on
the CPU.

The entries are opaque bytes to these tools, so the archive mechanics
(manifest fingerprint, safety checks, merge semantics) are tested on fake
libraries.  One more test holds ``_build`` and the cache tools to one
directory, ``BM25_TPU_TORCH_BUILD_DIR``, and a fresh process pointed at an
imported directory loads the library it finds there without nvcc.
"""

import io
import json
import os
import subprocess
import sys
import tarfile

import pytest

from bm25_tpu.runtime import cache as jax_cc
from bm25_tpu_torch.cli.main import main
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.runtime import cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_cache(tmp_path, n=3):
    d = tmp_path / "cache"
    d.mkdir()
    for i in range(n):
        (d / f"libkernel_{i}-deadbeef{i}.so").write_bytes(b"x" * (100 + i))
    return str(d)


def test_info_missing_dir(tmp_path):
    info = cc.cache_info(str(tmp_path / "nope"))
    assert info == jax_cc.cache_info(str(tmp_path / "nope"))
    assert info["exists"] is False and info["entries"] == 0


def test_export_import_roundtrip(tmp_path):
    src = _fake_cache(tmp_path)
    assert cc.cache_info(src) == jax_cc.cache_info(src)
    archive = str(tmp_path / "cache.tar.gz")
    out = cc.export_cache(archive, path=src)
    assert out["entries"] == 3
    assert os.path.getsize(archive) > 0
    # the manifest records this host's fingerprint: torch always, the
    # nvcc / driver / device fields where they can be probed
    fp = out["manifest"]["fingerprint"]
    assert sorted(fp) == sorted(cc.FINGERPRINT_KEYS)
    assert fp["torch"] is not None

    dest = str(tmp_path / "dest")
    res = cc.import_cache(archive, path=dest)
    assert res["imported"] == 3 and res["mismatches"] == []
    assert sorted(os.listdir(dest)) == sorted(os.listdir(src))
    for name in os.listdir(src):
        assert (
            open(os.path.join(dest, name), "rb").read()
            == open(os.path.join(src, name), "rb").read()
        )


def test_export_missing_or_empty(tmp_path):
    with pytest.raises(FileNotFoundError):
        cc.export_cache(str(tmp_path / "a.tar.gz"), path=str(tmp_path / "no"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no entries"):
        cc.export_cache(str(tmp_path / "a.tar.gz"), path=str(empty))


def _doctor(archive: str, doctored: str, **fields) -> None:
    """Copy ``archive`` with its manifest's fingerprint fields replaced."""
    with tarfile.open(archive, "r:gz") as tar, \
            tarfile.open(doctored, "w:gz") as out:
        for m in tar.getmembers():
            data = tar.extractfile(m).read()
            if m.name == cc.MANIFEST_NAME:
                manifest = json.loads(data)
                manifest["fingerprint"].update(fields)
                data = json.dumps(manifest).encode()
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            out.addfile(info, io.BytesIO(data))


def test_import_fingerprint_mismatch_refused(tmp_path, monkeypatch):
    # both sides patched: an H100 host exported, another card imports
    host = {"nvcc": "12.8 V12.8.93", "torch": "2.11.0+cu128",
            "torch_cuda": "12.8", "driver": "570.00",
            "device_name": "NVIDIA H100 80GB HBM3", "sm": "sm_90"}
    monkeypatch.setattr(cc, "environment_fingerprint", lambda: dict(host))
    src = _fake_cache(tmp_path)
    archive = str(tmp_path / "cache.tar.gz")
    cc.export_cache(archive, path=src)
    doctored = str(tmp_path / "doctored.tar.gz")
    _doctor(archive, doctored, sm="sm_100", device_name="NVIDIA B200")

    dest = str(tmp_path / "dest")
    with pytest.raises(ValueError, match="different environment"):
        cc.import_cache(doctored, path=dest)
    assert not os.path.isdir(dest) or os.listdir(dest) == []

    # --force imports anyway and reports what mismatched
    res = cc.import_cache(doctored, path=dest, force=True)
    assert res["imported"] == 3
    assert any(m.startswith("sm:") for m in res["mismatches"])
    assert any("device_name" in m for m in res["mismatches"])

    # a field either side could not probe (None) is skipped
    monkeypatch.setattr(cc, "environment_fingerprint",
                        lambda: {**host, "sm": None, "device_name": None})
    res = cc.import_cache(doctored, path=str(tmp_path / "dest2"))
    assert res["imported"] == 3 and res["mismatches"] == []

    # the same refusal through the CLI, and --force
    monkeypatch.setattr(cc, "environment_fingerprint", lambda: dict(host))
    assert main(["cache", "import", doctored, "--dir",
                 str(tmp_path / "dest3")]) == 2
    assert main(["cache", "import", doctored, "--dir",
                 str(tmp_path / "dest3"), "--force"]) == 0


def test_import_rejects_path_traversal(tmp_path):
    evil = str(tmp_path / "evil.tar.gz")
    with tarfile.open(evil, "w:gz") as tar:
        data = b"pwned"
        info = tarfile.TarInfo("../escape.bin")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    with pytest.raises(ValueError, match="unsafe path"):
        cc.import_cache(evil, path=str(tmp_path / "dest"))
    assert not (tmp_path / "escape.bin").exists()


def test_import_rejects_links(tmp_path):
    evil = str(tmp_path / "link.tar.gz")
    with tarfile.open(evil, "w:gz") as tar:
        info = tarfile.TarInfo("entry")
        info.type = tarfile.SYMTYPE
        info.linkname = "/etc/passwd"
        tar.addfile(info)
    with pytest.raises(ValueError, match="non-file"):
        cc.import_cache(evil, path=str(tmp_path / "dest"))


def test_import_merges_into_existing(tmp_path):
    src = _fake_cache(tmp_path)
    archive = str(tmp_path / "cache.tar.gz")
    cc.export_cache(archive, path=src)
    dest = tmp_path / "dest"
    dest.mkdir()
    (dest / "preexisting-entry").write_bytes(b"keep me")
    res = cc.import_cache(archive, path=str(dest))
    assert res["imported"] == 3
    assert (dest / "preexisting-entry").read_bytes() == b"keep me"
    assert len(os.listdir(dest)) == 4


def test_cli_surface(tmp_path, capsys):
    src = _fake_cache(tmp_path)
    archive = str(tmp_path / "c.tar.gz")

    assert main(["cache", "info", "--dir", src]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["entries"] == 3

    assert main(["cache", "export", archive, "--dir", src]) == 0
    capsys.readouterr()

    dest = str(tmp_path / "dest")
    assert main(["cache", "import", archive, "--dir", dest]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["imported"] == 3

    # missing archive argument
    assert main(["cache", "export", "--dir", src]) == 2
    # export of a missing dir fails cleanly
    assert main(["cache", "export", archive,
                 "--dir", str(tmp_path / "absent")]) == 2
    # a corrupt archive fails cleanly
    bad = tmp_path / "bad.tar.gz"
    bad.write_bytes(b"not a gzip")
    assert main(["cache", "import", str(bad), "--dir", dest]) == 2


def test_build_dir_follows_the_environment(tmp_path, monkeypatch):
    """``_build`` and the cache tools read one directory:
    ``BM25_TPU_TORCH_BUILD_DIR``, else the package's ``_build/``; a
    library found there is used as it is (no nvcc runs), also by a fresh
    process pointed at a directory filled by ``cache import``."""
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert _build.build_dir() == _build.BUILD_DIR == cc.resolve_cache_dir()
    assert os.path.dirname(_build.library_path("topk")) == _build.BUILD_DIR
    built = tmp_path / "built"
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(built))
    assert _build.build_dir() == cc.resolve_cache_dir() == str(built)
    assert cc.resolve_cache_dir(str(tmp_path / "x")) == str(tmp_path / "x")
    lib = _build.library_path("ell_score")
    assert os.path.dirname(lib) == str(built)
    built.mkdir()
    with open(lib, "wb") as f:
        f.write(b"\x7fELF not really")
    with monkeypatch.context() as m:
        m.setattr(_build, "find_nvcc", lambda: pytest.fail("nvcc ran"))
        assert _build.build("ell_score") == lib
    assert cc.cache_info()["entries"] == 1

    archive = str(tmp_path / "c.tar.gz")
    assert main(["cache", "export", archive]) == 0
    imported = tmp_path / "imported"
    assert main(["cache", "import", archive, "--dir", str(imported)]) == 0
    env = {**os.environ, _build.BUILD_DIR_ENV: str(imported),
           "PYTHONPATH": REPO}
    res = subprocess.run(
        [sys.executable, "-c", "from bm25_tpu_torch.ops import _build; "
         "print(_build.build('ell_score'))"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == str(imported / os.path.basename(lib))


def test_native_library_travels_with_the_cache(tmp_path, monkeypatch):
    """The native text library lies in the build directory beside the
    kernels, so ``cache export`` / ``import`` carry it; the fingerprint
    names the C++ compiler, and an archive from another compiler is
    refused; a fresh process pointed at the imported directory loads the
    library without a compiler."""
    from bm25_tpu_torch.native import _build as native_build
    from bm25_tpu_torch.native import loader

    with open(loader.get().path, "rb") as f:  # the library, built once
        so = f.read()
    built = tmp_path / "built"
    built.mkdir()
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(built))
    lib = native_build.library_path()
    assert os.path.dirname(lib) == str(built)
    (built / os.path.basename(lib)).write_bytes(so)
    (built / "libtopk-0123456789abcdef.so").write_bytes(b"kernel")
    archive = str(tmp_path / "c.tar.gz")
    out = cc.export_cache(archive)
    assert out["entries"] == 2
    cxx = out["manifest"]["fingerprint"]["cxx"]
    assert cxx and cxx == subprocess.run(
        [native_build.find_cxx(), "--version"], capture_output=True,
        text=True).stdout.splitlines()[0]

    doctored = str(tmp_path / "doctored.tar.gz")
    _doctor(archive, doctored, cxx="clang version 99.0.0")
    with pytest.raises(ValueError, match="cxx: archive='clang"):
        cc.import_cache(doctored, path=str(tmp_path / "refused"))

    imported = tmp_path / "imported"
    assert main(["cache", "import", archive, "--dir", str(imported)]) == 0
    assert sorted(os.listdir(imported)) == sorted(os.listdir(built))
    env = {**os.environ, _build.BUILD_DIR_ENV: str(imported),
           "CXX": str(tmp_path / "no-such-compiler"), "PYTHONPATH": REPO}
    res = subprocess.run(
        [sys.executable, "-c", "from bm25_tpu_torch.native import loader; "
         "p = loader.get(); print(p.path, p.stem('Running'))"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == [str(imported / os.path.basename(lib)),
                                  "run"]


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: counts its runs, takes a while, writes its -o target
echo run >> "$(dirname "$0")/runs"
sleep 0.3
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then printf 'lib' > "$2"; fi
  shift
done
echo "ptxas info: 0 bytes spill stores"
"""


def test_concurrent_kernel_builds_compile_once(tmp_path, monkeypatch):
    """Threads that build one kernel library at once share the build
    protocol of the native library (``_build._compile``): one compiler
    run under the library's lock, one file renamed into place, its log
    beside it, and no lock among the cache's entries."""
    from concurrent.futures import ThreadPoolExecutor

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "build"))
    with _build.collect_phases() as ph, ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(_build.build, ["topk"] * 4))
    assert len(set(paths)) == 1 and paths[0] == _build.library_path("topk")
    assert (tmp_path / "bin" / "runs").read_text().splitlines() == ["run"]
    assert ph["nvcc_build_s"] >= 0.3
    with open(paths[0], "rb") as f:
        assert f.read() == b"lib"
    name = os.path.basename(paths[0])
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [name, name + ".lock", name[:-3] + ".log"])
    assert cc.cache_info()["entries"] == 2
