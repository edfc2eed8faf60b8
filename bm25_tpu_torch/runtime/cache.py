"""Build-cache lifecycle: inspect, export, import.

The port's copy of ``bm25_tpu/runtime/cache.py``.  The JAX package ships
its persistent XLA compile cache; the port has no compile step of its
own, and its counterpart is the directory of nvcc-built kernel libraries
(``ops/_build.py``: ``$BM25_TPU_TORCH_BUILD_DIR``, else
``bm25_tpu_torch/_build/``), which also holds the C++-built native text
library (``native/_build.py``).  A fresh serving machine pays nvcc for
every kernel library the served path loads, and the C++ compiler for the
text library, tens of seconds, all of it avoidable where another host of
the same environment already built them.

- ``bm25-tpu-torch warm`` on a build host fills the directory,
- ``export_cache`` tars it with an environment manifest,
- ``import_cache`` on the serving host validates the manifest and
  unpacks.  A library's file name hashes its sources and the flags, not
  the nvcc, C++ compiler, driver or card that built it: a foreign archive
  would load where it should not, so a mismatch is refused with a reason
  unless ``force``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import tarfile
import tempfile

MANIFEST_NAME = "__bm25_cache_manifest__.json"
FINGERPRINT_KEYS = ("nvcc", "cxx", "torch", "torch_cuda", "driver",
                    "device_name", "sm")


def resolve_cache_dir(path: str | None = None) -> str:
    """The build directory these tools operate on.

    Precedence: explicit argument > ``BM25_TPU_TORCH_BUILD_DIR`` > the
    package's ``_build/``: the directory ``ops/_build.py`` builds into and
    loads from.  Never initializes a device.
    """
    if path:
        return path
    from bm25_tpu_torch.ops import _build

    return _build.build_dir()


def _entry_names(cache_dir: str) -> list[str]:
    """Cache entry files, relative paths, manifest and build locks
    (``<library>.lock``, ``ops/_build.py::_compile``) excluded."""
    names: list[str] = []
    for root, _dirs, files in os.walk(cache_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), cache_dir)
            if rel != MANIFEST_NAME and not rel.endswith(".lock"):
                names.append(rel)
    return sorted(names)


def _run(cmd: list[str]) -> str | None:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout if res.returncode == 0 else None


def environment_fingerprint() -> dict:
    """The facts that decide whether the cached libraries fit this host:
    nvcc's release, the C++ compiler's ``--version`` line (the native
    text library's), ``torch.__version__`` and ``torch.version.cuda``, the
    driver's version, the device's name and its ``sm_XY``.  A field that
    cannot be probed (no nvcc, no C++ compiler, no GPU) is None, and
    import-side validation skips it."""
    import torch

    from bm25_tpu_torch.native import _build as native_build
    from bm25_tpu_torch.ops import _build

    fp: dict = dict.fromkeys(FINGERPRINT_KEYS)
    fp["torch"] = torch.__version__
    fp["torch_cuda"] = torch.version.cuda
    try:
        out = _run([_build.find_nvcc(), "--version"])
    except RuntimeError:
        out = None
    m = re.search(r"release (\S+), (V\S+)", out or "")
    if m:
        fp["nvcc"] = f"{m.group(1).rstrip(',')} {m.group(2)}"
    try:
        out = _run([native_build.find_cxx(), "--version"])
    except RuntimeError:
        out = None
    if out and out.strip():
        fp["cxx"] = out.strip().splitlines()[0]
    if torch.cuda.is_available():
        fp["device_name"] = torch.cuda.get_device_name(0)
        major, minor = torch.cuda.get_device_capability(0)
        fp["sm"] = f"sm_{major}{minor}"
        out = _run(["nvidia-smi", "--query-gpu=driver_version",
                    "--format=csv,noheader"])
        if out and out.strip():
            fp["driver"] = out.strip().splitlines()[0]
    return fp


def cache_info(path: str | None = None) -> dict:
    cache_dir = resolve_cache_dir(path)
    if not os.path.isdir(cache_dir):
        return {"path": cache_dir, "exists": False, "entries": 0, "bytes": 0}
    names = _entry_names(cache_dir)
    total = sum(
        os.path.getsize(os.path.join(cache_dir, n))
        for n in names
        if os.path.isfile(os.path.join(cache_dir, n))
    )
    return {"path": cache_dir, "exists": True, "entries": len(names),
            "bytes": total}


def export_cache(dest: str, path: str | None = None) -> dict:
    """Tar the build directory with an environment manifest -> ``dest``
    (.tar.gz).

    Raises ``FileNotFoundError`` on a missing dir and ``ValueError`` on an
    empty one — exporting zero entries is always a deploy-pipeline bug
    (warm didn't run, or ran against a different directory).
    """
    cache_dir = resolve_cache_dir(path)
    if not os.path.isdir(cache_dir):
        raise FileNotFoundError(
            f"build cache dir does not exist: {cache_dir} "
            f"(run `bm25-tpu-torch warm` first)"
        )
    names = _entry_names(cache_dir)
    if not names:
        raise ValueError(
            f"build cache at {cache_dir} has no entries; "
            f"run `bm25-tpu-torch warm` against the deploy engine first"
        )
    manifest = {
        "format": 1,
        "entries": len(names),
        "fingerprint": environment_fingerprint(),
    }
    # write to a temp file in the destination directory and rename, so a
    # crashed export can't leave a truncated archive that a later deploy
    # step trusts
    dest_dir = os.path.dirname(os.path.abspath(dest)) or "."
    os.makedirs(dest_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dest_dir, suffix=".partial")
    os.close(fd)
    try:
        with tarfile.open(tmp, "w:gz") as tar:
            mf = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
            try:
                json.dump(manifest, mf)
                mf.close()
                tar.add(mf.name, arcname=MANIFEST_NAME)
            finally:
                os.unlink(mf.name)
            for n in names:
                tar.add(os.path.join(cache_dir, n), arcname=n)
        os.replace(tmp, dest)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return {"dest": dest, "entries": len(names),
            "bytes": os.path.getsize(dest), "manifest": manifest}


def _safe_members(tar: tarfile.TarFile) -> list[tarfile.TarInfo]:
    """Regular files with normalized relative paths only.

    An archive is deploy-pipeline input, not trusted input: refuse
    absolute paths, parent escapes, and links outright.
    """
    members = []
    for m in tar.getmembers():
        name = m.name
        if not m.isfile():
            if m.isdir():
                continue  # directories are re-created implicitly
            raise ValueError(f"refusing non-file member in archive: {name!r}")
        norm = os.path.normpath(name)
        if norm.startswith(("/", "..")) or os.path.isabs(norm):
            raise ValueError(f"refusing unsafe path in archive: {name!r}")
        members.append(m)
    return members


def import_cache(src: str, path: str | None = None,
                 force: bool = False) -> dict:
    """Unpack an exported archive into the local build directory.

    Validates the manifest fingerprint against this host: a library built
    by another nvcc or C++ compiler, for another driver or another sm
    would load here under the same name, so a mismatch raises (``force=True`` imports
    anyway and reports the mismatches).  Fingerprint fields that are
    None on either side are skipped: a host without nvcc or a GPU cannot
    probe them.
    """
    cache_dir = resolve_cache_dir(path)
    with tarfile.open(src, "r:gz") as tar:
        members = _safe_members(tar)
        manifest = None
        rest = []
        for m in members:
            if m.name == MANIFEST_NAME:
                f = tar.extractfile(m)
                manifest = json.load(f) if f is not None else None
            else:
                rest.append(m)
        mismatches: list[str] = []
        if manifest is not None:
            theirs = manifest.get("fingerprint", {})
            ours = environment_fingerprint()
            for key in FINGERPRINT_KEYS:
                a, b = theirs.get(key), ours.get(key)
                if a is not None and b is not None and a != b:
                    mismatches.append(f"{key}: archive={a!r} host={b!r}")
        if mismatches and not force:
            raise ValueError(
                "cache archive was built for a different environment "
                "(its libraries may not fit this host): "
                + "; ".join(mismatches) + ". Pass --force to import anyway."
            )
        os.makedirs(cache_dir, exist_ok=True)
        for m in rest:
            # belt and braces on top of _safe_members: the stdlib 'data'
            # filter also strips mode bits/ownership and re-checks paths
            tar.extract(m, cache_dir, filter="data")
    return {
        "path": cache_dir,
        "imported": len(rest),
        "mismatches": mismatches,
        "manifest": manifest,
    }
