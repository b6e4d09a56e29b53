"""The port's copies of ``utils/checks.py`` and ``utils/download.py`` against
the JAX package's, offline: ``file://`` URLs and local archives only.

Each copy is the JAX module's text below its docstring, with the package's
name in its imports; the same calls give the same files, progress, errors
and answers in both packages.
"""

from __future__ import annotations

import ast
import re
import sys
import tarfile
import zipfile
from pathlib import Path

import pytest

from boxmot_tpu.utils import checks as jchecks
from boxmot_tpu.utils import download as jdownload
from boxmot_tpu_torch.utils import checks as tchecks
from boxmot_tpu_torch.utils import download as tdownload

REPO = Path(__file__).resolve().parent.parent
PAIRS = {"checks": (tchecks, jchecks), "download": (tdownload, jdownload)}


def _below_docstring(path: Path) -> str:
    src = path.read_text()
    doc = ast.parse(src).body[0]
    return "".join(src.splitlines(keepends=True)[doc.end_lineno:])


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_module_is_a_copy_of_the_original(name):
    rel = f"utils/{name}.py"
    want = re.sub(r"\bboxmot_tpu\.", "boxmot_tpu_torch.", _below_docstring(REPO / "boxmot_tpu" / rel))
    assert _below_docstring(REPO / "boxmot_tpu_torch" / rel) == want
    assert (REPO / "boxmot_tpu_torch" / rel).read_text().startswith(
        f'"""A copy of ``boxmot_tpu/{rel}``.')


def _url(path: Path) -> str:
    return path.resolve().as_uri()


def _both(tmp_path, fn):
    """``fn(module, out_dir)`` for the port's module and the JAX one, each
    into its own directory; returns both results."""
    return [fn(module, tmp_path / label) for label, module in
            (("port", tdownload), ("jax", jdownload))]


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_download_file_equals_jax(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(bytes(range(256)) * 700)

    def fetch(module, out):
        seen = []
        dest = module.download_file(_url(src), out / "a" / "dst.bin",
                                    progress=lambda done, total: seen.append((done, total)))
        kept = module.download_file(_url(tmp_path / "nope"), dest)  # exists: kept, no fetch
        return dest.relative_to(out), kept == dest, seen, _tree(out)

    got, want = _both(tmp_path, fetch)
    assert got == want and got[2][-1][0] == 700 * 256 and got[3] != {}


def test_download_overwrite_and_failures_equal_jax(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"new")

    def run(module, out):
        out.mkdir()
        dest = out / "dst.bin"
        dest.write_bytes(b"old")
        module.download_file(_url(src), dest)
        kept = dest.read_bytes()
        module.download_file(_url(src), dest, overwrite=True)
        with pytest.raises(IOError, match="failed to download") as err:
            module.download_file(_url(tmp_path / "missing.bin"), out / "x.bin", retries=1,
                                 backoff_factor=0.0)
        return kept, dest.read_bytes(), str(err.value).split(":")[0], (out / "x.bin").exists()

    got, want = _both(tmp_path, run)
    assert got == want and got[:2] == (b"old", b"new") and not got[3]


def test_parallel_downloads_equal_jax(tmp_path):
    jobs = []
    for i in range(6):
        src = tmp_path / f"s{i}.bin"
        src.write_bytes(bytes([i]) * (10 + i))
        jobs.append(_url(src))

    def run(module, out):
        dests = module.download_files_parallel([(u, out / f"d{i}.bin") for i, u in enumerate(jobs)],
                                               max_workers=3)
        with pytest.raises(IOError):
            module.download_files_parallel([(jobs[0], out / "a.bin"),
                                            (_url(tmp_path / "missing"), out / "b.bin")],
                                           retries=0)
        return [d.relative_to(out) for d in dests], _tree(out)

    got, want = _both(tmp_path, run)
    assert got == want and len(got[0]) == 6


def test_archives_equal_jax(tmp_path):
    z = tmp_path / "a.zip"
    with zipfile.ZipFile(z, "w") as f:
        f.writestr("d/x.txt", "one")
        f.writestr("y.txt", "two")
    payload = tmp_path / "payload.txt"
    payload.write_text("data")
    t = tmp_path / "a.tar.gz"
    with tarfile.open(t, "w:gz") as f:
        f.add(payload, arcname="sub/payload.txt")
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as f:
        f.writestr("../evil.txt", "boom")

    def run(module, out):
        seen = []
        module.extract_zip(z, out / "zip", progress=lambda a, b: seen.append((a, b)))
        module.extract_tar(t, out / "tar", progress=lambda a, b: seen.append((a, b)))
        module.download_and_extract(_url(z), out / "fetched")
        plain = module.download_and_extract(_url(payload), out / "plain")
        with pytest.raises(ValueError, match="unsafe archive member"):
            module.extract_zip(evil, out / "unpack")
        module.rmtree(out / "unpack")
        return seen, plain.relative_to(out), _tree(out)

    got, want = _both(tmp_path, run)
    assert got == want and got[0][-1] == (1, 1)
    assert got[2]["tar/sub/payload.txt"] == b"data" and got[2]["fetched/d/x.txt"] == b"one"


def test_status_hook_equals_jax(tmp_path):
    msgs = {}
    for label, module in (("port", tdownload), ("jax", jdownload)):
        seen = msgs.setdefault(label, [])
        module.set_download_status_fn(seen.append)
        try:
            with pytest.raises(IOError):
                module.download_file(_url(tmp_path / "missing"), tmp_path / label / "x", retries=2,
                                     backoff_factor=0.0)
        finally:
            module.set_download_status_fn(None)
    assert msgs["port"] == msgs["jax"] and len(msgs["port"]) == 2


def test_checks_equal_jax():
    reqs = ["numpy", "numpy>=1.20", "pyyaml", "opencv-python", "surely-not-a-package-xyz",
            "scikit-learn", "", "==1"]
    for r in reqs:
        assert tchecks.requirement_satisfied(r) == jchecks.requirement_satisfied(r), r
    assert tchecks.missing_requirements(reqs) == jchecks.missing_requirements(reqs)
    assert tchecks.requirement_satisfied("numpy") and not tchecks.requirement_satisfied("==1")
    errors = []
    for module in (tchecks, jchecks):
        rc = module.RequirementsChecker()
        rc.check_packages(["numpy", "pyyaml"])
        with pytest.raises(ModuleNotFoundError, match="pip install") as err:
            rc.check_packages(["surely-not-a-package-xyz"], purpose="testing")
        with pytest.raises(ModuleNotFoundError, match=r"\[export\]") as extra:
            rc.sync_extra("export", ["surely-not-a-package-xyz"])
        errors.append((str(err.value), str(extra.value)))
    assert errors[0] == errors[1]
    assert "boxmot_tpu_torch.utils.checks" in sys.modules
