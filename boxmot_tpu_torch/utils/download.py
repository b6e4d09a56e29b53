"""A copy of ``boxmot_tpu/utils/download.py``.

Download and archive utilities.

Mirror of the reference download layer (boxmot/utils/download.py:56-433):
a retrying HTTP session, resumable single-file downloads with progress
callbacks, a bounded-thread parallel fan-out, and safe zip/tar
extraction.  Network access is environment-gated — every function is
usable offline against ``file://`` URLs and local archives, and raises
a clear error instead of hanging when egress is unavailable.
"""

from __future__ import annotations

import shutil
import tarfile
import time
import urllib.error
import urllib.parse
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Callable, Iterable, Sequence

from boxmot_tpu_torch.utils.logging import LOGGER as logger

_CHUNK = 1 << 16

# module-level progress hook, settable by the workflow UI
# (reference set_download_status_fn, download.py:41-53)
_status_fn: Callable[[str], None] | None = None


def set_download_status_fn(fn: Callable[[str], None] | None) -> None:
    global _status_fn
    _status_fn = fn


def _status(msg: str) -> None:
    if _status_fn is not None:
        _status_fn(msg)
    else:
        logger.info(msg)


def download_file(
    url: str,
    dest: Path | str,
    overwrite: bool = False,
    retries: int = 3,
    backoff_factor: float = 0.3,
    timeout: float = 30.0,
    progress: Callable[[int, int], None] | None = None,
) -> Path:
    """Fetch ``url`` into ``dest`` with retry + exponential backoff.

    Mirrors the reference's retrying session semantics
    (get_http_session + download_file, download.py:56-200) on urllib —
    no third-party HTTP stack.  ``progress(done_bytes, total_bytes)`` is
    called per chunk (total is -1 when unknown).  Existing files are
    kept unless ``overwrite``.
    """
    dest = Path(dest)
    if dest.exists() and not overwrite:
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    last_err: Exception | None = None
    for attempt in range(retries + 1):
        try:
            req = urllib.request.Request(url, headers={"User-Agent": "boxmot-tpu"})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                total = int(r.headers.get("Content-Length", -1))
                done = 0
                with open(tmp, "wb") as f:
                    while True:
                        chunk = r.read(_CHUNK)
                        if not chunk:
                            break
                        f.write(chunk)
                        done += len(chunk)
                        if progress is not None:
                            progress(done, total)
            tmp.replace(dest)
            return dest
        except (urllib.error.URLError, OSError, ValueError) as e:
            last_err = e
            tmp.unlink(missing_ok=True)
            if attempt < retries:
                delay = backoff_factor * (2**attempt)
                _status(f"retrying {url} in {delay:.1f}s ({e})")
                time.sleep(delay)
    raise IOError(
        f"failed to download {url} after {retries + 1} attempts "
        f"(offline environment?): {last_err}"
    )


def download_files_parallel(
    jobs: Sequence[tuple[str, Path | str]],
    max_workers: int = 4,
    overwrite: bool = False,
    retries: int = 3,
) -> list[Path]:
    """Bounded-thread download fan-out (download.py:201-255).

    ``jobs`` is a sequence of (url, dest).  Returns dests in job order;
    the first failure is re-raised after all workers finish.
    """
    results: dict[int, Path] = {}
    errors: list[Exception] = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futs = {
            pool.submit(download_file, url, dest, overwrite, retries): i
            for i, (url, dest) in enumerate(jobs)
        }
        for fut in as_completed(futs):
            i = futs[fut]
            try:
                results[i] = fut.result()
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
    if errors:
        raise errors[0]
    return [results[i] for i in range(len(jobs))]


def _check_member(name: str, dest: Path) -> None:
    """Reject path-traversal members (safe extraction)."""
    target = (dest / name).resolve()
    if not str(target).startswith(str(dest.resolve())):
        raise ValueError(f"unsafe archive member path: {name!r}")


def extract_zip(
    archive: Path | str,
    dest: Path | str,
    progress: Callable[[int, int], None] | None = None,
) -> Path:
    """Extract a zip with traversal protection + progress
    (download.py:256-311)."""
    archive, dest = Path(archive), Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(archive) as z:
        names = z.namelist()
        for i, name in enumerate(names):
            _check_member(name, dest)
            z.extract(name, dest)
            if progress is not None:
                progress(i + 1, len(names))
    return dest


def extract_tar(
    archive: Path | str,
    dest: Path | str,
    progress: Callable[[int, int], None] | None = None,
) -> Path:
    """Extract a tar(.gz/.xz) with traversal protection
    (download.py:312-381)."""
    archive, dest = Path(archive), Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    with tarfile.open(archive) as t:
        members = t.getmembers()
        for i, m in enumerate(members):
            _check_member(m.name, dest)
            t.extract(m, dest)
            if progress is not None:
                progress(i + 1, len(members))
    return dest


def download_and_extract(
    url: str, dest_dir: Path | str, overwrite: bool = False
) -> Path:
    """Download an archive and unpack it next to ``dest_dir``."""
    dest_dir = Path(dest_dir)
    fname = Path(urllib.parse.urlparse(url).path).name or "archive"
    archive = dest_dir / fname
    download_file(url, archive, overwrite=overwrite)
    if zipfile.is_zipfile(archive):
        return extract_zip(archive, dest_dir)
    if tarfile.is_tarfile(archive):
        return extract_tar(archive, dest_dir)
    return archive


def download_hf_dataset_subfolder(
    repo_id: str,
    subfolder: str,
    dest: Path | str,
    revision: str = "main",
    overwrite: bool = False,
) -> Path:
    """Pull one subfolder of a HuggingFace dataset repo over the plain
    resolve endpoint (reference download_hf_dataset_subfolder,
    download.py:562-733 — the parquet bootstrap's fetch path).

    Offline environments should pre-stage the snapshot instead; see
    boxmot_tpu/data/mot17_parquet.py for the local-snapshot path.
    """
    dest = Path(dest)
    api = (
        f"https://huggingface.co/api/datasets/{repo_id}/tree/{revision}/{subfolder}"
    )
    import json

    req = urllib.request.Request(api, headers={"User-Agent": "boxmot-tpu"})
    with urllib.request.urlopen(req, timeout=30.0) as r:
        listing = json.load(r)
    jobs = []
    for entry in listing:
        if entry.get("type") != "file":
            continue
        path = entry["path"]
        url = f"https://huggingface.co/datasets/{repo_id}/resolve/{revision}/{path}"
        jobs.append((url, dest / Path(path).relative_to(subfolder)))
    download_files_parallel(jobs, overwrite=overwrite)
    return dest


def rmtree(path: Path | str) -> None:
    shutil.rmtree(path, ignore_errors=True)
