"""Dataset downloader: resumable HTTP(S) fetch + checksum + archive
extraction (reference `install_dataset.py` downloads from zenodo/gdrive,
SURVEY.md C16/§3.4).

Offline-friendly: every function takes explicit URLs (file:// works, so
the whole path is testable without network); the per-dataset URL table
lives in cli/install_dataset.py. Downloads resume via HTTP Range when
the server supports it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import urllib.error
import urllib.request
import zipfile
from typing import Optional


class DownloadError(RuntimeError):
    pass


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download(url: str, dest: str, sha256: Optional[str] = None,
             resume: bool = True, chunk: int = 1 << 20,
             progress: bool = True) -> str:
    """Fetch `url` to `dest` (atomic: .part then rename). Resumes partial
    downloads with a Range request when possible. Verifies sha256 when
    given. → dest path."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    if os.path.exists(dest):
        if sha256 is None or sha256_file(dest) == sha256:
            return dest
        os.remove(dest)  # checksum mismatch: refetch
    part = dest + ".part"
    start = os.path.getsize(part) if (resume and os.path.exists(part)) else 0

    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
    try:
        resp = urllib.request.urlopen(req)
    except urllib.error.HTTPError as e:
        if start and e.code == 416:
            # A fully-downloaded .part left behind (death between write
            # and rename) makes Range: bytes=<size>- unsatisfiable. Treat
            # the .part as complete only if something validates it: the
            # checksum when given, else the server's Content-Length — a
            # stale .part that merely happens to be >= the (changed)
            # remote file must not be promoted silently.
            if sha256 is not None:
                if sha256_file(part) != sha256:
                    os.remove(part)  # truly bad partial: full refetch
                    return download(url, dest, sha256, resume=False,
                                    chunk=chunk, progress=progress)
            else:
                try:
                    head = urllib.request.Request(url, method="HEAD")
                    with urllib.request.urlopen(head) as hr:
                        want = int(hr.headers.get("Content-Length", -1))
                except (urllib.error.URLError, ValueError):
                    want = -1
                if want >= 0 and os.path.getsize(part) != want:
                    os.remove(part)  # stale partial from an older remote
                    return download(url, dest, sha256, resume=False,
                                    chunk=chunk, progress=progress)
            os.replace(part, dest)
            return dest
        raise DownloadError(f"cannot fetch {url}: {e}") from e
    except (urllib.error.URLError, ValueError) as e:
        raise DownloadError(f"cannot fetch {url}: {e}") from e
    # server ignored Range (or file://): start over
    code = getattr(resp, "status", 200)
    mode = "ab" if (start and code == 206) else "wb"
    done = 0 if mode == "wb" else start
    with resp, open(part, mode) as f:
        while True:
            b = resp.read(chunk)
            if not b:
                break
            f.write(b)
            done += len(b)
            if progress and done % (64 << 20) < chunk:
                print(f"  ... {done >> 20} MiB", flush=True)
    if sha256 is not None:
        got = sha256_file(part)
        if got != sha256:
            raise DownloadError(
                f"checksum mismatch for {url}: want {sha256}, got {got}")
    os.replace(part, dest)
    return dest


def extract(archive: str, dest_dir: str) -> str:
    """Extract .zip / .tar(.gz|.bz2|.xz) under dest_dir (path-traversal
    guarded). → dest_dir."""
    os.makedirs(dest_dir, exist_ok=True)
    root = os.path.realpath(dest_dir)

    def _safe(name: str) -> None:
        target = os.path.realpath(os.path.join(root, name))
        if not target.startswith(root + os.sep) and target != root:
            raise DownloadError(f"unsafe path in archive: {name}")

    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as z:
            for n in z.namelist():
                _safe(n)
            z.extractall(root)
    elif tarfile.is_tarfile(archive):
        with tarfile.open(archive) as t:
            for m in t.getmembers():
                _safe(m.name)
            t.extractall(root, filter="data")  # strips device/abs members
    else:
        raise DownloadError(f"not a zip/tar archive: {archive}")
    return dest_dir


def fetch_and_extract(url: str, work_dir: str,
                      sha256: Optional[str] = None) -> str:
    """download + extract into work_dir; returns the extraction dir."""
    fname = os.path.basename(url.split("?")[0]) or "download.bin"
    archive = download(url, os.path.join(work_dir, fname), sha256=sha256)
    out = os.path.join(work_dir, "extracted")
    if os.path.isdir(out):
        shutil.rmtree(out)
    return extract(archive, out)
