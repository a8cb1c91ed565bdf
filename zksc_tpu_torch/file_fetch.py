"""Artifact fetch layer: remote (pinned-version URL with retry/backoff) and
local file loading.

Mirrors the reference's FileFetch abstraction (js/src/file-fetch.ts:25-87:
makeRemoteFileFetch hits GitHub raw at a pinned commit with 3 linearly
backed-off retries; makeLocalFileFetch reads {base}/{engine}/{filename});
artifact layout and commit pinning per js/src/config.ts:6. Re-designed for
Python: fetchers are callables `fetch(engine, filename) -> bytes`, and
`fetch_pinned` adds SHA-256 content pinning on top of any fetcher (the
integrity chain of SURVEY.md §5 — hash-pin check before artifacts are
trusted, as gnark/libraries/prover/impl/library.go:81-133 does for pk/r1cs).
The JAX package's ``file_fetch.py``, host only.
"""
from __future__ import annotations

import hashlib
import os
import time
import urllib.error
import urllib.request

from .utils.logging import Logger, default_logger

# artifact version pin, the analogue of GIT_COMMIT_HASH in js/src/config.ts:6
DEFAULT_ARTIFACT_VERSION = "v1"
DEFAULT_BASE_URL = os.environ.get(
    "ZKSC_ARTIFACT_BASE_URL",
    f"https://example.invalid/zksc-artifacts/{DEFAULT_ARTIFACT_VERSION}")

MAX_RETRIES = 3
RETRY_BACKOFF_S = 1.0          # linear: 1s, 2s, 3s (file-fetch.ts:46)


class FetchError(IOError):
    pass


def make_local_file_fetch(base_dir: str):
    """fetch(engine, filename) reading {base_dir}/{engine}/{filename}."""

    def fetch(engine: str, filename: str, logger: Logger | None = None) -> bytes:
        path = os.path.join(base_dir, engine, filename)
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as e:
            raise FetchError(f"local artifact missing: {path}") from e

    return fetch


def make_remote_file_fetch(base_url: str = DEFAULT_BASE_URL,
                           retries: int = MAX_RETRIES,
                           backoff_s: float = RETRY_BACKOFF_S,
                           timeout_s: float = 30.0,
                           _urlopen=None):
    """fetch(engine, filename) from {base_url}/{engine}/{filename} with
    linear-backoff retries. `_urlopen` is injectable for tests (and for
    zero-egress environments)."""
    opener = _urlopen or urllib.request.urlopen

    def fetch(engine: str, filename: str, logger: Logger | None = None) -> bytes:
        logger = logger or default_logger()
        url = f"{base_url.rstrip('/')}/{engine}/{filename}"
        last_err = None
        for attempt in range(1, retries + 1):
            try:
                with opener(url, timeout=timeout_s) as resp:
                    status = getattr(resp, "status", 200)
                    if status != 200:
                        raise FetchError(f"HTTP {status} for {url}")
                    data = resp.read()
                logger.debug("fetched", url=url, bytes=len(data),
                             attempt=attempt)
                return data
            except (urllib.error.URLError, OSError, FetchError) as e:
                last_err = e
                logger.warn("fetch retry", url=url, attempt=attempt,
                            error=str(e))
                if attempt < retries:
                    time.sleep(backoff_s * attempt)
        raise FetchError(f"failed to fetch {url} after {retries} attempts: "
                         f"{last_err}")

    return fetch


def fetch_pinned(fetcher, engine: str, filename: str, sha256_hex: str,
                 logger: Logger | None = None) -> bytes:
    """Fetch + SHA-256 content pin (constant-time compare, mirroring the
    reference's subtle.ConstantTimeCompare on pk/r1cs hashes)."""
    import hmac
    data = fetcher(engine, filename, logger=logger)
    digest = hashlib.sha256(data).hexdigest()
    if not hmac.compare_digest(digest, sha256_hex.lower()):
        raise FetchError(
            f"integrity pin mismatch for {engine}/{filename}: "
            f"expected {sha256_hex}, got {digest}")
    return data


def mirror_artifacts(fetcher, manifest: dict, dest_dir: str,
                     logger: Logger | None = None) -> list:
    """Download a pinned artifact set locally (the analogue of
    js/src/scripts/download-files.ts). manifest: {engine: {filename:
    sha256_hex}}. Returns the list of written paths."""
    logger = logger or default_logger()
    written = []
    for engine, files in manifest.items():
        os.makedirs(os.path.join(dest_dir, engine), exist_ok=True)
        for filename, pin in files.items():
            data = fetch_pinned(fetcher, engine, filename, pin, logger=logger)
            path = os.path.join(dest_dir, engine, filename)
            with open(path, "wb") as f:
                f.write(data)
            written.append(path)
            logger.info("mirrored", path=path, bytes=len(data))
    return written
