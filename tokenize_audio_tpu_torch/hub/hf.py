"""HuggingFace Hub artifact store with the reference's resilience contracts:

  - exponential backoff with jitter on 409 commit conflicts and transient
    errors (common-voice-mimi/process_common_voice.py:40-79);
  - N files in ONE commit via CommitOperationAdd/create_commit to dodge
    rate limits (yodas2-mimi/process_shard.py:126-182);
  - exists via HfApi.file_exists with per-path positive AND negative
    result caching (yodas2-mimi/monitor_progress.py:89-114 caches both;
    uploads through this store invalidate the negative entry, and
    ``clear_exists_cache`` handles external writers);
  - direct resolve-URL download fallback when the hub API path fails
    (pretraining-data/prepare_pretraining_data.py:109-163);
  - HTTP-range ``read_range``/``size`` so parquet footers can be read
    without downloading data (count_dataset_rows.py:66-88).

Network use is inherently environment-gated; everything here lazy-imports
huggingface_hub so air-gapped deployments never touch it.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import List, Sequence, Tuple

from tokenize_audio_tpu_torch.hub.base import ArtifactStore
from tokenize_audio_tpu_torch.net import retry_with_backoff, stream_to_file

logger = logging.getLogger(__name__)


class HFHub(ArtifactStore):
    def __init__(
        self,
        repo_id: str,
        repo_type: str = "dataset",
        token: str | None = None,
        max_retries: int = 5,
        base_delay: float = 2.0,
    ):
        from huggingface_hub import HfApi

        self.repo_id = repo_id
        self.repo_type = repo_type
        self.api = HfApi(token=token)
        self.max_retries = max_retries
        self.base_delay = base_delay
        self._exists_cache: dict[str, bool] = {}
        self._http_session = None

    def _retry(self, fn, what: str, fatal=()):
        return retry_with_backoff(
            fn,
            what,
            max_retries=self.max_retries,
            base_delay=self.base_delay,
            log=logger,
            fatal=fatal,
        )

    @staticmethod
    def _not_found_errors():
        """Permanent hub errors that must not be retried or masked."""
        try:
            from huggingface_hub.utils import (
                EntryNotFoundError,
                GatedRepoError,
                RepositoryNotFoundError,
                RevisionNotFoundError,
            )
        except ImportError:  # stubbed hub module (tests) — no short-circuit
            return ()
        return (
            EntryNotFoundError,
            GatedRepoError,
            RepositoryNotFoundError,
            RevisionNotFoundError,
        )

    def exists(self, path: str) -> bool:
        if path in self._exists_cache:
            return self._exists_cache[path]
        result = bool(
            self._retry(
                lambda: self.api.file_exists(
                    self.repo_id, path, repo_type=self.repo_type
                ),
                f"file_exists({path})",
                # a misnamed/gated repo is permanent — surface immediately
                # instead of burning the backoff budget on every ledger check
                fatal=self._not_found_errors(),
            )
        )
        self._exists_cache[path] = result
        return result

    def clear_exists_cache(self) -> None:
        """Drop cached exists results (needed when another process may have
        uploaded since; uploads through THIS store update the cache)."""
        self._exists_cache.clear()

    def upload_file(self, local_path: str, repo_path: str) -> None:
        self._retry(
            lambda: self.api.upload_file(
                path_or_fileobj=local_path,
                path_in_repo=repo_path,
                repo_id=self.repo_id,
                repo_type=self.repo_type,
            ),
            f"upload_file({repo_path})",
        )
        # invalidate rather than seed True: post-upload verification
        # (upload_and_delete, emilia) relies on exists() actually asking
        # the hub — a cached True would make verification a tautology that
        # can never catch a dropped upload
        self._exists_cache.pop(repo_path, None)

    def upload_batch(self, items: Sequence[Tuple[str, str]]) -> None:
        from huggingface_hub import CommitOperationAdd

        ops = [
            CommitOperationAdd(path_in_repo=rp, path_or_fileobj=lp)
            for lp, rp in items
        ]

        def commit():
            self.api.create_commit(
                repo_id=self.repo_id,
                repo_type=self.repo_type,
                operations=ops,
                commit_message=f"Batch upload of {len(ops)} files",
            )

        self._retry(commit, f"create_commit({len(ops)} files)")
        for _, rp in items:
            self._exists_cache.pop(rp, None)  # see upload_file

    def list_files(self, prefix: str = "") -> List[str]:
        files = self._retry(
            lambda: self.api.list_repo_files(self.repo_id, repo_type=self.repo_type),
            "list_repo_files",
            fatal=self._not_found_errors(),  # see exists()
        )
        return sorted(f for f in files if f.startswith(prefix))

    def download(self, repo_path: str, local_path: str) -> str:
        from huggingface_hub import hf_hub_download

        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        # download via local_dir so the artifact lands ONCE at the
        # destination: the default cache path would keep a second copy of
        # every multi-GB shard in ~/.cache/huggingface until the disk fills
        # (callers unlink only their working copy). Temp dir on the same
        # filesystem makes the final placement an atomic rename.
        tmp_dir = f"{os.path.abspath(local_path)}.hfdl.{os.getpid()}"
        try:
            got = self._retry(
                lambda: hf_hub_download(
                    repo_id=self.repo_id,
                    filename=repo_path,
                    repo_type=self.repo_type,
                    local_dir=tmp_dir,
                ),
                f"download({repo_path})",
                # permanent errors propagate untouched: a missing file must
                # not burn another minute of resolve-URL retries or mask the
                # informative EntryNotFoundError
                fatal=self._not_found_errors(),
            )
            if os.path.islink(got):
                # huggingface_hub < 0.23 could materialize local_dir entries
                # as symlinks into the shared cache; moving the bare link
                # would hand the caller a path whose bytes live in the cache
                # (and dangle once the cache is pruned). Copy the real bytes
                # out atomically (tmp + rename, same filesystem). The cache
                # blob itself is left alone: it is SHARED state — the
                # snapshot tree (and any dedup'd files) symlink the same
                # blob, so deleting it would corrupt the cache for other
                # consumers. The transient duplicate costs disk until the
                # user prunes the cache; on the installed hub (>=0.23,
                # local_dir=real files) this branch never runs.
                tmp = f"{local_path}.cp.{os.getpid()}"
                shutil.copyfile(os.path.realpath(got), tmp)
                os.replace(tmp, local_path)
                os.unlink(got)
            else:
                os.replace(got, local_path)
            return local_path
        except self._not_found_errors():
            raise
        except Exception:  # noqa: BLE001 — API path exhausted; try the raw URL
            logger.warning(
                "hub API download failed for %s; falling back to resolve URL",
                repo_path,
            )
            return self._download_direct(repo_path, local_path)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)

    # -- raw resolve-URL path ---------------------------------------------

    def _resolve_url(self, repo_path: str) -> str:
        from huggingface_hub import hf_hub_url

        return hf_hub_url(self.repo_id, repo_path, repo_type=self.repo_type)

    def _session(self):
        # one long-lived session: metadata-only scans issue 3+ ranged calls
        # per file, and per-call TLS handshakes would dominate the few-KB
        # transfers the ranged reads exist to achieve
        if self._http_session is None:
            import requests

            from huggingface_hub.utils import build_hf_headers

            s = requests.Session()
            s.headers.update(build_hf_headers(token=self.api.token))
            self._http_session = s
        return self._http_session

    def _download_direct(self, repo_path: str, local_path: str) -> str:
        """Stream from the resolve URL — the reference's fallback when the
        HF API errors (prepare_pretraining_data.py:109-163)."""
        url = self._resolve_url(repo_path)
        self._retry(
            lambda: stream_to_file(
                lambda: self._session().get(url, stream=True, timeout=60), local_path
            ),
            f"direct download({repo_path})",
        )
        return local_path

    def size(self, repo_path: str) -> int:
        def head():
            r = self._session().head(
                self._resolve_url(repo_path), allow_redirects=True, timeout=30
            )
            r.raise_for_status()
            # hub returns the blob size in X-Linked-Size on the entry
            # point; after redirect Content-Length is authoritative
            return int(r.headers.get("Content-Length") or r.headers["X-Linked-Size"])

        return self._retry(head, f"size({repo_path})")

    def read_range(self, repo_path: str, offset: int, length: int) -> bytes:
        """HTTP range request — parquet footer reads transfer KBs, not GBs
        (count_dataset_rows.py:66-88)."""

        def fetch():
            r = self._session().get(
                self._resolve_url(repo_path),
                headers={"Range": f"bytes={offset}-{offset + length - 1}"},
                timeout=60,
            )
            r.raise_for_status()
            if r.status_code == 206:
                return r.content
            # server/proxy ignored the Range header and sent the whole
            # body (200): salvage the requested window rather than handing
            # callers a multi-GB buffer mislabeled as a footer slice
            logger.warning(
                "range request for %s ignored (status %d); slicing full body",
                repo_path,
                r.status_code,
            )
            return r.content[offset : offset + length]

        return self._retry(fetch, f"read_range({repo_path})")
