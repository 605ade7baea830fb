"""Artifact store abstraction.

The reference talks to the HuggingFace Hub directly from every processor
(HuggingFaceUploader, yodas2-mimi/process_shard.py:61-182; HuggingFaceManager,
pretraining-data/prepare_pretraining_data.py:89-237; upload_with_retry,
common-voice-mimi/process_common_voice.py:40-79). Here the contract is one
interface with two implementations: the real HF hub and a local-directory
fake used by tests and air-gapped runs. The hub doubles as the durable
completion ledger — `exists` is the idempotence check every shard runner
performs on startup (SURVEY §5 checkpoint/resume grain 4).
"""

from __future__ import annotations

import abc
import os
import tempfile
from typing import List, Sequence, Tuple


class ArtifactStore(abc.ABC):
    """exists / upload / batch-upload / list / download over a repo of files."""

    @abc.abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abc.abstractmethod
    def upload_file(self, local_path: str, repo_path: str) -> None:
        ...

    @abc.abstractmethod
    def upload_batch(self, items: Sequence[Tuple[str, str]]) -> None:
        """Upload many (local_path, repo_path) pairs in ONE commit — the
        rate-limit-dodging batch commit of the reference
        (yodas2-mimi/process_shard.py:126-182)."""

    @abc.abstractmethod
    def list_files(self, prefix: str = "") -> List[str]:
        ...

    @abc.abstractmethod
    def download(self, repo_path: str, local_path: str) -> str:
        ...

    # -- ranged access (metadata-only parquet reads) ----------------------
    #
    # The reference counts dataset rows by fetching ONLY the parquet footer
    # via HTTP range requests (pretraining-data/count_dataset_rows.py:66-88)
    # — at production sizes a full download is 2-3 GB per file. Stores
    # should override these with true ranged reads; the defaults fall back
    # to a full download so the contract always holds.

    def size(self, repo_path: str) -> int:
        """Total bytes of a stored file."""
        return len(self._full_read(repo_path))

    def read_range(self, repo_path: str, offset: int, length: int) -> bytes:
        """``length`` bytes starting at ``offset`` (short read only at EOF)."""
        return self._full_read(repo_path)[offset : offset + length]

    def _full_read(self, repo_path: str) -> bytes:
        with tempfile.TemporaryDirectory() as td:
            local = os.path.join(td, "blob")
            self.download(repo_path, local)
            with open(local, "rb") as f:
                return f.read()

    def upload_and_delete(self, local_path: str, repo_path: str) -> None:
        self.upload_file(local_path, repo_path)
        if not self.exists(repo_path):  # post-upload verification
            raise RuntimeError(f"upload verification failed for {repo_path}")
        os.unlink(local_path)
