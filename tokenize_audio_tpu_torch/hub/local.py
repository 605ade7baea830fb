"""Directory-backed artifact store: the test fake and air-gapped backend.

Implements the full ArtifactStore contract against a local directory with
the same atomicity property the reference relies on from the HF hub (a file
either exists completely or not at all): writes go to a PID-suffixed temp
name then os.replace (the reference's tmp+rename pattern,
pretraining-data/prepare_pretraining_data.py:616-635).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Sequence, Tuple

from tokenize_audio_tpu_torch.hub.base import ArtifactStore


class LocalHub(ArtifactStore):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _abs(self, repo_path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, repo_path))
        # root + sep: a bare prefix check would admit sibling dirs like
        # /data/hub2 when root is /data/hub
        if p != self.root and not p.startswith(self.root + os.sep):
            raise ValueError(f"path escapes hub root: {repo_path}")
        return p

    def exists(self, path: str) -> bool:
        return os.path.isfile(self._abs(path))

    def upload_file(self, local_path: str, repo_path: str) -> None:
        dst = self._abs(repo_path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = f"{dst}.tmp.{os.getpid()}"
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, dst)  # atomic within a filesystem

    def upload_batch(self, items: Sequence[Tuple[str, str]]) -> None:
        for local_path, repo_path in items:
            self.upload_file(local_path, repo_path)

    def list_files(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix) and ".tmp." not in rel:
                    out.append(rel)
        return sorted(out)

    def download(self, repo_path: str, local_path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        shutil.copyfile(self._abs(repo_path), local_path)
        return local_path

    def size(self, repo_path: str) -> int:
        return os.path.getsize(self._abs(repo_path))

    def read_range(self, repo_path: str, offset: int, length: int) -> bytes:
        with open(self._abs(repo_path), "rb") as f:
            f.seek(offset)
            return f.read(length)
