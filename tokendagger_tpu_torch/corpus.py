"""Resumable bulk-corpus tokenization.

The job runner around the engines: tokenize a set of input files into
token-id shards (.npy) with a persisted manifest, so an interrupted run
resumes where it stopped.

    proc = CorpusProcessor(tokenizer, "out/")
    manifest = proc.process(glob.glob("data/*.txt"))

Shards are one .npy per input file; the manifest records byte/token
counts and content fingerprints (size + mtime) so modified inputs are
re-tokenized on resume while finished ones are skipped. Files are encoded
from a thread pool; with the device backend the threads share one
``DeviceEngine``, whose lock lets one thread at a time run its device
section while the others read files, split specials and splice misses.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np

from .utils.profiling import RateMeter

_MANIFEST = "manifest.json"


class CorpusProcessor:
    def __init__(
        self,
        tokenizer,
        output_dir: str | Path,
        *,
        num_threads: int = 8,
        dtype=np.int32,
        allowed_special: set[str] | str = (),
    ):
        self._tok = tokenizer
        self._out = Path(output_dir)
        self._out.mkdir(parents=True, exist_ok=True)
        self._threads = num_threads
        self._dtype = dtype
        self._allowed = allowed_special
        self.meter = RateMeter()

    # ------------------------------------------------------------------
    def _manifest_path(self) -> Path:
        return self._out / _MANIFEST

    def _load_manifest(self) -> dict:
        p = self._manifest_path()
        if p.exists():
            try:
                return json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                pass
        return {"version": 1, "files": {}}

    def _save_manifest(self, manifest: dict) -> None:
        tmp = self._manifest_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(manifest, indent=1))
        os.replace(tmp, self._manifest_path())

    @staticmethod
    def _fingerprint(path: Path) -> dict:
        st = path.stat()
        return {"size": st.st_size, "mtime": int(st.st_mtime)}

    def _shard_path(self, src: Path) -> Path:
        # unique, collision-free shard name: readable stem + path digest
        digest = hashlib.sha1(str(src).encode()).hexdigest()[:10]
        return self._out / f"{src.stem}_{digest}.npy"

    # ------------------------------------------------------------------
    def _encode_file(self, src: Path) -> tuple[Path, int, int, float, dict]:
        t0 = time.perf_counter()
        # fingerprint BEFORE reading: a file modified mid-encode must look
        # stale on resume, not silently pass as done
        fp = self._fingerprint(src)
        text = src.read_text(encoding="utf-8", errors="replace")
        ids = self._tok.encode_batch_np(
            [text], num_threads=1, allowed_special=self._allowed,
            disallowed_special=(),
        )[0].astype(self._dtype)
        shard = self._shard_path(src)
        tmp = shard.with_suffix(f".tmp{os.getpid()}.npy")
        np.save(tmp, ids)
        os.replace(tmp, shard)
        return (shard, len(text.encode("utf-8")), len(ids),
                time.perf_counter() - t0, fp)

    def process(self, files: Sequence[str | Path], *,
                resume: bool = True) -> dict:
        """Tokenize ``files`` into shards; returns the manifest. Files whose
        fingerprints match a finished manifest entry are skipped when
        ``resume`` (the checkpoint/resume contract)."""
        manifest = (self._load_manifest() if resume
                    else {"version": 1, "files": {}})
        todo: list[Path] = []
        for f in files:
            src = Path(f).resolve()  # one canonical key per real file
            entry = manifest["files"].get(str(src))
            if (resume and entry and entry.get("status") == "done"
                    and entry.get("fingerprint") == self._fingerprint(src)
                    and self._shard_path(src).exists()):
                continue
            todo.append(src)

        with ThreadPoolExecutor(self._threads) as ex:
            for src, result in zip(todo, ex.map(self._encode_file, todo)):
                shard, nbytes, ntok, secs, fp = result
                self.meter.add(nbytes, ntok, secs)
                manifest["files"][str(src)] = {
                    "status": "done",
                    "shard": str(shard),
                    "bytes": nbytes,
                    "tokens": ntok,
                    "fingerprint": fp,
                }
                self._save_manifest(manifest)
        return manifest
