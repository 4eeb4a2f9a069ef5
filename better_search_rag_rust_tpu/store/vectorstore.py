"""Persistent vector store: one float32 ``.npy`` matrix per store.

Capability parity with the reference's ``PolarsVectorstore``
(reference: src/vectorstore/polars.rs:79-247) and shard naming helpers
(reference: src/mpi_helpers/vectorstore.rs:5-20):

* ``new(path, empty)`` — fresh empty store, or load from disk, creating
  parent dirs and an empty file when absent (polars.rs:50-77);
* ``append`` / ``append_many`` / ``get`` / ``get_many(slice)`` / ``persist`` /
  ``reload(force)`` / ``reset`` / ``count`` (polars.rs:79-247);
* per-shard files ``rank_{r}.npy`` merged into ``global.npy`` in shard
  order — the fixed order is what keeps local→global index translation valid
  (src/mpi_helpers/tasks.rs:181-217).

Where the reference writes Parquet, the store here is a NumPy ``.npy``
file holding one ``[N, D]`` float32 matrix: written through a temporary
file and ``os.replace`` (a reader or a crash-resume never sees a torn
file), read with ``np.load(mmap_mode="r")`` so a sharded load reads only
the rows it needs. Rows are held as contiguous ``float32`` chunks, and
``matrix()`` hands the search engine an ``[N, D]`` array ready for device
upload, where the reference pays a per-row ``Vec<f32>`` extraction
(polars.rs:121-169).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import host_log

#: reference: src/mpi_helpers/vectorstore.rs:16-20
GLOBAL_STORE_NAME = "global.npy"


def local_store_path(store_dir: str | os.PathLike, shard: int) -> Path:
    """Per-shard file ``rank_{r}.npy``
    (reference: src/mpi_helpers/vectorstore.rs:5-13)."""
    return Path(store_dir) / f"rank_{shard}.npy"


def global_store_path(store_dir: str | os.PathLike) -> Path:
    """Merged store path (reference: src/mpi_helpers/vectorstore.rs:16-20)."""
    return Path(store_dir) / GLOBAL_STORE_NAME


def _open_matrix(path: Path) -> np.ndarray:
    """Memory-mapped, read-only ``[N, D]`` float32 view of a store file
    (a zero-byte file is an empty store)."""
    if path.stat().st_size == 0:
        return np.zeros((0, 0), dtype=np.float32)
    mat = np.load(path, mmap_mode="r", allow_pickle=False)
    if mat.ndim != 2 or mat.dtype != np.float32:
        raise ValueError(
            f"{path} holds a {mat.dtype} array of shape {mat.shape}, "
            "not an [N, D] float32 matrix"
        )
    return mat


def _write_matrix(path: Path, mat: np.ndarray) -> None:
    """Atomic write: a reader (or a crash-resume) can never observe a torn
    store file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.save(f, np.ascontiguousarray(mat, dtype=np.float32))
    os.replace(tmp, path)


class VectorStore:
    """Append-only embedding store persisted as one ``.npy`` matrix
    (reference: src/vectorstore/polars.rs:7-247)."""

    def __init__(self, path: str | os.PathLike, empty: bool = True):
        """``empty=True`` starts fresh in memory; ``empty=False`` loads the
        file, creating directories and an empty file when it does not
        exist yet (reference: src/vectorstore/polars.rs:50-77)."""
        self.path = Path(path)
        self._chunks: List[np.ndarray] = []
        self._count = 0
        if not empty:
            self._read(create_if_missing=True)

    # -- internal -----------------------------------------------------------

    def _read(self, create_if_missing: bool) -> None:
        if not self.path.exists():
            if not create_if_missing:
                raise FileNotFoundError(self.path)
            _write_matrix(self.path, np.zeros((0, 0), dtype=np.float32))
            self._chunks, self._count = [], 0
            return
        mat = _open_matrix(self.path)
        self._chunks = [mat] if mat.shape[0] else []
        self._count = mat.shape[0]

    # -- mutation ------------------------------------------------------------

    def append(self, vector: Sequence[float]) -> None:
        """Append one embedding row (reference: polars.rs:79-99)."""
        arr = np.asarray(vector, dtype=np.float32).reshape(1, -1)
        self._chunks.append(arr)
        self._count += 1

    def append_many(self, vectors) -> None:
        """Append a batch of rows — ``[B, D]`` array or list of vectors
        (reference: polars.rs:101-119)."""
        if isinstance(vectors, np.ndarray):
            if vectors.ndim != 2:
                raise ValueError(f"expected [B, D], got shape {vectors.shape}")
            if vectors.shape[0] == 0:
                return
            self._chunks.append(np.ascontiguousarray(vectors, dtype=np.float32))
            self._count += vectors.shape[0]
            return
        vecs = [np.asarray(v, dtype=np.float32) for v in vectors]
        if not vecs:
            return
        dims = {v.shape for v in vecs}
        if len(dims) == 1:
            self._chunks.append(np.stack(vecs))
        else:
            self._chunks.extend(v.reshape(1, -1) for v in vecs)
        self._count += len(vecs)

    def reset(self) -> None:
        """Drop all in-memory rows (reference: polars.rs — ``reset``)."""
        self._chunks = []
        self._count = 0

    def truncate(self, n: int) -> None:
        """Keep only the first ``n`` rows (crash-resume reconciliation: drop
        rows persisted past the last committed progress marker)."""
        if n < 0:
            raise ValueError(f"truncate to negative length {n}")
        if n >= self._count:
            return
        mat = self.matrix()
        self._chunks = [np.ascontiguousarray(mat[:n])] if n else []
        self._count = n

    # -- access ---------------------------------------------------------------

    @property
    def count(self) -> int:
        """Row count (reference: polars.rs:243-246)."""
        return self._count

    def get_count(self) -> int:
        return self._count

    def matrix(self) -> np.ndarray:
        """All rows as one contiguous ``[N, D]`` float32 matrix. Consolidates
        chunks lazily. Empty store -> ``[0, 0]``."""
        if not self._chunks:
            return np.zeros((0, 0), dtype=np.float32)
        if len(self._chunks) > 1:
            dims = {c.shape[1] for c in self._chunks}
            if len(dims) != 1:
                raise ValueError(f"store holds mixed dims {sorted(dims)}")
            self._chunks = [np.concatenate(self._chunks, axis=0)]
        return self._chunks[0]

    def take_matrix(self) -> np.ndarray:
        """Detach and return all rows as ONE writable ``[N, D]`` matrix,
        leaving the store empty.

        The in-place mutation surface :meth:`..pipeline.Pipeline.update`
        needs: ``matrix()`` may hand back a read-only mmap view of the
        store file, and copying on top of it while the store still holds its
        chunks transiently doubles host RAM (~60 GB for a 10M x 768 f32
        store). Here at most one materialized copy exists at any moment —
        the store's reference is dropped before any copy is made, and a
        writable consolidated buffer is handed over without copying."""
        mat = self.matrix()
        self._chunks, self._count = [], 0
        if mat.size and not mat.flags.writeable:
            mat = np.array(mat)  # one copy; the mmap pages drop right after
        return mat

    def get(self, index: int) -> np.ndarray:
        """Random-access one row (reference: polars.rs:158-169)."""
        if not 0 <= index < self._count:
            raise IndexError(f"row {index} out of range for {self._count} rows")
        return self.matrix()[index].copy()

    def get_many(self, slice_args: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Contiguous slice ``(offset, length)`` or all rows when ``None``
        (reference: polars.rs:121-156)."""
        mat = self.matrix()
        if slice_args is None:
            return mat
        offset, length = slice_args
        if offset < 0 or length < 0 or offset + length > self._count:
            raise IndexError(
                f"slice ({offset}, {length}) out of range for {self._count} rows"
            )
        return mat[offset : offset + length]

    # -- persistence ----------------------------------------------------------

    def persist(self) -> None:
        """Write all rows to disk and verify the file exists
        (reference: polars.rs:183-241)."""
        _write_matrix(self.path, self.matrix())
        if not self.path.exists():  # reference: polars.rs:232-239
            raise IOError(f"persist failed: {self.path} missing after write")

    def reload(self, force: bool = False) -> None:
        """Re-read from disk. An empty/missing file raises unless ``force``
        (reference: polars.rs:171-181)."""
        exists = self.path.exists() and self.path.stat().st_size > 0
        if not exists and not force:
            raise IOError(f"reload: {self.path} is missing or empty")
        self._chunks, self._count = [], 0
        if self.path.exists():
            self._read(create_if_missing=force)


def local_store(
    store_dir: str | os.PathLike, shard: int, empty: bool = True
) -> VectorStore:
    """Open shard ``shard``'s store
    (reference: src/mpi_helpers/vectorstore.rs:5-13)."""
    return VectorStore(local_store_path(store_dir, shard), empty=empty)


def global_store(
    store_dir: str | os.PathLike, empty: bool = True
) -> VectorStore:
    """Open the merged store
    (reference: src/mpi_helpers/vectorstore.rs:16-20)."""
    return VectorStore(global_store_path(store_dir), empty=empty)


def manifest_path(store_dir: str | os.PathLike) -> Path:
    """Row->source-file manifest for the merged store (written at merge;
    JSON list, one path per global row)."""
    return Path(store_dir) / "manifest.json"


def load_manifest(store_dir: str | os.PathLike) -> Optional[List[str]]:
    """The merged row->path manifest, or None when ingest never wrote one."""
    import json

    p = manifest_path(store_dir)
    if not p.exists():
        return None
    return json.loads(p.read_text())


def attrs_path(store_dir: str | os.PathLike) -> Path:
    """Row->file-identity sidecar for the merged store: a JSON list parallel
    to ``manifest.json``, one ``[size, mtime_ns, fingerprint]`` triple (or
    null) per global row. This is what lets ``update()`` detect EDITED files
    (the reference's only refresh path is a full rebuild, src/main.rs:85-105;
    rows with null identity — e.g. from pre-attrs stores — are kept as-is)."""
    return Path(store_dir) / "manifest.attrs.json"


def load_attrs(store_dir: str | os.PathLike) -> Optional[List]:
    """The row->identity list, or None when never written / unreadable."""
    import json

    p = attrs_path(store_dir)
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except ValueError:
        return None


def store_row_count(path: str | os.PathLike) -> int:
    """Row count from the file header only — no data read. The reference
    has no metadata path at all: ``get_count`` requires the full frame in
    memory (src/vectorstore/polars.rs:243-246 after :50-77)."""
    path = Path(path)
    if not path.exists() or path.stat().st_size == 0:
        return 0
    return int(_open_matrix(path).shape[0])


def read_matrix_slice(
    path: str | os.PathLike, offset: int, length: int
) -> np.ndarray:
    """Read only rows ``[offset, offset+length)`` as an ``[length, D]`` f32
    matrix (a slice of the memory map: only those rows' pages are read).

    This is the multi-host store lifecycle primitive: a store built by N
    ingest hosts and merged once can be served by M hosts, each reading only
    its own block — where the reference makes **every rank parse the entire
    global.parquet** and then slice (src/mpi_helpers/metrics.rs:23-33 ->
    polars.rs:50-77).
    """
    if length <= 0:
        return np.zeros((0, 0), dtype=np.float32)
    mat = _open_matrix(Path(path))
    if offset < 0 or offset + length > mat.shape[0]:
        raise IndexError(
            f"slice ({offset}, {length}) out of range for {mat.shape[0]} rows"
        )
    return np.array(mat[offset: offset + length], dtype=np.float32)


def partial_merge_marker(store_dir: str | os.PathLike) -> Path:
    """Marker written next to global.npy when an allow-partial merge
    skipped shards — serving layers can refuse or warn on it."""
    return Path(store_dir) / "global.npy.partial"


def global_ahead_marker(store_dir: str | os.PathLike) -> Path:
    """Marker written by :meth:`..pipeline.Pipeline.update` when rows were
    appended directly to global.npy: the global store is now AHEAD of the
    per-shard ``rank_*.npy`` stores, and a merge (which rebuilds global
    from the shards) would silently discard the appended rows. ``merge``
    refuses while this marker exists unless forced."""
    return Path(store_dir) / "global.npy.ahead"


def update_commit_path(store_dir: str | os.PathLike) -> Path:
    """Commit marker for :meth:`..pipeline.Pipeline.update`'s multi-file
    rewrite (global.npy + manifest.json + manifest.attrs.json are three
    separate atomic renames; this marker, written LAST, is the commit point
    — the same discipline as ingest's ``.progress`` marker). It binds the
    store file's identity (size + mtime_ns) to fingerprints of the manifest
    and attrs payloads, so a crash between any two renames is detectable:
    loaders refuse the torn combination instead of silently serving
    row-shifted paths."""
    return Path(store_dir) / "update_commit.json"


def _file_sha(path: Path) -> Optional[str]:
    import hashlib

    if not path.exists():
        return None
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _store_sample_sha(path: Path, blocks: int = 32,
                      block_bytes: int = 16384) -> str:
    """Sampled content fingerprint of a (possibly multi-GB) store file:
    sha256 over the file size plus ``blocks`` evenly spaced reads pinned
    at offset 0 and EOF (<= 512 KB of IO total). Any row-count change
    moves the size (fixed-size rows); any compaction/append shifts
    every byte after the edit point, so some sampled block (the EOF block
    at minimum) changes — while a byte-identical copy (backup restore,
    image layer) matches exactly even though its mtime differs.

    Detection limit (by design): files up to ``blocks * block_bytes``
    (512 KB) are hashed WHOLE, so every content change there is caught.
    Beyond that, a same-SIZE edit confined to the gaps between sampled
    blocks passes undetected — same-size tamper detection is
    probabilistic for large stores. The commit marker's alignment
    guarantee is unaffected: anything that row-shifts the manifest
    mapping (append, truncate, compaction, re-merge) changes the file
    size or the EOF block and is always refused."""
    import hashlib

    h = hashlib.sha256()
    size = path.stat().st_size
    h.update(str(size).encode())
    with open(path, "rb") as f:
        if size <= blocks * block_bytes:
            h.update(f.read())
        else:
            step = (size - block_bytes) / (blocks - 1)
            for i in range(blocks):
                f.seek(int(i * step))
                h.update(f.read(block_bytes))
    return h.hexdigest()


def write_update_commit(store_dir: str | os.PathLike) -> None:
    """Record the committed (store, manifest, attrs) triple — call strictly
    after all three files are in place."""
    store_dir = Path(store_dir)
    gpath = global_store_path(store_dir)
    st = gpath.stat()
    payload = {
        "store_size": st.st_size,
        "store_mtime_ns": st.st_mtime_ns,
        "store_sample_sha": _store_sample_sha(gpath),
        "rows": store_row_count(gpath),
        "manifest_sha": _file_sha(manifest_path(store_dir)),
        "attrs_sha": _file_sha(attrs_path(store_dir)),
    }
    marker = update_commit_path(store_dir)
    tmp = marker.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, marker)


def validate_update_commit(store_dir: str | os.PathLike) -> Optional[str]:
    """Check the on-disk (store, manifest, attrs) triple against the last
    update-commit marker. Returns an error description for a torn state
    (crash mid-update), or None when consistent / never updated."""
    store_dir = Path(store_dir)
    marker = update_commit_path(store_dir)
    if not marker.exists():
        return None  # store never went through update(): nothing to check
    try:
        rec = json.loads(marker.read_text())
    except ValueError:
        return f"unreadable update-commit marker {marker}"
    gpath = global_store_path(store_dir)
    if not gpath.exists():
        return f"update marker exists but {gpath} is missing"
    st = gpath.stat()
    problems = []
    if (st.st_size, st.st_mtime_ns) != (rec.get("store_size"),
                                        rec.get("store_mtime_ns")):
        # Slow path: mtime moves on every benign copy/restore of the
        # store dir (cp -r, rsync, image layers) — refusing a consistent
        # triple for that would force a full re-ingest for nothing. The
        # sampled content fingerprint distinguishes "same bytes, new
        # mtime" (fine) from "different store than the marker committed"
        # (torn).
        sample = rec.get("store_sample_sha")
        if sample is None or _store_sample_sha(gpath) != sample:
            problems.append("global.npy differs from the last "
                            "committed update (content mismatch)")
    # A MISSING sidecar is deliberate stripping (legacy/foreign store), not
    # crash evidence — the atomic renames replace files, never delete them;
    # loaders already degrade gracefully without a manifest. Only an
    # existing-but-different file marks a torn rename sequence.
    for path, key in ((manifest_path(store_dir), "manifest_sha"),
                      (attrs_path(store_dir), "attrs_sha")):
        sha = _file_sha(path)
        if sha is not None and rec.get(key) is not None and sha != rec[key]:
            problems.append(f"{path.name} differs from the last committed "
                            "update")
    if not problems:
        return None
    return ("; ".join(problems)
            + " — an update() likely crashed between its atomic renames; "
              "run a full ingest to rebuild (row->path alignment cannot be "
              "trusted)")


def encoder_meta_path(store_dir: str | os.PathLike) -> Path:
    """Encoder-numerics record for the store: which backend / attention
    implementation / dtype produced the stored embeddings. Query-time
    encoders with different numerics produce slightly different query
    vectors (bf16-noise level, cos > 0.999) — not wrong, but drift that
    should be visible, not silent."""
    return Path(store_dir) / "encoder.json"


def write_encoder_meta(store_dir: str | os.PathLike, meta: dict) -> None:
    path = encoder_meta_path(store_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(meta, sort_keys=True))
    os.replace(tmp, path)


def load_encoder_meta(store_dir: str | os.PathLike) -> Optional[dict]:
    path = encoder_meta_path(store_dir)
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except ValueError:
        return None


def merge_vector_stores(
    num_shards: int,
    store_dir: str | os.PathLike,
    allow_partial: bool = False,
    force: bool = False,
) -> VectorStore:
    """Merge per-shard stores into the global store **in shard order** — the
    fixed order keeps local→global index translation valid
    (reference: src/mpi_helpers/tasks.rs:181-217).

    A MISSING or unreadable shard file means an ingest host crashed before
    persisting; merging past it would silently publish an incomplete global
    store (the reference does exactly that, tasks.rs:202-212 — a one-line log
    is the only trace). Here that is an error unless ``allow_partial=True``,
    in which case the skipped shards are recorded in a
    ``global.npy.partial`` marker beside the store. Present-but-empty
    shards are legitimate (a host can be assigned zero files) and merge as
    zero rows. Caller persists.

    When :func:`global_ahead_marker` exists (an incremental ``update()``
    appended rows straight to global.npy that live in NO shard), a merge
    would rebuild global from the stale shards and silently discard those
    rows — refused unless ``force=True`` (which also clears the marker)."""
    ahead = global_ahead_marker(store_dir)
    if ahead.exists() and not force:
        raise RuntimeError(
            f"merge: global store at {store_dir} is AHEAD of its shards "
            f"({ahead.read_text()}); merging would discard the appended "
            "rows. Re-run a full ingest of every shard and merge with "
            "force=True (--force-merge), or delete the marker if you "
            "accept losing the appended rows."
        )
    merged = global_store(store_dir, empty=True)
    skipped: list = []
    for shard in range(num_shards):
        path = local_store_path(store_dir, shard)
        if not path.exists():
            # Distinct from "present but empty": a crashed ingest host must
            # stay visible as missing, not become settled-as-empty on disk.
            if not allow_partial:
                raise FileNotFoundError(
                    f"merge: shard {shard} missing ({path}); re-run its "
                    "ingest or pass allow_partial=True to publish an "
                    "explicitly partial store"
                )
            host_log(f"merge: shard {shard} MISSING ({path}), skipping")
            skipped.append(shard)
            continue
        try:
            shard_store = VectorStore(path, empty=False)
        except Exception as exc:
            if not allow_partial:
                raise RuntimeError(
                    f"merge: shard {shard} unreadable ({path}): {exc}"
                ) from exc
            host_log(f"merge: skipping unreadable shard {shard} ({path}): {exc}")
            skipped.append(shard)
            continue
        if shard_store.count == 0:
            host_log(f"merge: shard {shard} is empty, skipping")
            continue
        merged.append_many(shard_store.get_many(None))
    marker = partial_merge_marker(store_dir)
    if skipped:
        marker.parent.mkdir(parents=True, exist_ok=True)
        marker.write_text(json.dumps({"skipped_shards": skipped}))
    elif marker.exists():
        marker.unlink()
    if ahead.exists():  # force=True: the caller accepted the rebuild
        ahead.unlink()
    return merged
